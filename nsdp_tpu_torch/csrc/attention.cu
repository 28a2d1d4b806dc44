// Fused kNN vector attention, forward, on Hopper (sm_90a).
//
// Replaces the TPU kernel nsdp_tpu/ops/attention_pallas.py::_attn_kernel
// (driven by fused_vector_attention).  For every query it computes, before
// the residual and the BatchNorm:
//   1. d2 = penalty + sum_c (x_q,c - x_kv,c)^2 to every kv point, exact f32;
//   2. the k smallest, ascending, ties to the lowest index;
//   3. per slot: pos = fc_delta(x_q - x_kv[n]) (2-layer ReLU MLP) and
//        pos-only:  logits = fc_gamma(pos),            value = pos
//        featured:  logits = fc_gamma(q - K[n] + pos), value = V[n] + pos
//      plus, optionally, a global slot with zero position encoding:
//                   logits = fc_gamma(q - k_glob),     value = v_glob;
//   4. a per-channel softmax over the slots and out = sum softmax * value.
// The plain PyTorch version is ops/attention.py::fused_vector_attention_plain.
// The distance sum is written with __fmul_rn/__fadd_rn in that version's
// order, so no FMA contraction moves a near-tie and both select the same
// neighbours; the position delta is a direct f32 subtraction of the gathered
// coordinates (exactly zero for a query that selects itself).
//
// What bounds it on an H100: operations.  At the decoder site (D=200,
// k=7 + 1 global slot) the three D x D products per slot are ~1.9 MFLOP per
// query against ~1.6 KB of compulsory traffic, far right of the f32 ridge
// point.  Two kernels, launched back to back on one stream:
//   * knn_kernel (steps 1-2) writes the (B, Nq, k) int32 neighbour indices,
//     the only intermediate that reaches device memory.  One warp per query,
//     eight queries per block sharing each chunk of kv points staged in
//     shared memory; each lane keeps a sorted list of its best candidates in
//     registers (branch-free insertion) over a strided scan, and the lists
//     merge with k rounds of warp arg-min.  Apart from the attention kernel,
//     its candidate lists do not crowd the registers of the products.
//   * attn_kernel (steps 3-4) is a small f32 GEMM engine on the CUDA cores
//     that keeps the TPU kernel's defining property -- no per-neighbour
//     per-channel (Nq, k, D) tensor ever reaches device memory.  A block of
//     256 threads owns TQ = 32 / S queries, S = k (+1) slots, i.e. R <= 32
//     rows (query, slot) that go through every MLP together (two blocks fit
//     an SM at D <= 200, so one block's gathers and softmax overlap the
//     other's products).  Activations live transposed in shared memory
//     (D x 36 floats, 16-byte row reads broadcast to a warp); each weight
//     streams through a double-buffered 16-row tile filled with cp.async
//     (rows padded to an odd pitch, so filling a tile down its columns meets
//     no shared-memory bank conflicts);
//     each thread accumulates an 8 x CJ register tile (CJ = ceil(D / 64)
//     columns, 64 threads across the channels).  The slot softmax is a last
//     pass over the logits and values in shared memory.
// Weights arrive in nn.Linear's (out, in) layout, contiguous: the modules'
// weights are read in place, with no copy per call.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNX = 64;               // threads across the channels
constexpr int kNY = 4;                // thread groups across the rows
constexpr int kThreads = kNX * kNY;   // 256
constexpr int kRows = 32;             // (query, slot) rows per block
constexpr int kRT = kRows / kNY;      // rows per thread: 8
constexpr int kRP = kRows + 4;        // padded row of a transposed activation
constexpr int kKC = 16;               // weight rows per staged tile
constexpr int kKMax = 32;             // largest k
constexpr int kDMax = 256;            // largest channel width
constexpr int kSelWarps = kThreads / 32;  // queries per selection block
constexpr int kChunk = 2048;          // kv points per staged selection chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Params {
  const float* xyz_q;    // (B, Nq, 3)
  const float* kv_xyz;   // (B, M, 3)
  const int* idx;        // (B, Nq, k) neighbour indices from knn_kernel
  const float* q;        // q[b * q_sb + n * q_sn + d], or null (pos-only)
  long long q_sb, q_sn;
  const float* K;        // (B, M, D) or null
  const float* V;        // (B, M, D) or null
  const float* k_glob;   // (B, D) or null
  const float* v_glob;   // (B, D) or null
  const float* dw0; const float* db0;  // (D, 3), (D)   (out, in) layout
  const float* dw1; const float* db1;  // (D, D), (D)
  const float* gw0; const float* gb0;  // (D, D), (D)
  const float* gw1; const float* gb1;  // (D, D), (D)
  float* out;            // (B, Nq, D)
  int B, Nq, M, D, k;
};

__device__ __forceinline__ bool knn_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// ---- kNN selection ----------------------------------------------------------

// Per-lane candidate lists live in registers: KL (8, 16 or 32 >= k) entries
// sorted ascending by (distance, index), padded with (+inf, INT_MAX); every
// index into them is a compile-time constant after unrolling.

// Insert (d, n) into the list, keeping its KL smallest entries (branch-free:
// the displaced entry bubbles down to the end).
template <int KL>
__device__ __forceinline__ void list_insert(float (&ld)[KL], int (&li)[KL], float d, int n) {
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    const bool lt = knn_less(d, n, ld[i], li[i]);
    const float od = ld[i];
    const int oi = li[i];
    ld[i] = lt ? d : od;
    li[i] = lt ? n : oi;
    d = lt ? od : d;
    n = lt ? oi : n;
  }
}

// Merge the lanes' lists by k rounds of warp arg-min, ties to the lower
// index; the winning lane pops its head.  Lane 0 writes the merged
// ascending indices (padding, never reached as k <= M, would become 0).
template <int KL>
__device__ void warp_merge(float (&ld)[KL], int (&li)[KL], int k, int lane, int* out) {
  for (int r = 0; r < k; ++r) {
    float bd = ld[0];
    int bi = li[0];
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (knn_less(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (bi == li[0] && bi != INT_MAX) {  // a kv index lives in one lane only
#pragma unroll
      for (int i = 0; i + 1 < KL; ++i) {
        ld[i] = ld[i + 1];
        li[i] = li[i + 1];
      }
      ld[KL - 1] = CUDART_INF_F;
      li[KL - 1] = INT_MAX;
    }
    if (lane == 0) out[r] = bi == INT_MAX ? 0 : bi;
  }
}

// idx[b, n, :] = the k nearest kv points of query n, ascending, ties to the
// lowest index.  Warp w of block x handles query x * 8 + w; its lanes scan
// the kv points in increasing order, lane l taking every 32nd from l.
template <int KL>
__global__ void __launch_bounds__(kThreads) knn_kernel(
    const float* __restrict__ xyz_q, const float* __restrict__ kv_xyz,
    const float* __restrict__ penalty, int Nq, int M, int k, int* __restrict__ idx) {
  __shared__ float4 pts[kChunk];  // x, y, z, penalty
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.x * kSelWarps + (tid >> 5);
  const bool live = n < Nq;
  const float* kv = kv_xyz + (size_t)b * M * 3;
  const float* pen = penalty ? penalty + (size_t)b * M : nullptr;
  const float* xq = xyz_q + ((size_t)b * Nq + (live ? n : 0)) * 3;
  const float qx = xq[0], qy = xq[1], qz = xq[2];
  float ld[KL];
  int li[KL];
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    ld[i] = CUDART_INF_F;
    li[i] = INT_MAX;
  }
  for (int base = 0; base < M; base += kChunk) {
    const int cn = min(kChunk, M - base);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < cn; e += kThreads) {
      const float* src = kv + (size_t)(base + e) * 3;
      pts[e] = make_float4(src[0], src[1], src[2], pen ? pen[base + e] : 0.0f);
    }
    __syncthreads();
    if (!live) continue;
    for (int e = lane; e < cn; e += 32) {
      const float4 c = pts[e];
      const float ex = __fsub_rn(qx, c.x);
      const float ey = __fsub_rn(qy, c.y);
      const float ez = __fsub_rn(qz, c.z);
      float d = __fadd_rn(c.w, __fmul_rn(ex, ex));
      d = __fadd_rn(d, __fmul_rn(ey, ey));
      d = __fadd_rn(d, __fmul_rn(ez, ez));
      if (knn_less(d, base + e, ld[KL - 1], li[KL - 1])) list_insert(ld, li, d, base + e);
    }
  }
  if (live) warp_merge(ld, li, k, lane, idx + ((size_t)b * Nq + n) * k);
}

// ---- attention over the selected slots --------------------------------------

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Row pitch of a staged weight tile: odd, so the kKC rows of one column
// fall in distinct shared-memory banks.
__host__ __device__ __forceinline__ int tile_pitch(int D) { return D | 1; }

// Stage input channels [c*kKC, c*kKC + kKC) of w ((out, in) = D x D) into
// dst as kKC rows of pitch P: kKC threads down each output channel's
// contiguous inputs.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ w, int D, int P,
                                           int c) {
  const int r0 = c * kKC, r = threadIdx.x % kKC;
  if (r0 + r < D)
    for (int d = threadIdx.x / kKC; d < D; d += kThreads / kKC)
      cp_async4(dst + r * P + d, w + d * D + r0 + r);
  cp_async_commit();
}

// One reduction step: acc[i][j] += xt[kk][ty*kRT + i] * tile[kk][tx + j*kNX].
template <int CJ>
__device__ __forceinline__ void fma_step(const float* xrow, const float* wrow, int D,
                                         float (&acc)[kRT][CJ]) {
  const int tx = threadIdx.x % kNX;
  const float4* xr4 = reinterpret_cast<const float4*>(xrow);
  float xr[kRT];
#pragma unroll
  for (int v = 0; v < kRT / 4; ++v) {
    const float4 x = xr4[v];
    xr[4 * v] = x.x;
    xr[4 * v + 1] = x.y;
    xr[4 * v + 2] = x.z;
    xr[4 * v + 3] = x.w;
  }
  float wc[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    wc[j] = d < D ? wrow[d] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
}

// acc[i][j] = sum_kk xt[kk][ty*kRT + i] * w[kk][tx + j*kNX]
// xt: (D, kRP) transposed activations in shared memory; w: (D, D), (out, in),
// in global memory; ws: two kKC x P tiles of shared memory.
template <int CJ>
__device__ void rows_gemm(const float* xt, const float* __restrict__ w, int D, float* ws,
                          float (&acc)[kRT][CJ]) {
  const int ty = threadIdx.x / kNX, P = tile_pitch(D);
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
  const int n_tiles = (D + kKC - 1) / kKC;
  stage_tile(ws, w, D, P, 0);
  for (int c = 0; c < n_tiles; ++c) {
    if (c + 1 < n_tiles) {
      stage_tile(ws + ((c + 1) & 1) * kKC * P, w, D, P, c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = ws + (c & 1) * kKC * P;
    const float* xc = xt + c * kKC * kRP + ty * kRT;
    const int kn = min(kKC, D - c * kKC);
    if (kn == kKC) {  // full tile: unrolled, so the loads pipeline
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) fma_step<CJ>(xc + kk * kRP, tile + kk * P, D, acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) fma_step<CJ>(xc + kk * kRP, tile + kk * P, D, acc);
    }
    __syncthreads();  // the tile is consumed before it is refilled
  }
}

// Store a thread's kRT rows of column d into a transposed activation buffer.
__device__ __forceinline__ void store_rows(float* xt, int d, const float (&v)[kRT]) {
  float4* dst = reinterpret_cast<float4*>(xt + d * kRP + (threadIdx.x / kNX) * kRT);
#pragma unroll
  for (int u = 0; u < kRT / 4; ++u) dst[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
}

template <int CJ>
__global__ void __launch_bounds__(kThreads, 2) attn_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, M = p.M, k = p.k;
  const int S = k + (p.k_glob ? 1 : 0);      // slots per query
  const int TQ = kRows / S;                  // queries per block
  const int R = TQ * S;                      // rows in use
  float* ht = smem;                          // (D, kRP) MLP hidden activations
  float* ut = ht + D * kRP;                  // (D, kRP) fc_gamma input, then logits
  float* vt = ut + D * kRP;                  // (D, kRP) values
  float* ws = vt + D * kRP;                  // (2, kKC, P) weight tiles
  float* dxs = ws + 2 * kKC * tile_pitch(D); // (kRows, 4) position delta per row
  int* nbr = reinterpret_cast<int*>(dxs + kRows * 4);  // (kRows) kv index per row

  const int b = blockIdx.y, t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, tx = tid % kNX, ty = tid / kNX;
  const float* kv = p.kv_xyz + (size_t)b * M * 3;

  // ---- neighbours and position deltas --------------------------------------
  for (int r = tid; r < kRows; r += kThreads) {
    const int t = r / S, s = r - t * S, n = t0 + t;
    const bool nb = r < R && s < k && n < p.Nq;
    const int j = nb ? p.idx[((size_t)b * p.Nq + n) * k + s] : 0;
    nbr[r] = j;
    const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? n : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) dxs[r * 4 + c] = nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
  }
  __syncthreads();

  // ---- fc_delta layer 0 ----------------------------------------------------
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float w0 = p.dw0[3 * d], w1 = p.dw0[3 * d + 1], w2 = p.dw0[3 * d + 2], b0 = p.db0[d];
    float h[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float* dx = dxs + (ty * kRT + i) * 4;
      h[i] = fmaxf(fmaf(dx[0], w0, fmaf(dx[1], w1, fmaf(dx[2], w2, b0))), 0.0f);
    }
    store_rows(ht, d, h);
  }

  // ---- fc_delta layer 1 -> pos; fc_gamma input and values ------------------
  float acc[kRT][CJ];
  rows_gemm<CJ>(ht, p.dw1, D, ws, acc);
  const bool pos_only = p.q == nullptr;
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b1 = p.db1[d];
    float u[kRT], v[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = ty * kRT + i, t = r / S, s = r - t * S;
      const float pos = acc[i][j] + b1;
      u[i] = pos;
      v[i] = pos;
      if (r >= R) continue;
      if (!pos_only) {
        const float qv = t0 + t < p.Nq ? p.q[b * p.q_sb + (long long)(t0 + t) * p.q_sn + d] : 0.0f;
        if (s < k) {
          const size_t row = ((size_t)b * M + nbr[r]) * D + d;
          u[i] = (qv - p.K[row]) + pos;
          v[i] = p.V[row] + pos;
        } else {  // global slot: zero position encoding
          u[i] = qv - p.k_glob[(size_t)b * D + d];
          v[i] = p.v_glob[(size_t)b * D + d];
        }
      }
    }
    store_rows(ut, d, u);
    store_rows(vt, d, v);
  }

  // ---- fc_gamma -------------------------------------------------------------
  rows_gemm<CJ>(ut, p.gw0, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b0 = p.gb0[d];
    float h[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) h[i] = fmaxf(acc[i][j] + b0, 0.0f);
    store_rows(ht, d, h);
  }
  rows_gemm<CJ>(ht, p.gw1, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b1 = p.gb1[d];
    float l[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) l[i] = acc[i][j] + b1;
    store_rows(ut, d, l);
  }
  __syncthreads();

  // ---- per-channel softmax over the slots ----------------------------------
  for (int e = tid; e < TQ * D; e += kThreads) {
    const int t = e / D, d = e - t * D;
    if (t0 + t >= p.Nq) continue;
    const float* l = ut + d * kRP + t * S;
    const float* v = vt + d * kRP + t * S;
    float m = l[0];
    for (int s = 1; s < S; ++s) m = fmaxf(m, l[s]);
    float se = 0.0f, o = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float ex = expf(l[s] - m);
      se += ex;
      o = fmaf(ex, v[s], o);
    }
    p.out[((size_t)b * p.Nq + t0 + t) * D + d] = o / se;
  }
}

// A failed runtime call also sets the thread's last error; clear it, so the
// next launch's cudaGetLastError() does not report this failure again.
cudaError_t failed(cudaError_t err) {
  cudaGetLastError();
  return err;
}

size_t smem_bytes(int D) {
  return (size_t)(3 * D * kRP + 2 * kKC * tile_pitch(D) + 4 * kRows) * sizeof(float) +
         kRows * sizeof(int);
}

template <int CJ>
cudaError_t launch_attention(const Params& p, int device, cudaStream_t stream) {
  // Opt in, once per device, to the shared memory of this instantiation's
  // widest D (more than the default 48 KB).
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(CJ * kNX));
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const size_t smem = smem_bytes(p.D);
  const int tq = kRows / (p.k + (p.k_glob ? 1 : 0));
  const dim3 grid((p.Nq + tq - 1) / tq, p.B);
  attn_kernel<CJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_knn(const float* xyz_q, const float* kv_xyz, const float* penalty, int B,
                       int Nq, int M, int k, int* idx, cudaStream_t stream) {
  const dim3 grid((Nq + kSelWarps - 1) / kSelWarps, B);
  if (k <= 8)
    knn_kernel<8><<<grid, kThreads, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
  else if (k <= 16)
    knn_kernel<16><<<grid, kThreads, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
  else
    knn_kernel<32><<<grid, kThreads, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// idx: (B, Nq, k) int32 scratch for the neighbour indices, written here.
// dw0, dw1, gw0, gw1: (out, in) weights, contiguous.
int nsdp_fused_attention(
    const float* xyz_q, const float* kv_xyz, const float* penalty,
    const float* q, long long q_sb, long long q_sn,
    const float* K, const float* V, const float* k_glob, const float* v_glob,
    const float* dw0, const float* db0, const float* dw1, const float* db1,
    const float* gw0, const float* gb0, const float* gw1, const float* gb1,
    int* idx, float* out, int B, int Nq, int M, int D, int k, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || D < 1 || D > kDMax || k < 1 || k > kKMax || k > M ||
      k + (k_glob ? 1 : 0) > kRows || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if ((q == nullptr) != (K == nullptr) || (K == nullptr) != (V == nullptr) ||
      (k_glob == nullptr) != (v_glob == nullptr) || (k_glob != nullptr && q == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)failed(err);
  const cudaStream_t s = (cudaStream_t)stream;
  err = launch_knn(xyz_q, kv_xyz, penalty, B, Nq, M, k, idx, s);
  if (err != cudaSuccess) return (int)err;
  const Params p{xyz_q, kv_xyz, idx, q, q_sb, q_sn, K, V, k_glob, v_glob,
                 dw0, db0, dw1, db1, gw0, gb0, gw1, gb1, out, B, Nq, M, D, k};
  switch ((D + kNX - 1) / kNX) {
    case 1: return (int)launch_attention<1>(p, device, s);
    case 2: return (int)launch_attention<2>(p, device, s);
    case 3: return (int)launch_attention<3>(p, device, s);
    default: return (int)launch_attention<4>(p, device, s);
  }
}

}  // extern "C"
