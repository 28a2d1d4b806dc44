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
//     merge with k rounds of warp arg-min (knn_select.cuh, shared with the
//     standalone kNN of knn.cu).  Apart from the attention kernel, its
//     candidate lists do not crowd the registers of the products.
//   * attn_kernel (steps 3-4) is a small f32 GEMM engine on the CUDA cores
//     (rows_gemm.cuh) that keeps the TPU kernel's defining property -- no
//     per-neighbour per-channel (Nq, k, D) tensor ever reaches device
//     memory.  A block of 256 threads owns TQ = 32 / S queries, S = k (+1)
//     slots, i.e. R <= 32 rows (query, slot) that go through every MLP
//     together (two blocks fit an SM at D <= 200, so one block's gathers
//     and softmax overlap the other's products).  The slot softmax is a
//     last pass over the logits and values in shared memory.
// Weights arrive in nn.Linear's (out, in) layout, contiguous: the modules'
// weights are read in place, with no copy per call.

#include <cuda_runtime.h>

#include <cstdint>

#include "knn_select.cuh"
#include "rows_gemm.cuh"

namespace {

using namespace rows;

constexpr int kKMax = knnsel::kKMax;  // largest k
constexpr int kDMax = 256;            // largest channel width

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

// ---- kNN selection (knn_select.cuh, shared with K4) -------------------------

template <int KL>
__global__ void __launch_bounds__(knnsel::kThreads) knn_kernel(
    const float* __restrict__ xyz_q, const float* __restrict__ kv_xyz,
    const float* __restrict__ penalty, int Nq, int M, int k, int* __restrict__ idx) {
  knnsel::select_body<KL, false>(xyz_q, kv_xyz, penalty, Nq, M, k, idx, nullptr);
}

// ---- attention over the selected slots --------------------------------------

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
  rows_gemm<CJ, false>(ht, p.dw1, D, ws, acc);
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
  rows_gemm<CJ, false>(ut, p.gw0, D, ws, acc);
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
  rows_gemm<CJ, false>(ht, p.gw1, D, ws, acc);
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
  const dim3 grid((Nq + knnsel::kWarps - 1) / knnsel::kWarps, B);
  const int t = knnsel::kThreads;
  if (k <= 8)
    knn_kernel<8><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
  else if (k <= 16)
    knn_kernel<16><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
  else
    knn_kernel<32><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx);
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
