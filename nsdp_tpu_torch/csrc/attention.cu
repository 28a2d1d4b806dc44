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
// point.  Kernels launched back to back on one stream:
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
//     last pass over the logits and values in shared memory.  Weights
//     arrive in nn.Linear's (out, in) layout, contiguous, and are read in
//     place.
//   * attn_bcast_kernel replaces attn_kernel where the query is one row
//     broadcast over a batch item's queries (row stride 0) with a global
//     slot and k <= 8: the decoder, three quarters of K1's time per
//     evaluation on attn_kernel.  Its global slot's logits fc_gamma(q - k_glob) are the same for
//     every query, so glob_logits_kernel computes them once per batch item;
//     a thread then owns one query's k neighbour rows by 4 adjacent
//     channels (50 x 4 = D at D = 200: no padded column) through all three
//     products, keeps the values and logits in registers and does the
//     query's softmax itself.  The products read an (in, out) copy of the
//     weights made once per call (weights_in_out_kernel), staged into a
//     3-deep ring of 32-row tiles by 16-byte cp.async, one barrier per
//     tile, the ring running on across the three products; 500 threads (16
//     warps) a block and one block an SM at D = 200.
// Both compute every output with the same chains -- an fmaf per input, in
// ascending order, from 0, then + bias; the slot softmax in slot order, the
// global slot last -- so both give the same bits.
//
// That FFMA broadcast engine runs only where a backward follows
// (_FusedAttention's forward, attn_bcast_kernel<RT, 0, 0>): a training
// forward's rounding moves every later activation of the step, K2's FFMA
// recompute of the products (attention_bwd.cu) must give the bits this
// forward gave, and the full-width step checks pin batch seeds chosen for
// them.  A call that no backward follows -- serving, edit sessions,
// predict, validation: no operand requires grad -- runs the broadcast
// path's D x D products on the tensor cores instead (attn_bcast_kernel<0,
// NW, NWG>, mode 3 of the C entry), in 3xTF32 (rows_mma.cuh's arithmetic:
// float32-accurate, each 8-deep k-step summed apart and added to the
// float32 running sum), where the CUDA cores' float32 rate could not reach
// the products' bound (PERF.md):
//   * weights_in_out_kernel<1> lays the three weights out once per call,
//     split and in the engine's K-major order, back to back;
//   * a block is NWG warpgroups of NW n-tiles (5 x 5 at D = 200, no padded
//     column) and a producer warp, one an SM (two of two warpgroups up to D
//     = 128), running 64-row tiles of whole queries (9 at k = 7: 63 rows)
//     one after another until they are done; the three products' k-steps
//     stream through one ring of slots in shared memory that runs on across
//     products and tiles, staged by the producer warp (a bulk copy a slot)
//     as each slot's empty mbarrier reports every warp done with it, so
//     the warpgroups never wait for one another within a product;
//   * per tile the neighbours and deltas, fc_delta's 3-wide first layer in
//     f32 FMA chains, then each product's epilogue writing the next one's
//     input in place (u = (q - K[n]) + pos with the values V[n] + pos kept
//     in f32 beside it; the hidden layer; the logits over the spent
//     activations) and the slot softmax in slot order, the global slot's
//     logits (glob_logits_kernel) last.  Biases, the query row and the
//     global slot's logits and value sit in shared memory.
//
// The narrow-operand mode (mode 1 bfloat16, 2 float16) is the TPU kernel's
// compute_dtype (attention_pallas.py:113-119, 757-814): every MLP layer's
// input is rounded to the narrow type to nearest even -- dx before
// fc_delta, its hidden activations, fc_gamma's inputs (q - K[n] + pos,
// q - k_glob) and hidden activations -- and so are the weights and V; the
// products are exact with f32 sums, the biases f32; coordinates, K, the
// global slot's k/v, the values V[n] + pos and the softmax stay f32.  Its
// D x D products are what the tensor cores take natively, so it has kernels
// of its own on them (rows_mma16.cuh):
//   * weight_frags16_kernel lays the three D x D weights out once per call,
//     rounded, in the fragment order mma.sync reads, into scratch the wrapper
//     allocates;
//   * attn_mma16_kernel takes every site (pos-only, featured, masked or
//     not, a broadcast query or not): a block of 32 warps(D) threads owns
//     64 (query, slot) rows of whole queries, two blocks an SM up to
//     D = 216.  The rows' deltas and neighbours go to shared memory;
//     fc_delta's 3-wide first layer stays an f32 FMA chain on the rounded
//     inputs (padded to a 16-deep MMA it would waste 5/6 of it) and is
//     stored as 16-bit rows; then the three products run on the engine, each
//     epilogue adding the bias and storing the next product's 16-bit input
//     in place (the narrow rounding is the store), the values V[n] + pos in
//     f32 beside it, and the logits in f32 over the spent activations; the
//     slot softmax is a last pass over the logits and values in shared
//     memory, in slot order.  A global slot is a row of its query
//     (u = q - k_glob, value v_glob), or, where the query is broadcast (row
//     stride 0), glob_logits_kernel computes its logits once per batch item
//     and the softmax adds it last.  Outside the products a column pair
//     stays with its thread and its rows' gathers go out several at a time:
//     run row by row, the gathers of K and V took nearly as long as the
//     block's three products (PERF.md).
// knn_kernel and glob_logits_kernel are shared with the f32 mode; the f32
// kernels above keep their code and bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "knn_select.cuh"
#include "rows_gemm.cuh"
#include "rows_mma.cuh"
#include "rows_mma16.cuh"

namespace {

using namespace gemm;

constexpr int kKMax = knnsel::kKMax;  // largest k
constexpr int kDMax = 256;            // largest channel width

// A value in the narrow mode NW (0: f32, unchanged; 1: bfloat16; 2:
// float16), rounded to nearest even and widened back to f32.
template <int NW>
__device__ __forceinline__ float narrow(float x) {
  if constexpr (NW == 1) return __bfloat162float(__float2bfloat16_rn(x));
  else if constexpr (NW == 2) return __half2float(__float2half_rn(x));
  else return x;
}

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
  float* glog;           // (B, D) global-slot logits of a broadcast query, or null
  const float* wt;       // (3, D, 4 nx) (in, out) dw1, gw0, gw1 (broadcast path)
  const uint2* frag;     // narrow mode: dw1, gw0, gw1 in fragment order (rows_mma16.cuh)
  int B, Nq, M, D, k;
  int nx, ny;            // broadcast path: threads across the channels, queries a block
  int round_v;           // narrow mode: round V to the narrow type (not a projection's)
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
    for (int c = 0; c < 3; ++c)
      dxs[r * 4 + c] = nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
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
        attn_kernel<CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(CJ * kNX));
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const size_t smem = smem_bytes(p.D);
  const int tq = kRows / (p.k + (p.k_glob ? 1 : 0));
  const dim3 grid((p.Nq + tq - 1) / tq, p.B);
  attn_kernel<CJ><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}


// ---- the broadcast query's path ----------------------------------------------

constexpr int kBcastKMax = 8;    // most neighbours a thread's rows hold
constexpr int kBcastThreads = 512;
constexpr int kBcastQueries = 16;  // most queries a block
constexpr int kStages = 3;       // weight tiles in flight
constexpr int kTile = 32;        // weight rows a tile
constexpr int kMaxSmem = 232448; // opt-in shared memory of an sm_90 block

// The global slot's logits, fc_gamma(q - k_glob), once per batch item: the
// chains of rows_gemm (an fmaf per input, ascending, from 0, then + bias),
// so they carry the bits attn_kernel's own global row would give.  In the
// narrow mode NW its layers' inputs and weights are rounded as the mode
// rounds them.
template <int NW>
__global__ void __launch_bounds__(kThreads) glob_logits_kernel(const Params p) {
  __shared__ float u[kDMax], h[kDMax];
  const int b = blockIdx.x, D = p.D;
  for (int d = threadIdx.x; d < D; d += kThreads)
    u[d] = narrow<NW>(p.q[b * p.q_sb + d] - p.k_glob[(size_t)b * D + d]);
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.0f;
    for (int kk = 0; kk < D; ++kk) acc = fmaf(u[kk], narrow<NW>(p.gw0[d * D + kk]), acc);
    h[d] = narrow<NW>(fmaxf(acc + p.gb0[d], 0.0f));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float acc = 0.0f;
    for (int kk = 0; kk < D; ++kk) acc = fmaf(h[kk], narrow<NW>(p.gw1[d * D + kk]), acc);
    p.glog[(size_t)b * D + d] = acc + p.gb1[d];
  }
}

// The three D x D products' weights (m: dw1, gw0, gw1) laid out once per
// call.  TC = 0 (the FFMA engine): wt[m][kk][d] = w_m[d][kk], columns D ..
// dp - 1 zero.  TC = 1 (the tensor-core engine, rows_mma.cuh): each weight's
// B = w^T zero-padded to pad8(D) x dp and split into TF32 hi and lo parts
// in the engine's K-major order, as weight_frags_kernel lays out K2's
// (dp = tc_cols(D) there); the three back to back, the ring's cycle.
template <int TC>
__global__ void weights_in_out_kernel(const Params p, int dp, float* wt) {
  if constexpr (TC == 0) {
    const size_t n = (size_t)3 * p.D * dp;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
         e += (size_t)gridDim.x * blockDim.x) {
      const int d = (int)(e % dp), kk = (int)(e / dp % p.D), m = (int)(e / dp / p.D);
      const float* w = m == 0 ? p.dw1 : m == 1 ? p.gw0 : p.gw1;
      wt[e] = d < p.D ? w[(size_t)d * p.D + kk] : 0.0f;
    }
  } else {
    const int D = p.D;
    const size_t per = (size_t)2 * rows::pad8(D) * dp, n = 3 * per;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
         e += (size_t)gridDim.x * blockDim.x) {
      // per weight: e = kc 16 dp + q 8 dp + g 64 + h 32 + i 4 + x, part q
      // of B[8 kc + 4 h + x][8 g + i]
      const int m = (int)(e / per), f = (int)(e % per);
      const int kc = f / (16 * dp), q = (f / (8 * dp)) % 2, r = f % (8 * dp);
      const int kk = 8 * kc + 4 * ((r / 32) % 2) + r % 4, d = 8 * (r / 64) + (r / 4) % 8;
      const float* w = m == 0 ? p.dw1 : m == 1 ? p.gw0 : p.gw1;
      uint32_t hi, lo;
      rows::split_tf32(kk < D && d < D ? w[(size_t)d * D + kk] : 0.0f, hi, lo);
      wt[e] = __uint_as_float(q ? lo : hi);
    }
  }
}

// Stage k-tile g of the three products' sequence (product g / nt, its rows
// [c kTile, c kTile + kTile), c = g % nt) into ring slot g % kStages: contiguous
// rows of wt, 16 bytes a copy.  Commits a group even past the last tile, so
// every thread counts the same groups.
__device__ __forceinline__ void stage_ring(float* ring, const float* __restrict__ wt, int D, int dp,
                                           int nt, int g) {
  if (g < 3 * nt) {
    const int m = g / nt, r0 = (g - m * nt) * kTile, kn = min(kTile, D - r0);
    const float* src = wt + ((size_t)m * D + r0) * dp;
    float* dst = ring + (g % kStages) * kTile * dp;
    for (int e = threadIdx.x; e < kn * dp / 4; e += blockDim.x)
      cp_async16(dst + 4 * e, src + 4 * e);
  }
  cp_async_commit();
}

// One reduction step of a thread's RT rows by 4 channels.
template <int RT>
__device__ __forceinline__ void fma_step4(const float* xrow, const float* wrow,
                                          float (&acc)[RT][4]) {
  const float4 x0 = *reinterpret_cast<const float4*>(xrow);
  const float4 x1 = *reinterpret_cast<const float4*>(xrow + 4);
  const float4 w4 = *reinterpret_cast<const float4*>(wrow);
  const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
}

// A thread's RT rows of channel d into a transposed activation (8 floats a
// query, 16-byte stores).
template <int RT>
__device__ __forceinline__ void store8(float* dst, const float (&v)[RT]) {
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = i < RT ? v[i] : 0.0f;
  reinterpret_cast<float4*>(dst)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(r[4], r[5], r[6], r[7]);
}

size_t bcast_smem_bytes(int nx, int ny) {
  const int dp = 4 * nx, P = ny * kRT + 4;
  return (size_t)(2 * dp * P + kStages * kTile * dp + ny * kRT * 4) * sizeof(float) +
         ny * kRT * sizeof(int);
}

// ---- the broadcast path on the tensor cores, where no backward follows ----

// The tensor-core kernel's shape at width D: NWG warpgroups of NW n-tiles (8
// columns) each, covering pad8(D) with as little padding as the wgmma widths
// it is instantiated for allow (exactly at D = 200: 5 x 5); a block of two
// warpgroups shares its SM with a second.
__host__ __device__ inline int tc_groups(int D) {
  const int t = rows::pad8(D) / 8;
  return t <= 16 ? 2 : t <= 20 ? 4 : t <= 25 ? 5 : 4;
}
__host__ __device__ inline int tc_tiles(int D) {
  const int t = rows::pad8(D) / 8;
  return t <= 8 ? 4 : t <= 16 ? 8 : t <= 25 ? 5 : 8;
}
// Columns of B the warpgroups cover (Np >= pad8(D)).
__host__ __device__ inline int tc_cols(int D) { return 8 * tc_tiles(D) * tc_groups(D); }
constexpr int kTcMaxSlots = 8;
// Shared memory without the ring: the activations (64 rows, pitch
// act_pitch(D)), the values (pitch mma16::tile_pitch(D): a warp's float2
// stores of its accumulator fragments meet no bank conflict, as the narrow
// kernel's), per row a 4-float position delta and a kv index,
// and six pad8(D)-wide rows of per-column constants (db1, gb0, gb1; the
// batch item's query row, global logits and v_glob), zero from D on.
__host__ __device__ inline size_t tc_fixed_bytes(int D) {
  return (size_t)4 * rows::kRows * (rows::act_pitch(D) + mma16::tile_pitch(D) + 4) + 4 * rows::kRows +
         24 * rows::pad8(D);
}
// Ring slots: as many as the block's share of the SM leaves room for, up to
// kTcMaxSlots; a slot is a k-step's 16 Np floats and two mbarriers.
__host__ __device__ inline int tc_slots(int D) {
  const size_t budget = tc_groups(D) == 2 ? 233472 / 2 - 1024 : kMaxSmem;
  const size_t per = (size_t)64 * tc_cols(D) + 16, n = (budget - tc_fixed_bytes(D)) / per;
  return n < kTcMaxSlots ? (int)n : kTcMaxSlots;
}
size_t bcast_tc_smem_bytes(int D) {
  return tc_fixed_bytes(D) + (size_t)tc_slots(D) * (64 * tc_cols(D) + 16);
}

// The accumulator fragments a thread holds (rows::for_each_elem's elements):
// rows tc_row(0) and tc_row(1) of the tile, and per n-tile j the column pair
// (tc_col(j), tc_col(j) + 1), elements 4 j + 2 h and 4 j + 2 h + 1 of row h.
__device__ __forceinline__ int tc_row(int h) {
  return ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4 + 8 * h;
}
template <int NW>
__device__ __forceinline__ int tc_col(int j) {
  return ((threadIdx.x / 128) * NW + j) * 8 + 2 * (threadIdx.x % 4);
}
__device__ __forceinline__ bool aligned8(const void* x) { return ((uintptr_t)x & 7) == 0; }
// Columns c, c + 1 (c even) of a D-wide row, zero from D on; vec: one 8-byte
// load (D even, the row 8-byte aligned).
__device__ __forceinline__ float2 ld2(const float* x, int c, int D, bool vec) {
  if (vec) return c < D ? __ldg(reinterpret_cast<const float2*>(x + c)) : make_float2(0.0f, 0.0f);
  return make_float2(c < D ? __ldg(x + c) : 0.0f, c + 1 < D ? __ldg(x + c + 1) : 0.0f);
}
// act (pitch P) = acc + bias (shared, zero from D on), through a ReLU where
// relu; columns D .. pad8(D) - 1 come out zero.
template <int NW>
__device__ __forceinline__ void tc_epilogue(const float (&acc)[4 * NW], const float* bias, int D,
                                            float* act, int P, bool relu) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = tc_col<NW>(j);
    if (c >= rows::pad8(D)) continue;
    const float2 b2 = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x0 = acc[4 * j + 2 * h] + b2.x, x1 = acc[4 * j + 2 * h + 1] + b2.y;
      if (relu) x0 = fmaxf(x0, 0.0f), x1 = fmaxf(x1, 0.0f);
      *reinterpret_cast<float2*>(act + tc_row(h) * P + c) = make_float2(x0, x1);
    }
  }
}

// The broadcast path's rows on the tensor cores (3xTF32, rows_mma.cuh's ring
// engine).  A block runs row tiles blockIdx.x, + gridDim.x, ... (tile: the
// TQ = 64 / k queries from TQ (tile % per_b) of batch item tile / per_b, all
// k slots of each: row r = t k + s; rows TQ k .. 63 are padding that no
// output reads)
// through the three products, the ring of the weights' k-steps running on
// from tile to tile.  Per tile: the rows' neighbours and deltas; fc_delta's
// 3-wide first layer in f32 FMA chains into the activations (columns D ..
// pad8(D) - 1 zero); then each product into accumulators whose epilogue
// writes the next product's input in place: u = (q - K[n]) + pos, the
// values V[n] + pos beside it; the hidden layer; the logits.  The slot
// softmax, the global slot (glob_logits_kernel's) last, is a pass over the
// logits and values in shared memory, in slot order.
template <int NW, int NWG>
__device__ __forceinline__ void attn_bcast_tc(const Params& p) {
  constexpr int R = rows::kRows;
  extern __shared__ float4 smem4[];
  const int D = p.D, M = p.M, k = p.k, Dp = rows::pad8(D), P = rows::act_pitch(D);
  const int VP = mma16::tile_pitch(D), Np = 8 * NW * NWG, n_slots = tc_slots(D);
  const int TQ = R / k, per_b = (p.Nq + TQ - 1) / TQ, tiles = p.B * per_b, n_steps = Dp / 8;
  const int tid = threadIdx.x, nthr = 128 * NWG;  // the warpgroups; a producer warp beyond
  float* ring = reinterpret_cast<float*>(smem4);  // (n_slots, 16 Np) weight k-steps
  float* act = ring + (size_t)n_slots * 16 * Np;   // (R, P) MLP inputs, then the logits
  float* vals = act + R * P;                       // (R, VP) values
  float* dxs = vals + R * VP;                      // (R, 4) position deltas
  int* nbr = reinterpret_cast<int*>(dxs + 4 * R);  // (R) kv index per row
  float* cst = reinterpret_cast<float*>(nbr + R);  // (6, Dp) per-column constants
  float *c_db1 = cst, *c_gb0 = cst + Dp, *c_gb1 = cst + 2 * Dp;
  float *c_q = cst + 3 * Dp, *c_glog = cst + 4 * Dp, *c_vg = cst + 5 * Dp;
  uint64_t* full = reinterpret_cast<uint64_t*>(cst + 6 * Dp);  // (n_slots) the ring's mbarriers
  uint64_t* empty = full + n_slots;
  const int my_tiles = ((int)blockIdx.x < tiles) ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const rows::StepRing ring_s{ring, full, empty, p.wt, 16 * Np, n_slots, n_steps,
                              3 * n_steps, my_tiles * 3 * n_steps, 4 * NWG};
  if (tid == 0) rows::ring_init(ring_s);
  for (int d = tid; d < Dp; d += blockDim.x) {
    c_db1[d] = d < D ? __ldg(p.db1 + d) : 0.0f;
    c_gb0[d] = d < D ? __ldg(p.gb0 + d) : 0.0f;
    c_gb1[d] = d < D ? __ldg(p.gb1 + d) : 0.0f;
  }
  __syncthreads();
  if (tid >= nthr) {  // the producer warp: one thread stages every k-step
    if (tid == nthr) rows::ring_produce(ring_s);
    return;
  }

  // fc_delta's first layer: a column d a thread, its weights loaded once
  const int rstep = nthr / Dp, d = tid % Dp;
  const bool in = d < D && tid < rstep * Dp;
  const float w0 = in ? __ldg(p.dw0 + 3 * d) : 0.0f, w1 = in ? __ldg(p.dw0 + 3 * d + 1) : 0.0f;
  const float w2 = in ? __ldg(p.dw0 + 3 * d + 2) : 0.0f, b0 = in ? __ldg(p.db0 + d) : 0.0f;
  float acc[4 * NW];
  int g = 0;  // the tile's first k-step in the ring's sequence
  int cur_b = -1;  // the batch item whose constants c_q, c_glog, c_vg hold
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, g += 3 * n_steps) {
    const int b = tile / per_b, t0 = (tile - b * per_b) * TQ;
    const float* kv = p.kv_xyz + (size_t)b * M * 3;
    // ---- neighbours and position deltas ------------------------------------
    for (int r = tid; r < R; r += nthr) {
      const int t = r / k, s = r - t * k, n = t0 + t;
      const bool nb = t < TQ && n < p.Nq;
      const int j = nb ? p.idx[((size_t)b * p.Nq + n) * k + s] : 0;
      nbr[r] = j;
      const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? n : 0)) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) dxs[r * 4 + c] = nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
    }
    rows::ring_sync(nthr);  // also: the last tile's softmax has read act and vals

    // ---- fc_delta layer 0: a column a thread ---------------------------------
    {
      if (tid < rstep * Dp) {
#pragma unroll 4
        for (int r = tid / Dp; r < R; r += rstep) {
          const float4 dx = *reinterpret_cast<const float4*>(dxs + r * 4);
          act[r * P + d] = fmaxf(fmaf(dx.x, w0, fmaf(dx.y, w1, fmaf(dx.z, w2, b0))), 0.0f);
        }
      }
      if (b != cur_b) {  // the batch item's constants (the last tile's softmax is done)
        for (int e = tid; e < Dp; e += nthr) {
          const bool in = e < D;
          c_q[e] = in ? __ldg(p.q + b * p.q_sb + e) : 0.0f;
          c_glog[e] = in ? __ldg(p.glog + (size_t)b * D + e) : 0.0f;
          c_vg[e] = in ? __ldg(p.v_glob + (size_t)b * D + e) : 0.0f;
        }
        cur_b = b;
      }
    }
    rows::ring_sync(nthr);

    // ---- fc_delta layer 1 -> pos; u = (q - K[n]) + pos and V[n] + pos --------
    // (a thread's two rows' K and V rows located once; columns D .. pad8(D)
    // - 1 read as zeros and come out zero: B's columns there are zero)
    rows::rows_mma_ring<NW>(act, P, ring_s, g, acc);
    rows::ring_sync(nthr);  // every warpgroup has loaded its A fragments of act
    {
      const bool vec = D % 2 == 0 && aligned8(p.K) && aligned8(p.V);
      const float* kr[2];
      const float* vr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = ((size_t)b * M + nbr[tc_row(h)]) * D;
        kr[h] = p.K + row, vr[h] = p.V + row;
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int c = tc_col<NW>(j);
        if (c >= Dp) continue;
        const float2 q2 = *reinterpret_cast<const float2*>(c_q + c);
        const float2 b2 = *reinterpret_cast<const float2*>(c_db1 + c);
        const float2 k2[2] = {ld2(kr[0], c, D, vec), ld2(kr[1], c, D, vec)};
        const float2 v2[2] = {ld2(vr[0], c, D, vec), ld2(vr[1], c, D, vec)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = acc[4 * j + 2 * h] + b2.x, p1 = acc[4 * j + 2 * h + 1] + b2.y;
          const int r = tc_row(h);
          *reinterpret_cast<float2*>(act + r * P + c) =
              make_float2((q2.x - k2[h].x) + p0, (q2.y - k2[h].y) + p1);
          *reinterpret_cast<float2*>(vals + r * VP + c) = make_float2(v2[h].x + p0, v2[h].y + p1);
        }
      }
    }
    rows::ring_sync(nthr);

    // ---- fc_gamma ------------------------------------------------------------
    rows::rows_mma_ring<NW>(act, P, ring_s, g + n_steps, acc);
    rows::ring_sync(nthr);
    tc_epilogue<NW>(acc, c_gb0, D, act, P, true);
    rows::ring_sync(nthr);
    rows::rows_mma_ring<NW>(act, P, ring_s, g + 2 * n_steps, acc);
    rows::ring_sync(nthr);
    tc_epilogue<NW>(acc, c_gb1, D, act, P, false);  // the logits
    rows::ring_sync(nthr);

    // ---- per-channel softmax over the slots, the global slot last: a
    // channel a thread, queries tid / D, + nthr / D, ... ----------------------
    const int qstep = nthr / D, ch = tid % D, tq = min(TQ, p.Nq - t0);
    if (tid < qstep * D) {
      const float lg = c_glog[ch], vg = c_vg[ch];
      for (int t = tid / D; t < tq; t += qstep) {
        const float* l = act + t * k * P + ch;
        const float* v = vals + t * k * VP + ch;
        float x[kBcastKMax], y[kBcastKMax];
#pragma unroll
        for (int s = 0; s < kBcastKMax; ++s) {
          const int si = min(s, k - 1);
          x[s] = l[si * P], y[s] = v[si * VP];
        }
        float mx = lg;
#pragma unroll
        for (int s = 0; s < kBcastKMax; ++s) mx = fmaxf(mx, x[s]);  // repeats change no max
        float se = 0.0f, o = 0.0f;
#pragma unroll
        for (int s = 0; s < kBcastKMax; ++s) {
          if (s >= k) break;
          const float ex = expf(x[s] - mx);
          se += ex;
          o = fmaf(ex, y[s], o);
        }
        const float ex = expf(lg - mx);
        se += ex;
        o = fmaf(ex, vg, o);
        p.out[((size_t)b * p.Nq + t0 + t) * D + ch] = o / se;
      }
    }
  }
}

// The broadcast path's rows.  NW = 0: the FFMA engine, where a backward
// follows (its bits are the row path's, which K2's recompute matches):
// thread (tx, ty) owns query blockIdx.x * ny + ty of batch item blockIdx.y,
// its rows 0 .. k-1 (RT >= k; rows k .. RT-1 idle) by channels 4 tx .. 4 tx
// + 3.  NW > 0: the tensor-core engine where none does (attn_bcast_tc, NWG
// warpgroups of NW n-tiles).
template <int RT, int NW, int NWG>
__global__ void __launch_bounds__(NW == 0 ? kBcastThreads : 128 * NWG + 32, NWG == 2 ? 2 : 1)
    attn_bcast_kernel(const Params p) {
  if constexpr (NW != 0) {
    attn_bcast_tc<NW, NWG>(p);
    return;
  } else {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, M = p.M, k = p.k, nx = p.nx, ny = p.ny, dp = 4 * nx, P = ny * kRT + 4;
  float* xa = smem;                          // (dp, P) fc_delta's, then fc_gamma's hidden layer
  float* xb = xa + dp * P;                   // (dp, P) fc_gamma's input
  float* ring = xb + dp * P;                 // (kStages, kTile, dp) weight tiles
  float* dxs = ring + kStages * kTile * dp;  // (ny * 8, 4) position deltas
  int* nbr = reinterpret_cast<int*>(dxs + ny * kRT * 4);  // (ny * 8) kv index per row

  const int b = blockIdx.y, q0 = blockIdx.x * ny;
  const int tid = threadIdx.x, tx = tid % nx, ty = tid / nx, n = q0 + ty;
  const int nt = (D + kTile - 1) / kTile;    // k-tiles of one product
  for (int g = 0; g < kStages - 1; ++g)       // the first tiles load under the set-up
    stage_ring(ring, p.wt, D, dp, nt, g);

  // ---- neighbours and position deltas --------------------------------------
  const float* kv = p.kv_xyz + (size_t)b * M * 3;
  for (int e = tid; e < ny * kRT; e += blockDim.x) {
    const int t = e / kRT, s = e % kRT, q = q0 + t;
    const bool nb = s < k && q < p.Nq;
    const int j = nb ? p.idx[((size_t)b * p.Nq + q) * k + s] : 0;
    nbr[e] = j;
    const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? q : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dxs[e * 4 + c] = nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
  }
  __syncthreads();

  // ---- fc_delta layer 0 (the ring's first barrier publishes it) -------------
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d = 4 * tx + c;
    if (d >= D) continue;
    const float w0 = p.dw0[3 * d], w1 = p.dw0[3 * d + 1], w2 = p.dw0[3 * d + 2], b0 = p.db0[d];
    float h[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float* dx = dxs + (ty * kRT + i) * 4;
      h[i] = fmaxf(fmaf(dx[0], w0, fmaf(dx[1], w1, fmaf(dx[2], w2, b0))), 0.0f);
    }
    store8(xa + d * P + ty * kRT, h);
  }

  // ---- the three products: fc_delta layer 1, fc_gamma layers 0 and 1 -------
  float acc[RT][4], val[RT][4];
  for (int g = 0; g < 3 * nt; ++g) {
    const int m = g / nt, c = g - m * nt;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    cp_async_wait<kStages - 2>();  // tile g has landed (this thread's copies) ...
    __syncthreads();  // ... everyone's; and tile g - 1's slot is consumed: refill it
    stage_ring(ring, p.wt, D, dp, nt, g + kStages - 1);
    const float* tile = ring + (g % kStages) * kTile * dp + 4 * tx;
    const float* xc = (m == 1 ? xb : xa) + c * kTile * P + ty * kRT;
    const int kn = min(kTile, D - c * kTile);
    if (kn == kTile) {
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk) fma_step4<RT>(xc + kk * P, tile + kk * dp, acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) fma_step4<RT>(xc + kk * P, tile + kk * dp, acc);
    }
    if (c != nt - 1 || m == 2) continue;
    // a product's epilogue; the next product's first barrier publishes it
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 4 * tx + j;
      if (d >= D) continue;
      float x[RT];
      if (m == 0) {  // pos -> u = (q - K[n]) + pos into xb; values V[n] + pos kept
        const float b1 = p.db1[d], qv = p.q[b * p.q_sb + d];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pos = acc[i][j] + b1;
          const size_t row = ((size_t)b * M + nbr[ty * kRT + i]) * D + d;
          x[i] = (qv - p.K[row]) + pos;
          val[i][j] = p.V[row] + pos;
        }
        store8(xb + d * P + ty * kRT, x);
      } else {       // fc_gamma's hidden layer into xa
        const float b0 = p.gb0[d];
#pragma unroll
        for (int i = 0; i < RT; ++i) x[i] = fmaxf(acc[i][j] + b0, 0.0f);
        store8(xa + d * P + ty * kRT, x);
      }
    }
  }

  // ---- logits and the per-channel softmax over the slots, global last ------
  if (n >= p.Nq) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 4 * tx + j;
    if (d >= D) continue;
    const float b1 = p.gb1[d], lg = p.glog[(size_t)b * D + d];
    float l[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) l[i] = acc[i][j] + b1;
    float mx = l[0];
#pragma unroll
    for (int s = 1; s < RT; ++s)
      if (s < k) mx = fmaxf(mx, l[s]);
    mx = fmaxf(mx, lg);
    float se = 0.0f, o = 0.0f;
#pragma unroll
    for (int s = 0; s < RT; ++s) {
      if (s >= k) continue;
      const float ex = expf(l[s] - mx);
      se += ex;
      o = fmaf(ex, val[s][j], o);
    }
    const float ex = expf(lg - mx);
    se += ex;
    o = fmaf(ex, p.v_glob[(size_t)b * D + d], o);
    p.out[((size_t)b * p.Nq + n) * D + d] = o / se;
  }
  }
}

template <int RT>
cudaError_t launch_bcast(const Params& p, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_bcast_kernel<RT, 0, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  weights_in_out_kernel<0><<<264, 256, 0, stream>>>(p, 4 * p.nx, const_cast<float*>(p.wt));
  glob_logits_kernel<0><<<p.B, kThreads, 0, stream>>>(p);
  const dim3 grid((p.Nq + p.ny - 1) / p.ny, p.B);
  attn_bcast_kernel<RT, 0, 0><<<grid, p.nx * p.ny, bcast_smem_bytes(p.nx, p.ny), stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core broadcast path: the weights in the engine's order, the
// global logits once per batch item, then one block an SM (two at NWG = 2)
// running row tiles until they are done.
template <int NW, int NWG>
cudaError_t launch_bcast_tc(const Params& p, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  static int sms[kMaxDevices];
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bcast_kernel<0, NW, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const int np = 8 * NW * NWG;
  const size_t n = (size_t)6 * rows::pad8(p.D) * np;
  const int blocks = (int)((n + 255) / 256 < 264 ? (n + 255) / 256 : 264);
  weights_in_out_kernel<1><<<blocks, 256, 0, stream>>>(p, np, const_cast<float*>(p.wt));
  glob_logits_kernel<0><<<p.B, kThreads, 0, stream>>>(p);
  const int tq = rows::kRows / p.k;
  const long long tiles = (long long)p.B * ((p.Nq + tq - 1) / tq);
  const long long resident = (long long)(NWG == 2 ? 2 : 1) * sms[device];
  const int grid = (int)(tiles < resident ? tiles : resident);
  attn_bcast_kernel<0, NW, NWG><<<grid, 128 * NWG + 32, bcast_tc_smem_bytes(p.D), stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bcast_tc(const Params& p, int device, cudaStream_t s) {
  switch (tc_cols(p.D)) {
    case 64: return launch_bcast_tc<4, 2>(p, device, s);
    case 128: return launch_bcast_tc<8, 2>(p, device, s);
    case 160: return launch_bcast_tc<5, 4>(p, device, s);
    case 200: return launch_bcast_tc<5, 5>(p, device, s);
    default: return launch_bcast_tc<8, 4>(p, device, s);
  }
}

// The float32 attention kernels: the broadcast path or the row path by D.
cudaError_t launch_f32(const Params& p, bool bcast, int device, cudaStream_t s) {
  if (bcast) return p.k == 7 ? launch_bcast<7>(p, device, s) : launch_bcast<8>(p, device, s);
  switch ((p.D + kNX - 1) / kNX) {
    case 1: return launch_attention<1>(p, device, s);
    case 2: return launch_attention<2>(p, device, s);
    case 3: return launch_attention<3>(p, device, s);
    default: return launch_attention<4>(p, device, s);
  }
}


// ---- the narrow-operand mode on the tensor cores (rows_mma16.cuh) -----------

// The per-channel slot softmax of two queries (logits l, values v, S <= SM
// slots at pitch P; a global slot's logit lg and value vg last where glob)
// -> o1, o2.  Straight-line code: every slot read of both queries goes out
// before the exps; a padded slot's exp is 0, so the sums keep slot order's
// bits.  Slots are read SM / 8 chunks of 8 at a time for SM > 8.
template <int SM>
__device__ __forceinline__ void slot_softmax2(const float* l1, const float* v1, const float* l2,
                                              const float* v2, int S, int P, bool glob, float lg,
                                              float vg, float& o1, float& o2) {
  constexpr int kChunk = SM < 8 ? SM : 8;
  const float ninf = __int_as_float(0xff800000);
  float m1 = glob ? lg : ninf, m2 = m1;
#pragma unroll
  for (int s0 = 0; s0 < SM; s0 += kChunk) {
    if (s0 >= S) break;
    float x1[kChunk], x2[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int s = min(s0 + i, S - 1);
      x1[i] = l1[s * P], x2[i] = l2[s * P];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) m1 = fmaxf(m1, x1[i]), m2 = fmaxf(m2, x2[i]);
  }
  float se1 = 0.0f, se2 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int s0 = 0; s0 < SM; s0 += kChunk) {
    if (s0 >= S) break;
    float x1[kChunk], x2[kChunk], y1[kChunk], y2[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool in = s0 + i < S;
      const int s = min(s0 + i, S - 1);
      x1[i] = in ? l1[s * P] : ninf, x2[i] = in ? l2[s * P] : ninf;
      y1[i] = v1[s * P], y2[i] = v2[s * P];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float e1 = expf(x1[i] - m1), e2 = expf(x2[i] - m2);
      se1 += e1, se2 += e2;
      a1 = fmaf(e1, y1[i], a1), a2 = fmaf(e2, y2[i], a2);
    }
  }
  if (glob) {
    const float e1 = expf(lg - m1), e2 = expf(lg - m2);
    se1 += e1, se2 += e2;
    a1 = fmaf(e1, vg, a1), a2 = fmaf(e2, vg, a2);
  }
  o1 = a1 / se1, o2 = a2 / se2;
}

// Block (blockIdx.x, b = blockIdx.y) owns the TQ = R / S queries from
// blockIdx.x TQ of batch item b, row r = t S + s for query t and slot s
// (S = k, plus the global slot's row unless its logits come from
// glob_logits_kernel); rows TQ S .. R - 1 are padding that no output reads.
// The passes over rows outside the products keep a column (pair) with its
// thread, so its weights, biases and broadcast operands load once, and run
// its rows a few at a time, so their gathers are in flight together.
template <int NW>
__global__ void __launch_bounds__(mma16::kMaxThreads, 2) attn_mma16_kernel(const Params p) {
  constexpr int R = mma16::kRows;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int D = p.D, M = p.M, k = p.k, P = mma16::tile_pitch(D), PA = mma16::act_pitch(D);
  const bool glob_row = p.k_glob != nullptr && p.glog == nullptr;
  const int S = k + glob_row, TQ = R / S;
  uint16_t* act = reinterpret_cast<uint16_t*>(base);  // (R, PA) 16-bit MLP inputs
  uint2* ring = reinterpret_cast<uint2*>(base + mma16::act_bytes(D));  // weight fragments
  float* logits = reinterpret_cast<float*>(base);  // (R, P), over both after the products
  float* vals = reinterpret_cast<float*>(base + mma16::region_bytes(D));  // (R, P) values
  float* dxs = vals + R * P;                       // (R, 4) position deltas
  int* nbr = reinterpret_cast<int*>(dxs + 4 * R);  // (R) kv index per row
  const uint2* frag = p.frag;
  const size_t wstride = mma16::frag_elems(D) / 4;  // uint2s of one weight
  const int b = blockIdx.y, t0 = blockIdx.x * TQ, tid = threadIdx.x, nthr = blockDim.x;
  const float* kv = p.kv_xyz + (size_t)b * M * 3;

  // ---- neighbours and position deltas (the rounded fc_delta input) ---------
  for (int r = tid; r < R; r += nthr) {
    const int t = r / S, s = r - t * S, n = t0 + t;
    const bool nb = t < TQ && s < k && n < p.Nq;
    const int j = nb ? p.idx[((size_t)b * p.Nq + n) * k + s] : 0;
    nbr[r] = j;
    const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? n : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dxs[r * 4 + c] = narrow<NW>(nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f);
  }
  __syncthreads();

  // ---- fc_delta layer 0: f32 chains, stored as 16-bit pairs; zero pad ------
  {
    const int pairs = mma16::pad16(D) / 2, step = nthr / pairs, c = tid % pairs;
    if (tid < step * pairs) {
      float w[2][3], b0[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = min(2 * c + i, D - 1);
#pragma unroll
        for (int e = 0; e < 3; ++e) w[i][e] = narrow<NW>(__ldg(p.dw0 + 3 * d + e));
        b0[i] = __ldg(p.db0 + d);
      }
#pragma unroll 4
      for (int r = tid / pairs; r < R; r += step) {
        const float4 dx = *reinterpret_cast<const float4*>(dxs + r * 4);
        float h[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          h[i] = 2 * c + i < D
                     ? fmaxf(fmaf(dx.x, w[i][0], fmaf(dx.y, w[i][1], fmaf(dx.z, w[i][2], b0[i]))), 0.0f)
                     : 0.0f;
        *reinterpret_cast<uint32_t*>(act + r * PA + 2 * c) = mma16::pack2<NW>(h[0], h[1]);
      }
    }
  }

  // ---- fc_delta layer 1 -> pos (into the values' rows) ----------------------
  float acc[mma16::kMT][mma16::kNT][4];
  mma16::rows_mma16<NW>(act, frag, D, ring, acc);
  mma16::for_each_pair(D, acc, [&](int r, int c, float a0, float a1) {
    const float b0 = c < D ? __ldg(p.db1 + c) : 0.0f, b1 = c + 1 < D ? __ldg(p.db1 + c + 1) : 0.0f;
    *reinterpret_cast<float2*>(vals + r * P + c) = make_float2(a0 + b0, a1 + b1);
  });
  __syncthreads();

  // ---- fc_gamma's input and the values: u = (q - K[n]) + pos, value
  // V[n] + pos (V rounded unless it is a projection); the global slot's
  // row u = q - k_glob, value v_glob.  kBatch rows at a time, their loads in
  // straight-line code before any of their stores, so they go out together;
  // at an even D (and 8-byte aligned rows) each operand's column pair is one
  // 8-byte load.
  if (p.q != nullptr) {
    constexpr int kBatch = 4;
    const int pairs = mma16::pad8(D) / 2, step = nthr / pairs, c = tid % pairs;
    if (tid < step * pairs) {
      const int d0 = min(2 * c, D - 1), d1 = min(2 * c + 1, D - 1);
      const float* qb = p.q + b * p.q_sb;
      const float kg0 = p.k_glob ? __ldg(p.k_glob + (size_t)b * D + d0) : 0.0f;
      const float kg1 = p.k_glob ? __ldg(p.k_glob + (size_t)b * D + d1) : 0.0f;
      const float vg0 = p.k_glob ? __ldg(p.v_glob + (size_t)b * D + d0) : 0.0f;
      const float vg1 = p.k_glob ? __ldg(p.v_glob + (size_t)b * D + d1) : 0.0f;
      auto rows = [&](auto even) {
        // the column pair (d0, d1) of a row: one float2 at an even D (pad
        // columns read the row's last pair, which no store keeps)
        auto ld2 = [&](const float* row) {
          if constexpr (decltype(even)::value)
            return __ldg(reinterpret_cast<const float2*>(row) + min(c, D / 2 - 1));
          else
            return make_float2(__ldg(row + d0), __ldg(row + d1));
        };
        for (int r0 = tid / pairs; r0 < R; r0 += kBatch * step) {
          float2 q2[kBatch], k2[kBatch], v2[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int r = min(r0 + i * step, R - 1), t = r / S;
            const size_t row = ((size_t)b * M + nbr[r]) * D;
            q2[i] = ld2(qb + (long long)min(t0 + t, p.Nq - 1) * p.q_sn);
            k2[i] = ld2(p.K + row);
            v2[i] = ld2(p.V + row);
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int r = r0 + i * step;
            if (r < R) {
              const bool nb = r % S < k;
              const float2 pos = *reinterpret_cast<const float2*>(vals + r * P + 2 * c);
              float w0 = v2[i].x, w1 = v2[i].y;
              if (p.round_v) w0 = narrow<NW>(w0), w1 = narrow<NW>(w1);
              const float u0 = nb ? (q2[i].x - k2[i].x) + pos.x : q2[i].x - kg0;
              const float u1 = nb ? (q2[i].y - k2[i].y) + pos.y : q2[i].y - kg1;
              *reinterpret_cast<uint32_t*>(act + r * PA + 2 * c) =
                  mma16::pack2<NW>(2 * c < D ? u0 : 0.0f, 2 * c + 1 < D ? u1 : 0.0f);
              *reinterpret_cast<float2*>(vals + r * P + 2 * c) =
                  make_float2(nb ? w0 + pos.x : vg0, nb ? w1 + pos.y : vg1);
            }
          }
        }
      };
      const auto aligned = [](const float* x) { return ((uintptr_t)x & 7) == 0; };
      if (D % 2 == 0 && p.q_sb % 2 == 0 && p.q_sn % 2 == 0 && aligned(p.q) && aligned(p.K) &&
          aligned(p.V))
        rows(std::true_type{});
      else
        rows(std::false_type{});
    }
  } else {  // pos-only: u = value = pos
    mma16::for_each_pair(D, acc, [&](int r, int c, float, float) {
      const float2 pos = *reinterpret_cast<const float2*>(vals + r * P + c);
      *reinterpret_cast<uint32_t*>(act + r * PA + c) = mma16::pack2<NW>(pos.x, pos.y);
    });
  }

  // ---- fc_gamma -------------------------------------------------------------
  mma16::rows_mma16<NW>(act, frag + wstride, D, ring, acc);
  mma16::for_each_pair(D, acc, [&](int r, int c, float a0, float a1) {
    const float h0 = c < D ? fmaxf(a0 + __ldg(p.gb0 + c), 0.0f) : 0.0f;
    const float h1 = c + 1 < D ? fmaxf(a1 + __ldg(p.gb0 + c + 1), 0.0f) : 0.0f;
    *reinterpret_cast<uint32_t*>(act + r * PA + c) = mma16::pack2<NW>(h0, h1);
  });
  mma16::rows_mma16<NW>(act, frag + 2 * wstride, D, ring, acc);
  mma16::for_each_pair(D, acc, [&](int r, int c, float a0, float a1) {
    const float l0 = c < D ? a0 + __ldg(p.gb1 + c) : 0.0f;
    const float l1 = c + 1 < D ? a1 + __ldg(p.gb1 + c + 1) : 0.0f;
    *reinterpret_cast<float2*>(logits + r * P + c) = make_float2(l0, l1);
  });
  __syncthreads();

  // ---- per-channel softmax over the slots, a global slot last: thread tid
  // takes channel tid % D of queries tid / D, + nthr / D, ..., two at a time
  const int qstep = nthr / D, d = tid % D;
  if (tid >= qstep * D) return;
  const bool glob = p.glog != nullptr;
  const float lg = glob ? __ldg(p.glog + (size_t)b * D + d) : 0.0f;
  const float vg = glob ? __ldg(p.v_glob + (size_t)b * D + d) : 0.0f;
  const int tq = min(TQ, p.Nq - t0);  // queries of this block
  for (int t = tid / D; t < tq; t += 2 * qstep) {
    const int t2 = min(t + qstep, tq - 1);
    const float* l1 = logits + t * S * P + d;
    const float* l2 = logits + t2 * S * P + d;
    const float* v1 = vals + t * S * P + d;
    const float* v2 = vals + t2 * S * P + d;
    float o1, o2;
    if (S <= 8)
      slot_softmax2<8>(l1, v1, l2, v2, S, P, glob, lg, vg, o1, o2);
    else if (S <= 16)
      slot_softmax2<16>(l1, v1, l2, v2, S, P, glob, lg, vg, o1, o2);
    else
      slot_softmax2<32>(l1, v1, l2, v2, S, P, glob, lg, vg, o1, o2);
    p.out[((size_t)b * p.Nq + t0 + t) * D + d] = o1;
    if (t + qstep < tq) p.out[((size_t)b * p.Nq + t0 + t2) * D + d] = o2;
  }
}

// The narrow mode's kernels (NW: 1 bfloat16, 2 float16): the weights' layout,
// a broadcast query's global logits, the rows.
template <int NW>
cudaError_t launch_narrow(const Params& p, uint2* frag, int device, cudaStream_t s) {
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_mma16_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, mma16::kMaxSmem);
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const size_t n = 3 * mma16::frag_elems(p.D) / 4;
  const int blocks = (int)((n + 255) / 256 < 264 ? (n + 255) / 256 : 264);
  mma16::weight_frags16_kernel<NW><<<blocks, 256, 0, s>>>(p.dw1, p.gw0, p.gw1, p.D, frag);
  if (p.glog) glob_logits_kernel<NW><<<p.B, kThreads, 0, s>>>(p);
  const int tq = mma16::kRows / (p.k + (p.k_glob && !p.glog ? 1 : 0));
  const dim3 grid((p.Nq + tq - 1) / tq, p.B);
  attn_mma16_kernel<NW><<<grid, 32 * mma16::warps(p.D), mma16::smem_bytes(p.D), s>>>(p);
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

// Whether a float32 call takes the broadcast path (attn_bcast_kernel).
int nsdp_attention_bcast(int has_glob, long long q_sn, int k) {
  return has_glob && q_sn == 0 && k <= kBcastKMax;
}

// Shared memory of the narrow mode's attn_mma16_kernel at D.
long long nsdp_attention_narrow_smem(int D) { return (long long)mma16::smem_bytes(D); }

// The tensor-core broadcast kernel at D: its shared memory, and the columns
// Np of its weights' layout (wt holds 6 pad8(D) Np floats).
long long nsdp_attention_bcast_tc_smem(int D) { return (long long)bcast_tc_smem_bytes(D); }
int nsdp_attention_bcast_tc_cols(int D) { return tc_cols(D); }

// idx: (B, Nq, k) int32 scratch for the neighbour indices, written here.
// dw0, dw1, gw0, gw1: (out, in) float32 weights, contiguous.  mode: 0
// float32, 1 bfloat16, 2 float16 operands of the MLPs; 3 float32 with the
// broadcast path on the tensor cores (3xTF32), for a call no backward
// follows.
// mode 0: where the query is broadcast (q_sn == 0) with a global slot and
// k <= 8 (the broadcast path, nsdp_attention_bcast), glog is (B, D) and wt
// (3, D, 4 ceil(D / 4)) float32 scratch on the device, else both are null;
// frag is null and round_v 0.
// mode 3: only the broadcast path; glog as mode 0's, wt 6 pad8(D) Np float32
// scratch (Np = nsdp_attention_bcast_tc_cols(D)); frag null, round_v 0.
// mode 1, 2: frag is 3 frag_elems(D) 16-bit values of scratch
// (rows_mma16.cuh), glog (B, D) float32 scratch where the query is broadcast
// with a global slot, else null; wt is null; the kernels round the weights,
// and V where round_v (not a projection's V).
int nsdp_fused_attention(
    const float* xyz_q, const float* kv_xyz, const float* penalty,
    const float* q, long long q_sb, long long q_sn,
    const float* K, const float* V, const float* k_glob, const float* v_glob,
    const float* dw0, const float* db0, const float* dw1, const float* db1,
    const float* gw0, const float* gb0, const float* gw1, const float* gb1,
    int* idx, float* out, float* glog, float* wt, void* frag, int B, int Nq, int M, int D,
    int k, int mode, int round_v, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || D < 1 || D > kDMax || k < 1 || k > kKMax || k > M ||
      k + (k_glob ? 1 : 0) > kRows || mode < 0 || mode > 3 || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if ((q == nullptr) != (K == nullptr) || (K == nullptr) != (V == nullptr) ||
      (k_glob == nullptr) != (v_glob == nullptr) || (k_glob != nullptr && q == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 || mode == 3) {
    const bool bcast = nsdp_attention_bcast(k_glob != nullptr, q_sn, k);
    if ((glog != nullptr) != bcast || (wt != nullptr) != bcast || frag != nullptr || round_v ||
        (mode == 3 && !bcast))
      return (int)cudaErrorInvalidValue;
  } else {
    const bool once = k_glob != nullptr && q_sn == 0;
    if ((glog != nullptr) != once || wt != nullptr || frag == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)failed(err);
  const cudaStream_t s = (cudaStream_t)stream;
  err = launch_knn(xyz_q, kv_xyz, penalty, B, Nq, M, k, idx, s);
  if (err != cudaSuccess) return (int)err;
  const int nx = (D + 3) / 4;
  int ny = kBcastThreads / nx < kBcastQueries ? kBcastThreads / nx : kBcastQueries;
  while (ny > 1 && bcast_smem_bytes(nx, ny) > (size_t)kMaxSmem) --ny;
  const Params p{xyz_q, kv_xyz, idx, q, q_sb, q_sn, K, V, k_glob, v_glob,
                 dw0, db0, dw1, db1, gw0, gb0, gw1, gb1, out, glog, wt,
                 static_cast<const uint2*>(frag), B, Nq, M, D, k, nx, ny, round_v};
  if (mode == 3) return (int)launch_bcast_tc(p, device, s);
  if (mode == 0) return (int)launch_f32(p, glog != nullptr, device, s);
  uint2* f = static_cast<uint2*>(frag);
  return (int)(mode == 1 ? launch_narrow<1>(p, f, device, s) : launch_narrow<2>(p, f, device, s));
}

}  // extern "C"
