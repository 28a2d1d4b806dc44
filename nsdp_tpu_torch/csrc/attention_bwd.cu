// Fused kNN vector attention, backward, on Hopper (sm_90a).
//
// Replaces the TPU kernel nsdp_tpu/ops/attention_pallas.py::_attn_bwd_kernel
// (driven by _fused_attention_bwd, under the custom VJPs knn_vector_attention
// and knn_vector_attention_proj).  From the forward's (B, Nq, k) neighbour
// indices and the output gradient g it computes the gradients of the
// attention (attention.cu) with respect to xyz_q, kv_xyz, q, K, V, k_glob,
// v_glob and the eight fc_delta / fc_gamma weights and biases.  The
// selection is a constant.  Per (query, slot) row, recomputed from idx:
//   dx = x_q - x_kv[n] (f32, as the forward), hd = relu(dx w0d + b0d),
//   pos = hd w1d + b1d, u = q - K[n] + pos (pos-only: pos; global slot:
//   q - k_glob), hg = relu(u w0g + b0g), logits = hg w1g + b1g,
//   value = V[n] + pos (pos-only: pos; global: v_glob);
// per channel a = softmax over the slots, inner = sum_s a_s g value_s, and
//   dlogits = a (g value - inner), dvalue = g a,
//   dz_gamma = (dlogits w1g^T) [hg > 0], du = dz_gamma w0g^T,
//   dpos = du + dvalue (0 on the global slot),
//   dz_delta = (dpos w1d^T) [hd > 0], ddx = dz_delta w0d^T;
// then dq = sum_s du, dK[n] -= du, dV[n] += dvalue, d kv_xyz[n] -= ddx,
// d xyz_q = sum_s ddx, dk_glob = -sum du_glob, dv_glob = sum g a_glob, and
// the weight gradients X^T Y over all rows with (X, Y) = (dx, dz_delta),
// (hd, dpos), (u, dz_gamma), (hg, dlogits); each bias gradient is the
// column sum of its Y.
// The plain PyTorch version is ops/attention.py::fused_vector_attention_bwd_plain.
//
// What bounds it on an H100: operations.  Per row the three D x D forward
// products are recomputed and three D x D input-gradient products and three
// D x D weight-gradient products added: ~18 D^2 flops against a few D-wide
// rows of compulsory traffic.  The TPU kernel's devices (saved residuals,
// one-hot scatter matmuls, VMEM-resident weight-gradient accumulators) do
// not carry over; on the card:
//   * bwd_rows_kernel does everything per row.  A block owns 32 rows (all
//     slots of 32 / S queries, so the slot softmax and the per-query sums
//     stay in the block) and runs the six products on the CUDA cores with
//     rows_gemm.cuh, keeping four transposed D x 36 activation buffers in
//     shared memory, each reused as the pass goes (hidden -> its masked
//     gradient, logits -> dlogits -> du, values -> dvalue -> dpos).  The kv
//     gradients are scatter-added with f64 atomics into f64 buffers: their
//     order varies from run to run, but their rounding stays far below the
//     f32 products' (the decoder's 100 anchors each take thousands of
//     adds); the global slot's sums over all queries take one f64 atomic
//     per channel and block.
//   * The D x D weight gradients do not fit a block (four of them are 1 MB
//     at D = 256, against 227 KB of shared memory), so bwd_rows_kernel
//     writes the operand rows X and Y of each to a workspace
//     (7 D + 3 floats per row), and wgrad_kernel reduces X^T Y over the
//     rows: 64 x 64 output tiles, split over row chunks into partials that
//     wgrad_sum_kernel adds in a fixed order (deterministic).  A column of
//     ones beside X makes the bias gradient the tile's last row.

#include <cuda_runtime.h>

#include <cstdint>

#include "rows_gemm.cuh"

namespace {

using namespace rows;

constexpr int kKMax = 32;  // largest k
constexpr int kDMax = 256; // largest channel width
constexpr int kWT = 64;    // output tile edge of the weight-gradient reduction
constexpr int kWK = 16;    // rows per staged step of the reduction

// Workspace arrays, each (R, D) with R = B * Nq * S rows in (b, query, slot)
// order, followed by the (R, 3) position deltas.
enum { kWsHd, kWsDpos, kWsU, kWsDzg, kWsHg, kWsDl, kWsDzd, kWsArrays };

struct Params {
  const float* xyz_q;    // (B, Nq, 3)
  const float* kv_xyz;   // (B, M, 3)
  const int* idx;        // (B, Nq, k)
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
  const float* g;        // (B, Nq, D) output gradient
  float* dxyz_q;         // (B, Nq, 3) written
  double* dkv_xyz;       // (B, M, 3) zeroed, scatter-added
  float* dq;             // (B, Nq, D) written, or null (pos-only)
  double* dK;            // (B, M, D) zeroed, scatter-added, or null
  double* dV;            // (B, M, D) zeroed, scatter-added, or null
  double* dglob;         // (B, 2, D) zeroed: [dk_glob; dv_glob], or null
  float* ws;             // workspace
  int B, Nq, M, D, k;
};

// sum += x with Kahan's compensation c (no fast-math: the order is kept).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// Write a thread's kRT rows of column d to workspace array a (rows past the
// end, wrow < 0, are skipped).
__device__ __forceinline__ void put_rows(float* ws, size_t RD, int a, const int* wrow, int d,
                                         int D, const float (&v)[kRT]) {
  const int r0 = (threadIdx.x / kNX) * kRT;
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int w = wrow[r0 + i];
    if (w >= 0) ws[a * RD + (size_t)w * D + d] = v[i];
  }
}

template <int CJ>
__global__ void __launch_bounds__(kThreads, CJ <= 2 ? 2 : 1) bwd_rows_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, M = p.M, k = p.k;
  const bool has_glob = p.k_glob != nullptr, pos_only = p.q == nullptr;
  const int S = k + (has_glob ? 1 : 0);      // slots per query
  const int TQ = kRows / S;                  // queries per block
  const int R = TQ * S;                      // rows in use
  float* hd = smem;                          // fc_delta hidden -> dz_delta
  float* ub = hd + D * kRP;                  // u -> logits -> a, dlogits -> du
  float* vb = ub + D * kRP;                  // values -> dvalue -> dpos
  float* hg = vb + D * kRP;                  // fc_gamma hidden -> dz_gamma
  float* ws = hg + D * kRP;                  // (2, kKC, P) weight tiles
  float* dxs = ws + 2 * kKC * tile_pitch(D); // (kRows, 4) position delta, then ddx
  int* nbr = reinterpret_cast<int*>(dxs + kRows * 4);  // (kRows) kv index per row
  int* wrow = nbr + kRows;                   // (kRows) workspace row, -1 past the end

  const int b = blockIdx.y, t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, tx = tid % kNX;
  const float* kv = p.kv_xyz + (size_t)b * M * 3;
  const size_t RD = (size_t)p.B * p.Nq * S * D;  // floats of one workspace array
  float* const wsd = p.ws;

  // ---- neighbours and position deltas --------------------------------------
  for (int r = tid; r < kRows; r += kThreads) {
    const int t = r / S, s = r - t * S, n = t0 + t;
    const bool valid = r < R && n < p.Nq;
    const bool nb = valid && s < k;
    const int j = nb ? p.idx[((size_t)b * p.Nq + n) * k + s] : 0;
    nbr[r] = j;
    const int w = valid ? (int)(((size_t)b * p.Nq + n) * S + s) : -1;
    wrow[r] = w;
    const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? n : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dx = nb ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
      dxs[r * 4 + c] = dx;
      if (valid) wsd[kWsArrays * RD + (size_t)w * 3 + c] = dx;
    }
  }
  __syncthreads();

  // ---- forward recomputation: fc_delta ----------------------------------------
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float w0 = p.dw0[3 * d], w1 = p.dw0[3 * d + 1], w2 = p.dw0[3 * d + 2], b0 = p.db0[d];
    float h[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const float* dx = dxs + ((tid / kNX) * kRT + i) * 4;
      h[i] = fmaxf(fmaf(dx[0], w0, fmaf(dx[1], w1, fmaf(dx[2], w2, b0))), 0.0f);
    }
    store_rows(hd, d, h);
    put_rows(wsd, RD, kWsHd, wrow, d, D, h);
  }
  float acc[kRT][CJ];
  rows_gemm<CJ, false>(hd, p.dw1, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b1 = p.db1[d];
    float u[kRT], v[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = (tid / kNX) * kRT + i, t = r / S, s = r - t * S;
      const float pos = acc[i][j] + b1;
      u[i] = pos;
      v[i] = pos;
      if (r >= R || pos_only) continue;
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
    store_rows(ub, d, u);
    store_rows(vb, d, v);
    put_rows(wsd, RD, kWsU, wrow, d, D, u);
  }

  // ---- forward recomputation: fc_gamma ----------------------------------------
  rows_gemm<CJ, false>(ub, p.gw0, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b0 = p.gb0[d];
    float h[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) h[i] = fmaxf(acc[i][j] + b0, 0.0f);
    store_rows(hg, d, h);
    put_rows(wsd, RD, kWsHg, wrow, d, D, h);
  }
  rows_gemm<CJ, false>(hg, p.gw1, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    const float b1 = p.gb1[d];
    float l[kRT];
#pragma unroll
    for (int i = 0; i < kRT; ++i) l[i] = acc[i][j] + b1;
    store_rows(ub, d, l);
  }
  __syncthreads();

  // ---- slot softmax and its backward: dlogits, dvalue -------------------------
  for (int e = tid; e < TQ * D; e += kThreads) {
    const int t = e / D, d = e - t * D, n = t0 + t;
    if (n >= p.Nq) continue;
    float* l = ub + d * kRP + t * S;
    float* v = vb + d * kRP + t * S;
    const float gv = p.g[((size_t)b * p.Nq + n) * D + d];
    float m = l[0];
    int s_max = 0;
    for (int s = 1; s < S; ++s)
      if (l[s] > m) {
        m = l[s];
        s_max = s;
      }
    float se = 0.0f;
    for (int s = 0; s < S; ++s) {
      l[s] = expf(l[s] - m);
      se += l[s];
    }
    float inner = 0.0f;
    for (int s = 0; s < S; ++s) {
      l[s] = l[s] / se;
      inner += l[s] * (gv * v[s]);
    }
    float residual = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float a = l[s];
      l[s] = a * (gv * v[s] - inner);
      residual += l[s];
      v[s] = gv * a;
    }
    // The slot sum of dlogits is zero; its rounding residual, shared by the
    // slots, would bias every weight gradient.  Take it off the largest
    // logit's slot, as autograd through the softmax's max shift does.
    l[s_max] -= residual;
    for (int s = 0; s < S; ++s) wsd[kWsDl * RD + (size_t)wrow[t * S + s] * D + d] = l[s];
  }
  __syncthreads();
  if (has_glob) {  // dv_glob: one atomic per channel and block
    for (int d = tid; d < D; d += kThreads) {
      double sum = 0.0;
      for (int t = 0; t < TQ && t0 + t < p.Nq; ++t) sum += vb[d * kRP + t * S + k];
      atomicAdd(p.dglob + ((size_t)b * 2 + 1) * D + d, sum);
    }
  }

  // ---- fc_gamma backward: dz_gamma, du ----------------------------------------
  rows_gemm<CJ, true>(ub, p.gw1, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    float h[kRT];
    load_rows(hg, d, h);
#pragma unroll
    for (int i = 0; i < kRT; ++i) h[i] = h[i] > 0.0f ? acc[i][j] : 0.0f;
    store_rows(hg, d, h);
    put_rows(wsd, RD, kWsDzg, wrow, d, D, h);
  }
  rows_gemm<CJ, true>(hg, p.gw0, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    float dv[kRT], du[kRT], dp[kRT];
    load_rows(vb, d, dv);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = (tid / kNX) * kRT + i, s = r % S;
      const bool nb = wrow[r] >= 0 && s < k;
      du[i] = acc[i][j];
      dp[i] = nb ? du[i] + dv[i] : 0.0f;
      if (nb && !pos_only) {
        const size_t row = ((size_t)b * M + nbr[r]) * D + d;
        atomicAdd(p.dK + row, (double)-du[i]);
        atomicAdd(p.dV + row, (double)dv[i]);
      }
    }
    store_rows(ub, d, du);
    store_rows(vb, d, dp);
    put_rows(wsd, RD, kWsDpos, wrow, d, D, dp);
  }
  __syncthreads();
  if (!pos_only) {  // dq = sum over the query's slots of du
    for (int e = tid; e < TQ * D; e += kThreads) {
      const int t = e / D, d = e - t * D, n = t0 + t;
      if (n >= p.Nq) continue;
      const float* du = ub + d * kRP + t * S;
      float sum = 0.0f;
      for (int s = 0; s < S; ++s) sum += du[s];
      p.dq[((size_t)b * p.Nq + n) * D + d] = sum;
    }
  }
  if (has_glob) {  // dk_glob = -sum du over the global slots
    for (int d = tid; d < D; d += kThreads) {
      double sum = 0.0;
      for (int t = 0; t < TQ && t0 + t < p.Nq; ++t) sum += ub[d * kRP + t * S + k];
      atomicAdd(p.dglob + (size_t)b * 2 * D + d, -sum);
    }
  }

  // ---- fc_delta backward: dz_delta, ddx ---------------------------------------
  rows_gemm<CJ, true>(vb, p.dw1, D, ws, acc);
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    const int d = tx + j * kNX;
    if (d >= D) continue;
    float h[kRT];
    load_rows(hd, d, h);
#pragma unroll
    for (int i = 0; i < kRT; ++i) h[i] = h[i] > 0.0f ? acc[i][j] : 0.0f;
    store_rows(hd, d, h);
    put_rows(wsd, RD, kWsDzd, wrow, d, D, h);
  }
  __syncthreads();
  for (int e = tid; e < kRows * 3; e += kThreads) {
    const int r = e / 3, c = e - r * 3, s = r % S;
    const bool nb = wrow[r] >= 0 && s < k;
    float sum = 0.0f;
    if (nb)
      for (int d = 0; d < D; ++d) sum = fmaf(hd[d * kRP + r], p.dw0[3 * d + c], sum);
    dxs[r * 4 + c] = sum;
    if (nb) atomicAdd(p.dkv_xyz + ((size_t)b * M + nbr[r]) * 3 + c, (double)-sum);
  }
  __syncthreads();
  for (int e = tid; e < TQ * 3; e += kThreads) {
    const int t = e / 3, c = e - t * 3, n = t0 + t;
    if (n >= p.Nq) continue;
    float sum = 0.0f;
    for (int s = 0; s < k; ++s) sum += dxs[(t * S + s) * 4 + c];
    p.dxyz_q[((size_t)b * p.Nq + n) * 3 + c] = sum;
  }
}

// partial[z] = [X | 1]^T Y over rows [z * chunk, (z + 1) * chunk): the
// (Dx + 1, Dy) tile (blockIdx.x, blockIdx.y) of 64 x 64.  Each thread owns a
// 4 x 4 block of the output.  A sum runs over up to ~10^6 rows, so each
// 16-row step's products are summed apart and added to the running sum with
// Kahan's compensation: the result keeps the accuracy of a blocked product.
__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const float* __restrict__ X, int Dx, const float* __restrict__ Y, int Dy, int R, int chunk,
    float* __restrict__ partial) {
  __shared__ __align__(16) float xs[kWK][kWT];
  __shared__ __align__(16) float ys[kWK][kWT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * kWT, j0 = blockIdx.y * kWT;
  const int r_begin = blockIdx.z * chunk, r_end = min(R, r_begin + chunk);
  float acc[4][4], comp[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = comp[u][v] = 0.0f;
  for (int r0 = r_begin; r0 < r_end; r0 += kWK) {
    for (int e = tid; e < kWK * kWT; e += kThreads) {
      const int rr = e / kWT, c = e - rr * kWT, r = r0 + rr, i = i0 + c, j = j0 + c;
      const bool live = r < r_end;
      xs[rr][c] = live && i < Dx ? X[(size_t)r * Dx + i] : (live && i == Dx ? 1.0f : 0.0f);
      ys[rr][c] = live && j < Dy ? Y[(size_t)r * Dy + j] : 0.0f;
    }
    __syncthreads();
    float step[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) step[u][v] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kWK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ys[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) step[u][v] = fmaf(av[u], bw[v], step[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) kahan_add(acc[u][v], comp[u][v], step[u][v]);
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ty * 4 + u, j = j0 + tx * 4 + v;
      if (i <= Dx && j < Dy) partial[((size_t)blockIdx.z * (Dx + 1) + i) * Dy + j] = acc[u][v];
    }
}

// out[e] = sum_z partial[z][e], in a fixed order, compensated.
__global__ void wgrad_sum_kernel(const float* __restrict__ partial, int splits, int n,
                                 float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f, comp = 0.0f;
  for (int z = 0; z < splits; ++z) kahan_add(sum, comp, partial[(size_t)z * n + e]);
  out[e] = sum;
}

size_t rows_smem_bytes(int D) {
  return (size_t)(4 * D * kRP + 2 * kKC * tile_pitch(D) + 4 * kRows) * sizeof(float) +
         2 * kRows * sizeof(int);
}

template <int CJ>
cudaError_t launch_rows(const Params& p, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_rows_kernel<CJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_smem_bytes(CJ * kNX));
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const int tq = kRows / (p.k + (p.k_glob ? 1 : 0));
  const dim3 grid((p.Nq + tq - 1) / tq, p.B);
  bwd_rows_kernel<CJ><<<grid, kThreads, rows_smem_bytes(p.D), stream>>>(p);
  return cudaGetLastError();
}

// out (Dx + 1, Dy) = [X | 1]^T Y over R rows: the weight gradient and, in its
// last row, the bias gradient.
cudaError_t weight_gradient(const float* X, int Dx, const float* Y, int Dy, int R, int splits,
                            float* partial, float* out, cudaStream_t stream) {
  const int chunk = ((R + splits - 1) / splits + kWK - 1) / kWK * kWK;
  const dim3 grid((Dx + 1 + kWT - 1) / kWT, (Dy + kWT - 1) / kWT, splits);
  wgrad_kernel<<<grid, kThreads, 0, stream>>>(X, Dx, Y, Dy, R, chunk, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (Dx + 1) * Dy;
  wgrad_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, splits, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// dw0, dw1, gw0, gw1: (out, in) weights, contiguous.  dkv_xyz, dK, dV and
// dglob are float64 and must be zeroed; ws holds B * Nq * S * (7 D + 3) floats and partial
// splits * (D + 1) * D.  wgrads (3 D + 7, D) receives, in the (in, out)
// layout, [ddw0 (3 rows) | ddb0 | ddw1 (D) | ddb1 | dgw0 (D) | dgb0 |
// dgw1 (D) | dgb1].
int nsdp_fused_attention_bwd(
    const float* xyz_q, const float* kv_xyz, const int* idx,
    const float* q, long long q_sb, long long q_sn,
    const float* K, const float* V, const float* k_glob, const float* v_glob,
    const float* dw0, const float* db0, const float* dw1, const float* db1,
    const float* gw0, const float* gb0, const float* gw1, const float* gb1,
    const float* g, float* dxyz_q, double* dkv_xyz, float* dq, double* dK, double* dV,
    double* dglob, float* ws, float* partial, float* wgrads,
    int B, int Nq, int M, int D, int k, int splits, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || D < 1 || D > kDMax || k < 1 || k > kKMax || k > M ||
      k + (k_glob ? 1 : 0) > kRows || splits < 1 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const bool featured = q != nullptr;
  if ((K != nullptr) != featured || (V != nullptr) != featured || (dq != nullptr) != featured ||
      (dK != nullptr) != featured || (dV != nullptr) != featured ||
      (k_glob == nullptr) != (v_glob == nullptr) || (k_glob != nullptr && !featured) ||
      (dglob != nullptr) != (k_glob != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)failed(err);
  const cudaStream_t s = (cudaStream_t)stream;
  const Params p{xyz_q, kv_xyz, idx, q, q_sb, q_sn, K, V, k_glob, v_glob,
                 dw0, db0, dw1, db1, gw0, gb0, gw1, gb1, g,
                 dxyz_q, dkv_xyz, dq, dK, dV, dglob, ws, B, Nq, M, D, k};
  switch ((D + kNX - 1) / kNX) {
    case 1: err = launch_rows<1>(p, device, s); break;
    case 2: err = launch_rows<2>(p, device, s); break;
    case 3: err = launch_rows<3>(p, device, s); break;
    default: err = launch_rows<4>(p, device, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int R = B * Nq * (k + (k_glob ? 1 : 0));
  const size_t RD = (size_t)R * D;
  const float* X[4] = {ws + kWsArrays * RD, ws + kWsHd * RD, ws + kWsU * RD, ws + kWsHg * RD};
  const float* Y[4] = {ws + kWsDzd * RD, ws + kWsDpos * RD, ws + kWsDzg * RD, ws + kWsDl * RD};
  const int Dx[4] = {3, D, D, D};
  float* out = wgrads;
  for (int w = 0; w < 4; ++w) {  // ddw0, ddw1, dgw0, dgw1 with their biases
    err = weight_gradient(X[w], Dx[w], Y[w], D, R, splits, partial, out, s);
    if (err != cudaSuccess) return (int)err;
    out += (size_t)(Dx[w] + 1) * D;
  }
  return 0;
}

}  // extern "C"
