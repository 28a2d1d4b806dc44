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
// not carry over; on the card, the products run on the tensor cores in
// 3xTF32 (rows_mma.cuh, wgmma), but for the two that decide the fc_gamma
// ReLU mask (rows_ffma, below):
//   * weight_frags_kernel lays the weights out once per call: the four
//     tensor-core products' in wgmma's K-major order, the two FFMA
//     products' as row-major B = w^T;
//   * bwd_rows_kernel does everything per row.  A block owns 64 rows, one
//     wgmma M (all slots of 64 / S queries, so the slot softmax and the
//     per-query sums stay in the block), and runs the six products, four on
//     the shared row-tile engine, with two row-major activation buffers in
//     shared memory reused as the pass goes (hidden -> u -> fc_gamma hidden
//     -> logits -> dlogits -> dz_gamma -> du; values -> dvalue -> dpos ->
//     dz_delta) and the two ReLU masks as bits in registers of each thread
//     (the engine gives a thread the same elements in every product).  Each
//     product's weight streams through one ring of slots, a bulk copy (the
//     TMA) a slot, staged once per 64 rows.  Up to D = 128 a block is two
//     warpgroups and two blocks share an SM (103.5 KB each at D = 120); above,
//     a second 64-row tile's activations would leave no room for the ring,
//     so one block of four warpgroups takes the SM (201.6 KB at D = 200,
//     211.5 KB at D = 256).
//     The kv gradients are scatter-added with f64 atomics into f64 buffers:
//     their order varies from run to run, but their rounding stays far
//     below the f32 products' (the decoder's 100 anchors each take
//     thousands of adds; compiled out, they saved ~0.2 ms of 24 at the
//     decoder); the global slot's sums over all queries take one f64 atomic
//     per channel and block.
//   * The D x D weight gradients do not fit a block (four of them are 1 MB
//     at D = 256, against 227 KB of shared memory), so bwd_rows_kernel
//     writes the operand rows X and Y of each to a workspace (rows of
//     pad8(D) floats, and 4 for the position delta), and one wgrad_kernel
//     launch reduces all four [X | 1]^T Y, then wgrad_sum_kernel adds its
//     per-split partials in a fixed order, compensated (deterministic; no
//     atomics).  Each D-wide reduction runs transposed, Y^T [X | 1], on
//     3xTF32 wgmma.m64nNk8: A = Y^T split in registers from staged rows, B =
//     [X | 1] (the ones column gives the bias row) split into hi and lo and
//     laid out K-major in shared memory per 32-row chunk, since tf32 wgmma
//     reads only K-major operands there.  A block is a producer warpgroup
//     (one thread stages each chunk of Y and X by two TMA boxes on a ring of
//     four slots; three warps split) and two consumer warpgroups (64 Y
//     columns each, N = 64-104 [X | 1] columns, two accumulator chains of
//     half N), which split their share of chunk i + 2 under chunk i's
//     products, issue in turn and chain a chunk's four k-steps in the
//     accumulators; chunk sums are added 16 at a time into the running sum.
//     The 4-wide [dx | 1] job runs in the same launch on the CUDA cores.
//     Row splits give one block an SM in one wave.  What bounds it: the SMs'
//     issue slots -- splitting B (~10 instructions an element on one warp a
//     sub-partition) and the consumers' own work around the products -- not
//     the tensor cores (a chunk ~2,200 cycles at the decoder against ~1,250
//     of tensor work) nor the bytes (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "rows_mma.cuh"

namespace {

using namespace rows;

constexpr int kKMax = 32;  // largest k, and most slots (k and the global slot)
constexpr int kDMax = 256; // largest channel width
// Workspace arrays, each (R, pad8(D)) with R = B * Nq * S rows in (b, query,
// slot) order, followed by the (R, 4) position deltas.
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
  const float* db1; const float* gb0; const float* gb1;  // (D)
  const float* dw1f; const float* gw0f;  // B = w^T row-major, for the FFMA products
  const float* gw1f;                   // engine order, for x w^T
  const float* gw1t; const float* gw0t; const float* dw1t;  // engine order, for dy w
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

// ---- float32 FFMA products: the two that decide the fc_gamma ReLU mask ----
//
// hd w1d^T and u w0g^T are summed on the CUDA cores, each element one fmaf
// chain over k in order from zero, as the f32 engine did: the ReLU decision
// hg > 0 then falls as that engine's did.  Under 3xTF32 these products met
// near-ties that the float32 plain version did not, and a flipped decision
// moves a gradient far beyond rounding (PERF.md).  A thread owns kFR rows
// and NT columns 64 apart; B = w^T (weight_frags_kernel's row-major copy)
// streams through the ring kFK rows a slot, one bulk copy each, and a
// thread reads 4 k of each of its rows as one 16-byte load (the same rows
// for the whole warp).
constexpr int kFX = 64;  // threads across the channels
constexpr int kFK = 16;  // B rows per slot

// acc[i][j] = sum_k x[(ty kFR + i) P + k] B[k][tx + 64 j], k ascending from
// zero; x row-major in shared memory (pitch act_pitch(D)), B pad8(D) x
// pad8(D) row-major in global memory, ring ring_floats(D) floats of shared
// memory (kStages slots and their mbarriers); kT threads, kFR = kRows /
// (kT / kFX).  Starts and ends with a barrier.
template <int kT, int kFR, int NT, int kStages>
__device__ __forceinline__ void rows_ffma(const float* x, const float* __restrict__ wt, int D,
                                          float* ring, float (&acc)[kFR][NT]) {
  const int tid = threadIdx.x, tx = tid % kFX, ty = tid / kFX;
  const int P = act_pitch(D), Dp = pad8(D), n_tiles = (D + kFK - 1) / kFK, slot = slot_floats(D);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * slot);
#pragma unroll
  for (int i = 0; i < kFR; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.0f;
  auto fetch = [&](int c) {  // by thread 0: B rows [c kFK, c kFK + kFK) below pad8(D)
    if (c < n_tiles)
      bulk_load(ring + (c % kStages) * slot, wt + (size_t)c * kFK * Dp,
                min(kFK, Dp - c * kFK) * Dp * 4, full + c % kStages);
  };
  __syncthreads();  // the caller's rows are written; the ring is free
  if (tid == 0) {
    mbar_init(full, kStages);
    for (int s = 0; s < kStages - 1; ++s) fetch(s);
  }
  __syncthreads();
  const float* xr = x + ty * kFR * P;
  for (int c = 0; c < n_tiles; ++c) {
    if (tid == 0) fetch(c + kStages - 1);  // into the slot of c - 1
    mbar_wait(full + c % kStages, (c / kStages) & 1);
    const float* t = ring + (c % kStages) * slot;
    // k past D up to a multiple of 4 adds fmaf(0, 0, acc): x's padding
    // columns and B's padding rows are zeros, and acc is never -0, so the
    // sum keeps its bits and the loop needs no test
    const int k0 = c * kFK, kn = min(kFK, ((D + 3) & ~3) - k0);
    for (int kq = 0; kq < kn; kq += 4) {
      float wc[4][NT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int d = tx + kFX * j;
          wc[kk][j] = d < Dp ? t[(kq + kk) * Dp + d] : 0.0f;
        }
#pragma unroll
      for (int i = 0; i < kFR; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr + i * P + k0 + kq);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(xs[kk], wc[kk][j], acc[i][j]);
      }
    }
    __syncthreads();  // every thread is done with slot c
  }
}

// f(i, j, row, column) for each element of rows_ffma's acc (columns below pad8(D)).
template <int kFR, int NT, class F>
__device__ __forceinline__ void for_each_ffma(int D, F&& f) {
  const int tx = threadIdx.x % kFX, ty = threadIdx.x / kFX;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int d = tx + kFX * j;
    if (d >= pad8(D)) continue;
#pragma unroll
    for (int i = 0; i < kFR; ++i) f(i, j, ty * kFR + i, d);
  }
}

// (NW, NWG) = (wg_tiles(D), row_groups(D)).  Two warpgroups up to D = 128,
// where two blocks share an SM, so one's softmax, epilogues and stores run
// beside the other's products; above, the activations of a second 64-row
// tile would leave no room for the weights' ring, so one block of four
// warpgroups takes the SM and its 16 warps hide the row work's latency.
template <int NW, int NWG>
__global__ void __launch_bounds__(128 * NWG, NWG == 2 ? 2 : 1) bwd_rows_kernel(const Params p) {
  constexpr int kT = 128 * NWG, kWarps = kT / 32;
  constexpr int kFR = kRows / (kT / kFX), NT = (8 * NW * NWG + kFX - 1) / kFX;  // FFMA tiles
  constexpr int kStages = ring_stages(NW, NWG);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, M = p.M, k = p.k, Dp = pad8(D), P = act_pitch(D);
  const bool has_glob = p.k_glob != nullptr, pos_only = p.q == nullptr;
  const int S = k + (has_glob ? 1 : 0);      // slots per query
  const int TQ = kRows / S;                  // queries per block
  const int R = TQ * S;                      // rows in use
  float* x0 = smem;                          // (kRows, P) hd, u, hg, logits, dlogits, dzg, du
  float* x1 = x0 + kRows * P;                // (kRows, P) values, dvalue, dpos, dz_delta
  float* ring = x1 + kRows * P;              // the products' weights (rows_mma.cuh)
  float* dxs = ring + ring_floats(D);        // (kRows, 4) position delta, then ddx
  int* nbr = reinterpret_cast<int*>(dxs + kRows * 4);  // (kRows) kv index per row
  int* wrow = nbr + kRows;                   // (kRows) workspace row, -1 past the end

  const int b = blockIdx.y, t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const float* kv = p.kv_xyz + (size_t)b * M * 3;
  const size_t RD = (size_t)p.B * p.Nq * S * Dp;  // floats of one workspace array
  float* const wsd = p.ws;
  // Workspace array a gets src's rows (pitch P, written before the last
  // barrier).  The block's valid rows are one contiguous run of the array,
  // so the copy is 16-byte stores in order, where stores from the products'
  // fragment layout were scattered 4-byte writes.
  auto to_ws = [&](const float* src, int a) {
    const int q4 = Dp / 4;
    for (int e = tid; e < kRows * q4; e += kT) {
      const int r = e / q4, c = (e - r * q4) * 4;
      if (wrow[r] < 0) continue;
      *reinterpret_cast<float4*>(wsd + a * RD + (size_t)wrow[r] * Dp + c) =
          *reinterpret_cast<const float4*>(src + r * P + c);
    }
  };

  // ---- neighbours and position deltas --------------------------------------
  for (int r = tid; r < kRows; r += kT) {
    const int t = r / S, s = r - t * S, n = t0 + t;
    const bool valid = r < R && n < p.Nq;
    const bool nb = valid && s < k;
    const int j = nb ? p.idx[((size_t)b * p.Nq + n) * k + s] : 0;
    nbr[r] = j;
    const int w = valid ? (int)(((size_t)b * p.Nq + n) * S + s) : -1;
    wrow[r] = w;
    const float* xq = p.xyz_q + ((size_t)b * p.Nq + (nb ? n : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float dx = nb && c < 3 ? __fsub_rn(xq[c], kv[3 * j + c]) : 0.0f;
      dxs[r * 4 + c] = dx;
      if (valid) wsd[kWsArrays * RD + (size_t)w * 4 + c] = dx;
    }
  }
  __syncthreads();

  // ---- forward recomputation: fc_delta ----------------------------------------
  uint64_t hd_mask = 0, hg_mask = 0;  // ReLU masks, bit elem_bit(e)
  for_each_elem<NW>(D, [&](int e, int r, int d) {
    float h = 0.0f;
    if (d < D) {
      const float* dx = dxs + r * 4;
      h = fmaxf(fmaf(dx[0], p.dw0[3 * d], fmaf(dx[1], p.dw0[3 * d + 1],
                fmaf(dx[2], p.dw0[3 * d + 2], p.db0[d]))), 0.0f);
    }
    if (h > 0.0f) hd_mask |= elem_bit(e);
    x0[r * P + d] = h;
  });
  __syncthreads();
  to_ws(x0, kWsHd);
  {
    float facc[kFR][NT];
    rows_ffma<kT, kFR, NT, kStages>(x0, p.dw1f, D, ring, facc);
    for_each_ffma<kFR, NT>(D, [&](int i, int j, int r, int d) {
      const float pos = facc[i][j] + (d < D ? p.db1[d] : 0.0f);
      float u = pos, v = pos;
      if (!pos_only && r < R && d < D) {
        const int t = r / S, s = r - t * S;
        const float qv =
            t0 + t < p.Nq ? p.q[b * p.q_sb + (long long)(t0 + t) * p.q_sn + d] : 0.0f;
        if (s < k) {
          const size_t row = ((size_t)b * M + nbr[r]) * D + d;
          u = (qv - p.K[row]) + pos;
          v = p.V[row] + pos;
        } else {  // global slot: zero position encoding
          u = qv - p.k_glob[(size_t)b * D + d];
          v = p.v_glob[(size_t)b * D + d];
        }
      }
      x0[r * P + d] = u;
      x1[r * P + d] = v;
    });
  }
  __syncthreads();
  to_ws(x0, kWsU);

  // ---- forward recomputation: fc_gamma ----------------------------------------
  {
    float facc[kFR][NT];
    rows_ffma<kT, kFR, NT, kStages>(x0, p.gw0f, D, ring, facc);
    for_each_ffma<kFR, NT>(D, [&](int i, int j, int r, int d) {
      const float h = fmaxf(facc[i][j] + (d < D ? p.gb0[d] : 0.0f), 0.0f);
      x0[r * P + d] = h;
    });
  }
  __syncthreads();
  to_ws(x0, kWsHg);
  for_each_elem<NW>(D, [&](int e, int r, int d) {  // the mask in engine order
    if (x0[r * P + d] > 0.0f) hg_mask |= elem_bit(e);
  });
  float acc[4 * NW];
  rows_mma<NW, NWG>(x0, p.gw1f, D, ring, acc);
  for_each_elem<NW>(D, [&](int e, int r, int d) {
    x0[r * P + d] = acc[e] + (d < D ? p.gb1[d] : 0.0f);
  });
  __syncthreads();

  // ---- slot softmax and its backward: dlogits, dvalue -------------------------
  for (int e = tid; e < TQ * Dp; e += kT) {
    const int t = e / Dp, d = e - t * Dp, n = t0 + t;
    if (n >= p.Nq) continue;
    float* l = x0 + t * S * P + d;
    float* v = x1 + t * S * P + d;
    if (d >= D) {  // padding columns: no gradient
      for (int s = 0; s < S; ++s) l[s * P] = v[s * P] = 0.0f;
      continue;
    }
    const float gv = p.g[((size_t)b * p.Nq + n) * D + d];
    float m = l[0];
    int s_max = 0;
    for (int s = 1; s < S; ++s)
      if (l[s * P] > m) {
        m = l[s * P];
        s_max = s;
      }
    float se = 0.0f;
    for (int s = 0; s < S; ++s) {
      l[s * P] = expf(l[s * P] - m);
      se += l[s * P];
    }
    float inner = 0.0f;
    for (int s = 0; s < S; ++s) {
      l[s * P] = l[s * P] / se;
      inner += l[s * P] * (gv * v[s * P]);
    }
    float residual = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float a = l[s * P];
      l[s * P] = a * (gv * v[s * P] - inner);
      residual += l[s * P];
      v[s * P] = gv * a;
    }
    // The slot sum of dlogits is zero; its rounding residual, shared by the
    // slots, would bias every weight gradient.  Take it off the largest
    // logit's slot, as autograd through the softmax's max shift does.
    l[s_max * P] -= residual;
  }
  __syncthreads();
  to_ws(x0, kWsDl);
  if (has_glob) {  // dv_glob: one atomic per channel and block
    for (int d = tid; d < D; d += kT) {
      double sum = 0.0;
      for (int t = 0; t < TQ && t0 + t < p.Nq; ++t) sum += x1[(t * S + k) * P + d];
      atomicAdd(p.dglob + ((size_t)b * 2 + 1) * D + d, sum);
    }
  }

  // ---- fc_gamma backward: dz_gamma, du ----------------------------------------
  rows_mma<NW, NWG>(x0, p.gw1t, D, ring, acc);
  for_each_elem<NW>(D, [&](int e, int r, int d) {
    const float h = hg_mask & elem_bit(e) ? acc[e] : 0.0f;
    x0[r * P + d] = h;
  });
  __syncthreads();
  to_ws(x0, kWsDzg);
  rows_mma<NW, NWG>(x0, p.gw0t, D, ring, acc);
  for_each_elem<NW>(D, [&](int e, int r, int d) {
    const int s = r % S;
    const bool nb = wrow[r] >= 0 && s < k;
    const float du = acc[e], dv = x1[r * P + d];
    const float dp = nb ? du + dv : 0.0f;
    if (nb && !pos_only && d < D) {
      const size_t row = ((size_t)b * M + nbr[r]) * D + d;
      atomicAdd(p.dK + row, (double)-du);
      atomicAdd(p.dV + row, (double)dv);
    }
    x0[r * P + d] = du;
    x1[r * P + d] = dp;
  });
  __syncthreads();
  to_ws(x1, kWsDpos);
  if (!pos_only) {  // dq = sum over the query's slots of du
    for (int e = tid; e < TQ * D; e += kT) {
      const int t = e / D, d = e - t * D, n = t0 + t;
      if (n >= p.Nq) continue;
      const float* du = x0 + t * S * P + d;
      float sum = 0.0f;
      for (int s = 0; s < S; ++s) sum += du[s * P];
      p.dq[((size_t)b * p.Nq + n) * D + d] = sum;
    }
  }
  if (has_glob) {  // dk_glob = -sum du over the global slots
    for (int d = tid; d < D; d += kT) {
      double sum = 0.0;
      for (int t = 0; t < TQ && t0 + t < p.Nq; ++t) sum += x0[(t * S + k) * P + d];
      atomicAdd(p.dglob + (size_t)b * 2 * D + d, -sum);
    }
  }

  // ---- fc_delta backward: dz_delta, ddx ---------------------------------------
  rows_mma<NW, NWG>(x1, p.dw1t, D, ring, acc);
  for_each_elem<NW>(D, [&](int e, int r, int d) {
    const float h = hd_mask & elem_bit(e) ? acc[e] : 0.0f;
    x1[r * P + d] = h;
  });
  __syncthreads();
  to_ws(x1, kWsDzd);
  {  // ddx = dz_delta w0d^T: a warp per kRows / kWarps rows, lanes across the channels
    const int warp = tid / 32, lane = tid % 32;
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp * (kRows / kWarps) + i;
      float sum[3] = {0.0f, 0.0f, 0.0f};
      for (int d = lane; d < D; d += 32) {
        const float z = x1[r * P + d];
#pragma unroll
        for (int c = 0; c < 3; ++c) sum[c] = fmaf(z, p.dw0[3 * d + c], sum[c]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], o);
      }
      const bool nb = wrow[r] >= 0 && r % S < k;
      if (lane < 3) {
        const float v = lane == 0 ? sum[0] : (lane == 1 ? sum[1] : sum[2]);
        dxs[r * 4 + lane] = nb ? v : 0.0f;
        if (nb) atomicAdd(p.dkv_xyz + ((size_t)b * M + nbr[r]) * 3 + lane, (double)-v);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TQ * 3; e += kT) {
    const int t = e / 3, c = e - t * 3, n = t0 + t;
    if (n >= p.Nq) continue;
    float sum = 0.0f;
    for (int s = 0; s < k; ++s) sum += dxs[(t * S + s) * 4 + c];
    p.dxyz_q[((size_t)b * p.Nq + n) * 3 + c] = sum;
  }
}

// ---- weight gradients: [X | 1]^T Y on the tensor cores ------------------------
//
// Each D-wide reduction C = [X | 1]^T Y runs as its transpose C^T = Y^T
// [X | 1] on wgmma.m64nNk8 in 3xTF32: A = Y^T from registers (64 Y columns a
// warpgroup), B = [X | 1] from shared memory, N of its columns, so that the
// column of ones (the bias gradient, C's last row) sits in N, which takes
// any multiple of 8.  A block owns one job's Y columns [m0, m0 + kWM) (two
// consumer warpgroups of 64) by [X | 1] columns [n0, n0 + 8 NW) (NW =
// wgrad_width(D)) over one row split.  The 4-wide [dx | 1] job (`light`
// blocks of the same launch) runs on the CUDA cores: a consumer thread per Y
// column and row parity, four fmaf a row.
//
// A producer warpgroup feeds them.  Its first thread stages each kWK-row
// chunk of the block's Y and X columns into a raw slot, a 2-D box of each
// by the TMA (a tensor map per array, zero past its rows and columns, so no
// edge needs a test), on the slot's full mbarrier.  Splitting B -- X's rows
// into TF32 hi and lo, with the ones column, in the K-major core-matrix
// order wgmma reads (weight_frags_kernel's, per chunk), into a split slot
// -- is ~10 instructions an element in dependent chains: the producer's
// warps 1-3 alone took ~2,300 cycles a chunk (one warp a sub-partition
// hides no latency), so the consumers' eight warps take a share too, of
// chunk i + 2 while chunk i's products run.  The consumers load their A
// fragments from the raw Y rows and split them in registers, then chain
// the chunk's four k-steps, three products each, in two accumulators (the
// two halves of N: the tensor cores overlap independent chains; one chain
// ran at ~75 cycles an m64n104k8 against ~57 for two), and wait once a
// chunk.  Chunk sums are added up apart 16 at a time and each 16's into the
// running sum (Kahan's four operations per element and chunk were the
// consumers' largest share of issue slots).  Empty mbarriers hand the
// slots back; the two warpgroups issue their chunks' products in turn
// (turn mbarriers), so that one's adds and loads run under the other's
// products.  The producer warpgroup gives up registers (setmaxnreg) for the
// consumers' accumulators.
constexpr int kWK = 32;           // workspace rows per staged chunk: four k-steps
constexpr int kWM = 128;          // Y columns of a block: two consumer warpgroups of 64
constexpr int kWYP = kWM + 8;     // staged Y row pitch, 8 mod 32: A-fragment loads meet no conflicts
constexpr int kWRaw = 4;          // raw chunk slots
constexpr int kWSplit = 3;        // split chunk slots
constexpr int kWFold = 16;        // chunks summed apart before the running sum takes them
constexpr int kWThreads = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int kWSplitters = 96 + 256;  // the producer's warps 1-3 and the consumers' 8
// Registers a thread after setmaxnreg: 128 kWProducerRegs + 256 kWConsumerRegs
// may not pass the 384 x 168 the block was launched with, or the consumers'
// setmaxnreg.inc waits for registers that never come.
constexpr int kWProducerRegs = 56, kWConsumerRegs = 224;
static_assert(128 * kWProducerRegs + 256 * kWConsumerRegs <= kWThreads * 168, "register split");

// The [X | 1] width (8-column groups) of a block of the D-wide jobs: of the
// widths the kernel is built for, the one that pads pad8(D + 1) least, the
// widest of equals.
int wgrad_width(int D) {
  const int groups = pad8(D + 1) / 8;
  const auto padded = [groups](int nw) { return (groups + nw - 1) / nw * nw; };
  return padded(8) < std::min(padded(11), padded(13)) ? 8 : padded(11) < padded(13) ? 11 : 13;
}

// Shared memory of wgrad_kernel<NW>: raw slots (kWK Y rows of pitch kWYP,
// then kWK X rows of pitch N), split slots (kWK rows x N, hi and lo), the
// full and empty mbarriers of each, and the consumers' two turn mbarriers.
template <int NW>
struct WgradSmem {
  static constexpr int N = 8 * NW;
  static constexpr int kRaw = kWK * (kWYP + N);
  static constexpr int kSplit = kWK * 2 * N;
  static constexpr size_t kBytes =
      (size_t)(kWRaw * kRaw + kWSplit * kSplit) * sizeof(float) + (2 * (kWRaw + kWSplit) + 2) * 8;
};

// The four reductions: job 0 [dx | 1] (light), then the three D-wide ones.
// A job's X (R, xp) has Dx live columns; its Y is (R, pad8(D)).  Their
// tensor maps stage kWK-row boxes (Y: kWYP columns from m0; X: N columns
// from n0, or dx's 4), zero past the arrays; the partial sums of job q lie
// at partial_offset(q, ...), (splits, Dx + 1, D).
struct WgradParams {
  CUtensorMap xmap[4], ymap[4];
  float* partial;
  int R, D;
  int groups, tiles;               // kWM-column groups of Y; N-column tiles of a D-wide [X | 1]
  int splits, rows;                // row splits of the D-wide jobs, rows a split (kWK multiples)
  int splits0, rows0;              // the same for [dx | 1]
};

__host__ __device__ __forceinline__ size_t partial_offset(int q, int D, int splits, int splits0) {
  return q == 0 ? 0 : (size_t)splits0 * 4 * D + (size_t)(q - 1) * splits * (D + 1) * D;
}

// The 2-D box at (column c0, row c1) of map into dst, counted on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// Rows [4 kq, 4 kq + 4) of a chunk's B = [X | 1] columns n0 ..., split, for
// each (column, kq) of this thread: xs holds X's box (pitch NB); columns past
// Dx zero, column Dx ones (rows past the array meet zero rows of Y); part q
// of B[8 kc + 4 h + e][8 g + i] at kc 16 NB + q 8 NB + g 64 + h 32 + i 4 + e.
template <int NB, int kBatch>
__device__ __forceinline__ void wgrad_split_chunk(const float* xs, float* out, int n0, int Dx, int th) {
  constexpr int kItems = NB * (kWK / 4);
  constexpr int kIters = (kItems + kWSplitters - 1) / kWSplitters;
#pragma unroll
  for (int j0 = 0; j0 < kIters; j0 += kBatch) {
    // a batch's loads first: the stores that follow may not pass them
    float v[kBatch][4];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = th + (j0 + j) * kWSplitters, n = e % NB, kq = e / NB, gn = n0 + n;
      const bool live = j0 + j < kIters && (kItems % kWSplitters == 0 || e < kItems);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        v[j][x] = live && gn < Dx ? xs[(4 * kq + x) * NB + n] : gn == Dx ? 1.0f : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = th + (j0 + j) * kWSplitters, n = e % NB, kq = e / NB;
      if (j0 + j >= kIters || (kItems % kWSplitters != 0 && e >= kItems)) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) split_tf32(v[j][x], hi[x], lo[x]);
      float* o = out + (kq / 2) * 16 * NB + (n / 8) * 64 + (kq % 2) * 32 + (n % 8) * 4;
      *reinterpret_cast<uint4*>(o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(o + 8 * NB) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// partial[z] = [X | 1]^T Y over row split z for one block's columns; see above.
template <int NW>
__global__ void __launch_bounds__(kWThreads, 1) wgrad_kernel(const __grid_constant__ WgradParams p) {
  using L = WgradSmem<NW>;
  constexpr int N = L::N;
  extern __shared__ __align__(128) float4 wsmem4[];
  float* raw = reinterpret_cast<float*>(wsmem4);
  float* split = raw + kWRaw * L::kRaw;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(split + kWSplit * L::kSplit);
  uint64_t* raw_empty = raw_full + kWRaw;
  uint64_t* split_full = raw_empty + kWRaw;
  uint64_t* split_empty = split_full + kWSplit;
  uint64_t* turn = split_empty + kWSplit;  // turn[w]: consumer warpgroup w may issue

  // the block's job q, Y columns [m0, m0 + kWM), [X | 1] columns [n0, n0 + N) and rows
  const int heavy = 3 * p.groups * p.tiles;
  int b = blockIdx.x, z, q, n0, rows;
  const bool light = b >= heavy * p.splits;
  if (!light) {
    z = b / heavy;
    b -= z * heavy;
    q = 1 + b / (p.groups * p.tiles);
    n0 = (b % p.tiles) * N;
    b = (b / p.tiles) % p.groups;
    rows = p.rows;
  } else {
    b -= heavy * p.splits;
    z = b / p.groups;
    b -= z * p.groups;
    q = n0 = 0;
    rows = p.rows0;
  }
  const int D = p.D, Dx = q == 0 ? 3 : D, m0 = b * kWM, r0 = z * rows, r1 = min(p.R, r0 + rows);
  const int n_chunks = r1 > r0 ? (r1 - r0 + kWK - 1) / kWK : 0;
  float* partial = p.partial + partial_offset(q, D, p.splits, p.splits0) + (size_t)z * (Dx + 1) * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(raw_full, kWRaw);
    mbar_init(raw_empty, kWRaw, light ? 8 : 8 + 3);  // the consumers' warps, and the splitters'
    mbar_init(split_full, kWSplit, 3 + 8);
    mbar_init(split_empty, kWSplit, 8);
    mbar_init(turn, 2, 4);
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs) : "memory");
    if (tid == 0) {  // stage chunk i: a box of Y's rows and one of X's
      const int bytes = kWK * (kWYP + (light ? 4 : N)) * 4;
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kWRaw;
        if (i >= kWRaw) mbar_wait(raw_empty + s, (i / kWRaw - 1) & 1);
        float* ys = raw + s * L::kRaw;
        mbar_expect_tx(raw_full + s, bytes);
        tma_box(ys, &p.ymap[q], m0, r0 + i * kWK, raw_full + s);
        tma_box(ys + kWK * kWYP, &p.xmap[q], n0, r0 + i * kWK, raw_full + s);
      }
    } else if (warp > 0 && !light) {  // split chunk i's [X | 1] into the K-major hi / lo order
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kWRaw, c = i % kWSplit;
        mbar_wait(raw_full + s, (i / kWRaw) & 1);
        if (i >= kWSplit) mbar_wait(split_empty + c, (i / kWSplit - 1) & 1);
        wgrad_split_chunk<N, 2>(raw + s * L::kRaw + kWK * kWYP, split + c * L::kSplit, n0, Dx, tid - 32);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(split_full + c);
          mbar_arrive(raw_empty + s);
        }
      }
    }
  } else if (light) {  // [dx | 1]^T Y on the CUDA cores: Y column c / 2, rows of parity c % 2
    const int c2 = tid - 128, col = c2 / 2, half = c2 % 2;
    float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, comp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kWRaw;
      mbar_wait(raw_full + s, (i / kWRaw) & 1);
      const float* ys = raw + s * L::kRaw;
      const float* xs = ys + kWK * kWYP;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = half; k < kWK; k += 2) {
        const float y = ys[k * kWYP + col];
        const float4 d = *reinterpret_cast<const float4*>(xs + 4 * k);
        part[0] = fmaf(d.x, y, part[0]);
        part[1] = fmaf(d.y, y, part[1]);
        part[2] = fmaf(d.z, y, part[2]);
        part[3] += y;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(raw_empty + s);
#pragma unroll
      for (int j = 0; j < 4; ++j) kahan_add(sum[j], comp[j], part[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
    if (half == 0 && m0 + col < D)
#pragma unroll
      for (int n = 0; n < 4; ++n) partial[(size_t)n * D + m0 + col] = sum[n];
  } else {  // two consumer warpgroups: Y columns m0 + 64 (wg - 1) ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs) : "memory");
    const int g = lane / 4, t = lane % 4, cw = tid / 128 - 1;
    const int col = 64 * cw + 16 * (warp % 4) + g;  // A rows col, col + 8
    constexpr int NA = (NW + 1) / 2, NB = NW - NA;  // n-tiles of the two chains
    float acc_a[4 * NA], acc_b[4 * NB], part[4 * NW], sum[4 * NW];
#pragma unroll
    for (int j = 0; j < 4 * NW; ++j) part[j] = sum[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NA; ++j) acc_a[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc_b[j] = 0.0f;
    // this thread's share of chunk j's split, once its raw rows have landed
    // and both warpgroups are done with its split slot's last chunk
    const auto split_share = [&](int j) {
      const int s = j % kWRaw, c = j % kWSplit;
      mbar_wait(raw_full + s, (j / kWRaw) & 1);
      if (j >= kWSplit) mbar_wait(split_empty + c, (j / kWSplit - 1) & 1);
      wgrad_split_chunk<N, 1>(raw + s * L::kRaw + kWK * kWYP, split + c * L::kSplit, n0, Dx, tid - 32);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(split_full + c);
    };
    for (int j = 0; j < 2 && j < n_chunks; ++j) split_share(j);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = i % kWRaw, c = i % kWSplit;
      mbar_wait(split_full + c, (i / kWSplit) & 1);
      mbar_wait(raw_full + s, (i / kWRaw) & 1);
      const float* ys = raw + s * L::kRaw + t * kWYP + col;
      uint32_t a_hi[kWK / 8][4], a_lo[kWK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kWK / 8; ++kk) {  // A[m][k] = Y[8 kk + k][m0 + m]
        const float* y = ys + 8 * kk * kWYP;
        split_tf32(y[0], a_hi[kk][0], a_lo[kk][0]);
        split_tf32(y[8], a_hi[kk][1], a_lo[kk][1]);
        split_tf32(y[4 * kWYP], a_hi[kk][2], a_lo[kk][2]);
        split_tf32(y[4 * kWYP + 8], a_hi[kk][3], a_lo[kk][3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(raw_empty + s);
      const float* bs = split + c * L::kSplit;
      // the warpgroups issue in turn, 0 then 1 each chunk, so that one's
      // adds and loads run under the other's products
      if (cw == 1 || i > 0) mbar_wait(turn + cw, (cw == 0 ? i - 1 : i) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 8; ++kk) {  // two chains, the columns' halves, interleaved
        const float* b_hi = bs + kk * 16 * N;
        Wgmma<NA>::mma(acc_a, a_lo[kk], smem_desc(b_hi), kk > 0);
        Wgmma<NB>::mma(acc_b, a_lo[kk], smem_desc(b_hi + 64 * NA), kk > 0);
        Wgmma<NA>::mma(acc_a, a_hi[kk], smem_desc(b_hi + 8 * N), 1);
        Wgmma<NB>::mma(acc_b, a_hi[kk], smem_desc(b_hi + 8 * N + 64 * NA), 1);
        Wgmma<NA>::mma(acc_a, a_hi[kk], smem_desc(b_hi), 1);
        Wgmma<NB>::mma(acc_b, a_hi[kk], smem_desc(b_hi + 64 * NA), 1);
      }
      wgmma_commit();
      __syncwarp();
      if (lane == 0) mbar_arrive(turn + 1 - cw);
      if (i + 2 < n_chunks) split_share(i + 2);  // under the products
      wgmma_wait0();
      fence_regs(acc_a);
      fence_regs(acc_b);
      __syncwarp();
      if (lane == 0) mbar_arrive(split_empty + c);
#pragma unroll
      for (int j = 0; j < 4 * NW; ++j) part[j] += j < 4 * NA ? acc_a[j] : acc_b[j - 4 * NA];
      if (i % kWFold == kWFold - 1 || i == n_chunks - 1) {
#pragma unroll
        for (int j = 0; j < 4 * NW; ++j) {
          sum[j] += part[j];
          part[j] = 0.0f;
        }
      }
    }
    // C[n][m] = C^T[m][n]: the D fragment's rows col (+ 8), columns 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + col + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
        if (m < D && n <= Dx) partial[(size_t)n * D + m] = sum[4 * j + e];
      }
  }
}

// wgrads[e] = the sum over its job's row splits of the partials, in a fixed
// order, compensated.
__global__ void wgrad_sum_kernel(const float* __restrict__ partial, int D, int splits, int splits0,
                                 float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (3 * D + 7) * D) return;
  const int o = e / D, d = e - o * D;
  const int q = o < 4 ? 0 : 1 + (o - 4) / (D + 1), r = o < 4 ? o : (o - 4) % (D + 1);
  const int rows = q == 0 ? 4 : D + 1, n = q == 0 ? splits0 : splits;
  const float* src = partial + partial_offset(q, D, splits, splits0) + (size_t)r * D + d;
  float sum = 0.0f, comp = 0.0f;
  for (int z = 0; z < n; ++z) kahan_add(sum, comp, src[(size_t)z * rows * D]);
  out[e] = sum;
}

// Shared memory of bwd_rows_kernel: two activation buffers, the ring, and
// per row a position delta, a kv index and a workspace row.
size_t rows_smem_bytes(int D) {
  return (size_t)(2 * kRows * act_pitch(D) + ring_floats(D) + 4 * kRows) * sizeof(float) +
         2 * kRows * sizeof(int);
}

template <int NW, int NWG>
cudaError_t launch_rows(const Params& p, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {  // the widest D of this shape takes the most
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_rows_kernel<NW, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)rows_smem_bytes(8 * NW * NWG));
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  const int tq = kRows / (p.k + (p.k_glob ? 1 : 0));
  const dim3 grid((p.Nq + tq - 1) / tq, p.B);
  bwd_rows_kernel<NW, NWG><<<grid, 128 * NWG, rows_smem_bytes(p.D), stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D float32 map of `cols` columns (row pitch `pitch` floats) by R rows, in
// boxes of box columns by kWK rows, zero past the array.
cudaError_t encode_rows(CUtensorMap* map, const float* base, int cols, int pitch, int R, int box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return failed(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * sizeof(float)};
  const cuuint32_t boxes[2] = {(cuuint32_t)box, (cuuint32_t)kWK}, unit[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                              strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NW>
cudaError_t launch_wgrad(const WgradParams& w, int blocks, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WgradSmem<NW>::kBytes);
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  wgrad_kernel<NW><<<blocks, kWThreads, WgradSmem<NW>::kBytes, stream>>>(w);
  return cudaGetLastError();
}

size_t wgrad_smem_bytes(int D) {
  switch (wgrad_width(D)) {
    case 8: return WgradSmem<8>::kBytes;
    case 11: return WgradSmem<11>::kBytes;
    default: return WgradSmem<13>::kBytes;
  }
}

// wgrads (3 D + 7, D) = the four [X | 1]^T Y, each X's rows followed by its
// bias row, over R workspace rows: the D-wide jobs in `splits` row splits,
// [dx | 1] in splits0; partial holds D (4 splits0 + 3 (D + 1) splits) floats.
cudaError_t weight_gradients(const float* ws, int R, int D, int splits, int splits0,
                             float* partial, float* wgrads, int device, cudaStream_t stream) {
  const int Dp = pad8(D), NW = wgrad_width(D);
  const size_t RD = (size_t)R * Dp;
  const auto rows = [R](int n) { return ((R + n - 1) / n + kWK - 1) / kWK * kWK; };
  WgradParams w{};
  const int X[4] = {kWsArrays, kWsHd, kWsU, kWsHg}, Y[4] = {kWsDzd, kWsDpos, kWsDzg, kWsDl};
  for (int q = 0; q < 4; ++q) {
    cudaError_t err = encode_rows(&w.ymap[q], ws + Y[q] * RD, Dp, Dp, R, kWYP);
    if (err == cudaSuccess)
      err = q == 0 ? encode_rows(&w.xmap[q], ws + X[q] * RD, 4, 4, R, 4)
                   : encode_rows(&w.xmap[q], ws + X[q] * RD, Dp, Dp, R, 8 * NW);
    if (err != cudaSuccess) return err;
  }
  w.partial = partial;
  w.R = R;
  w.D = D;
  w.groups = (D + kWM - 1) / kWM;
  w.tiles = (pad8(D + 1) / 8 + NW - 1) / NW;
  w.splits = splits;
  w.rows = rows(splits);
  w.splits0 = splits0;
  w.rows0 = rows(splits0);
  const int blocks = w.groups * (3 * w.tiles * splits + splits0);
  cudaError_t err;
  switch (NW) {
    case 8: err = launch_wgrad<8>(w, blocks, device, stream); break;
    case 11: err = launch_wgrad<11>(w, blocks, device, stream); break;
    default: err = launch_wgrad<13>(w, blocks, device, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int n = (3 * D + 7) * D;
  wgrad_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, D, splits,
                                                                            splits0, wgrads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of shared memory bwd_rows_kernel takes at width D.
long long nsdp_attention_bwd_smem(int D) { return (long long)rows_smem_bytes(D); }

// Bytes of shared memory wgrad_kernel takes at width D, and its [X | 1]
// width (8-column groups).
long long nsdp_wgrad_smem(int D) { return (long long)wgrad_smem_bytes(D); }
int nsdp_wgrad_width(int D) { return wgrad_width(D); }

// dw0, dw1, gw0, gw1: (out, in) weights, contiguous.  dkv_xyz, dK, dV and
// dglob are float64 and must be zeroed; wfrag holds 4 frag_floats(D) +
// 2 pad8(D)^2 floats, ws B * Nq * S * (7 pad8(D) + 4) and partial
// D (4 splits0 + 3 (D + 1) splits): the weight gradients' row splits.
// wgrads (3 D + 7, D) receives, in the (in, out) layout, [ddw0 (3 rows) |
// ddb0 | ddw1 (D) | ddb1 | dgw0 (D) | dgb0 | dgw1 (D) | dgb1].
int nsdp_fused_attention_bwd(
    const float* xyz_q, const float* kv_xyz, const int* idx,
    const float* q, long long q_sb, long long q_sn,
    const float* K, const float* V, const float* k_glob, const float* v_glob,
    const float* dw0, const float* db0, const float* dw1, const float* db1,
    const float* gw0, const float* gb0, const float* gw1, const float* gb1,
    const float* g, float* dxyz_q, double* dkv_xyz, float* dq, double* dK, double* dV,
    double* dglob, float* wfrag, float* ws, float* partial, float* wgrads,
    int B, int Nq, int M, int D, int k, int splits, int splits0, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || D < 1 || D > kDMax || k < 1 || k > kKMax || k > M ||
      k + (k_glob ? 1 : 0) > kKMax || splits < 1 || splits0 < 1 || device < 0 || device >= kMaxDevices)
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
  const size_t w = frag_floats(D), wf = (size_t)pad8(D) * pad8(D);
  float* wff = wfrag + 4 * w;  // the FFMA products' two weights
  FragParams fp{};
  const float* src[4] = {gw1, gw1, gw0, dw1};
  for (int j = 0; j < 4; ++j) fp.job[j] = {src[j], wfrag + j * w, j >= 1, 0};
  fp.job[4] = {dw1, wff, 0, 1};
  fp.job[5] = {gw0, wff + wf, 0, 1};
  fp.n_jobs = 6;
  fp.D = D;
  err = weight_frags(fp, s);
  if (err != cudaSuccess) return (int)err;
  const Params p{xyz_q, kv_xyz, idx, q, q_sb, q_sn, K, V, k_glob, v_glob, dw0, db0,
                 db1, gb0, gb1, wff, wff + wf, wfrag,
                 wfrag + w, wfrag + 2 * w, wfrag + 3 * w, g,
                 dxyz_q, dkv_xyz, dq, dK, dV, dglob, ws, B, Nq, M, D, k};
  switch (100 * row_groups(D) + wg_tiles(D)) {
    case 204: err = launch_rows<4, 2>(p, device, s); break;
    case 208: err = launch_rows<8, 2>(p, device, s); break;
    case 407: err = launch_rows<7, 4>(p, device, s); break;
    default: err = launch_rows<8, 4>(p, device, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int R = B * Nq * (k + (k_glob ? 1 : 0));
  return (int)weight_gradients(ws, R, D, splits, splits0, partial, wgrads, device, s);
}

}  // extern "C"
