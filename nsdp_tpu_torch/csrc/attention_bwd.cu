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
//     launch reduces all four [X | 1]^T Y on the tensor cores in 3xTF32:
//     64 x 64 output tiles, split over row chunks into partials that
//     wgrad_sum_kernel adds in a fixed order, compensated (deterministic),
//     the rows streaming through a 4-deep cp.async ring, so that several
//     chunks' loads are in flight.  The column of ones beside X makes the
//     bias gradient the tile's last row.

#include <cuda_runtime.h>

#include <cstdint>

#include "rows_mma.cuh"

namespace {

using namespace rows;

constexpr int kKMax = 32;  // largest k, and most slots (k and the global slot)
constexpr int kDMax = 256; // largest channel width
constexpr int kWT = 64;    // output tile edge of the weight-gradient reduction
constexpr int kWR = 32;    // rows per staged chunk of the reduction
constexpr int kWP = kWT + 8;  // staged row pitch, 8 mod 32: fragment loads meet no conflicts
constexpr int kWStages = 4;   // staged chunks in flight
constexpr size_t kWSmemBytes = (size_t)kWStages * 2 * kWR * kWP * sizeof(float);

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

// One of the four reductions: X (R, xp) with Dx live columns, Y (R, yp),
// into rows [out_row, out_row + Dx + 1) of the (3 D + 7, D) output.
struct WgradJob {
  const float* X;
  const float* Y;
  int xp, Dx, out_row, tiles_m;
};
struct WgradParams {
  WgradJob job[4];
  int yp, Dy, tiles_n, R, chunk, out_rows;
  float* partial;  // (splits, out_rows, Dy)
};

// partial[z] = [X | 1]^T Y over rows [z * chunk, (z + 1) * chunk) for one
// 64 x 64 output tile (blockIdx.x counts the tiles of the four jobs).  The
// rows arrive kWR at a time through a kWStages-deep cp.async ring (rows past
// the end and columns past the array zero-filled), so several chunks' loads
// are in flight while one is reduced.  Warp (wm, wn) owns 32 x 16 of the
// tile: 2 x 2 mma tiles, 3xTF32 with both operands split as they are
// loaded.  A sum runs over up to ~10^5 rows per chunk, so each 8-row k-step
// is summed apart into its kWR-row chunk's sum, and each chunk's into the
// running sum with Kahan's compensation.
__global__ void __launch_bounds__(kThreads, 2) wgrad_kernel(const WgradParams p) {
  extern __shared__ float4 wsmem4[];
  float* wsmem = reinterpret_cast<float*>(wsmem4);  // kWStages x (xs, ys), each kWR x kWP
  int tile = blockIdx.x;
  WgradJob job = p.job[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int n = p.job[q].tiles_m * p.tiles_n;
    if (tile < n) {
      job = p.job[q];
      break;
    }
    tile -= n;
  }
  const float* X = job.X;
  const float* Y = job.Y;
  const int xp = job.xp;
  const int m0 = (tile / p.tiles_n) * kWT, n0 = (tile % p.tiles_n) * kWT;
  const int r_begin = blockIdx.y * p.chunk, r_end = min(p.R, r_begin + p.chunk);
  const int n_chunks = r_end > r_begin ? (r_end - r_begin + kWR - 1) / kWR : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;

  // a thread's two 16-byte pieces of each operand in a chunk: row e / 16,
  // columns 4 (e % 16) ...
  auto stage = [&](int i) {
    if (i < n_chunks) {
      float* xs = wsmem + (i % kWStages) * 2 * kWR * kWP;
      float* ys = xs + kWR * kWP;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = tid + u * kThreads, rr = e / 16, c = (e % 16) * 4, r = r_begin + i * kWR + rr;
        const bool xv = r < r_end && m0 + c < xp, yv = r < r_end && n0 + c < p.yp;
        cp_async16_zfill(xs + rr * kWP + c, xv ? X + (size_t)r * xp + m0 + c : X, xv);
        cp_async16_zfill(ys + rr * kWP + c, yv ? Y + (size_t)r * p.yp + n0 + c : Y, yv);
      }
    }
    cp_async_commit();
  };

  float acc[2][2][4], comp[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = comp[i][j][c] = 0.0f;
  // [X | 1]: this thread's A columns m and m + 8 of each m-tile that are the ones column
  bool ones[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) ones[i][h] = m0 + wm * 32 + i * 16 + g + 8 * h == job.Dx;

#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) stage(i);
  for (int it = 0; it < n_chunks; ++it) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // chunk it has landed; every warp is done with chunk it - 1
    stage(it + kWStages - 1);
    const float* xs = wsmem + (it % kWStages) * 2 * kWR * kWP;
    const float* ys = xs + kWR * kWP;
    float step[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) step[i][j][c] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < kWR; k0 += 8) {
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[2][2], b_lo[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // A[m][kk] = [X | 1][kk][m]
        const int m = wm * 32 + i * 16 + g;
        split_tf32(ones[i][0] ? 1.0f : xs[(k0 + t) * kWP + m], a_hi[i][0], a_lo[i][0]);
        split_tf32(ones[i][1] ? 1.0f : xs[(k0 + t) * kWP + m + 8], a_hi[i][1], a_lo[i][1]);
        split_tf32(ones[i][0] ? 1.0f : xs[(k0 + t + 4) * kWP + m], a_hi[i][2], a_lo[i][2]);
        split_tf32(ones[i][1] ? 1.0f : xs[(k0 + t + 4) * kWP + m + 8], a_hi[i][3], a_lo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // B[kk][n] = Y[kk][n]
        const int n = wn * 16 + j * 8 + g;
        split_tf32(ys[(k0 + t) * kWP + n], b_hi[j][0], b_lo[j][0]);
        split_tf32(ys[(k0 + t + 4) * kWP + n], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // each k-step summed apart (rows_mma.cuh)
          float t8[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_3xtf32(t8, a_hi[i], a_lo[i], b_hi[j][0], b_hi[j][1], b_lo[j][0], b_lo[j][1]);
#pragma unroll
          for (int c = 0; c < 4; ++c) step[i][j][c] += t8[c];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) kahan_add(acc[i][j][c], comp[i][j][c], step[i][j][c]);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * (c >> 1);
        const int n = n0 + wn * 16 + j * 8 + 2 * t + (c & 1);
        if (m <= job.Dx && n < p.Dy)
          p.partial[((size_t)blockIdx.y * p.out_rows + job.out_row + m) * p.Dy + n] = acc[i][j][c];
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

// wgrads (3 D + 7, D) = the four [X | 1]^T Y, each X's rows followed by
// its bias row, over R workspace rows, in `splits` row chunks.
cudaError_t weight_gradients(const float* ws, int R, int D, int splits, float* partial,
                             float* wgrads, int device, cudaStream_t stream) {
  const int Dp = pad8(D);
  const size_t RD = (size_t)R * Dp;
  WgradParams w{};
  const float* X[4] = {ws + kWsArrays * RD, ws + kWsHd * RD, ws + kWsU * RD, ws + kWsHg * RD};
  const float* Y[4] = {ws + kWsDzd * RD, ws + kWsDpos * RD, ws + kWsDzg * RD, ws + kWsDl * RD};
  const int Dx[4] = {3, D, D, D};
  int out_row = 0, tiles = 0;
  w.tiles_n = (D + kWT - 1) / kWT;
  for (int q = 0; q < 4; ++q) {
    w.job[q] = {X[q], Y[q], q == 0 ? 4 : Dp, Dx[q], out_row, (Dx[q] + 1 + kWT - 1) / kWT};
    out_row += Dx[q] + 1;
    tiles += w.job[q].tiles_m * w.tiles_n;
  }
  w.yp = Dp;
  w.Dy = D;
  w.R = R;
  w.chunk = ((R + splits - 1) / splits + kWR - 1) / kWR * kWR;
  w.out_rows = out_row;
  w.partial = partial;
  static bool opted_in[kMaxDevices];
  if (!opted_in[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWSmemBytes);
    if (err != cudaSuccess) return failed(err);
    opted_in[device] = true;
  }
  wgrad_kernel<<<dim3(tiles, splits), kThreads, kWSmemBytes, stream>>>(w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = out_row * D;
  wgrad_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, splits, n,
                                                                            wgrads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of shared memory bwd_rows_kernel takes at width D.
long long nsdp_attention_bwd_smem(int D) { return (long long)rows_smem_bytes(D); }

// dw0, dw1, gw0, gw1: (out, in) weights, contiguous.  dkv_xyz, dK, dV and
// dglob are float64 and must be zeroed; wfrag holds 4 frag_floats(D) +
// 2 pad8(D)^2 floats, ws B * Nq * S * (7 pad8(D) + 4) and partial
// splits * (3 D + 7) * D.
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
    int B, int Nq, int M, int D, int k, int splits, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || D < 1 || D > kDMax || k < 1 || k > kKMax || k > M ||
      k + (k_glob ? 1 : 0) > kKMax || splits < 1 || device < 0 || device >= kMaxDevices)
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
  return (int)weight_gradients(ws, R, D, splits, partial, wgrads, device, s);
}

}  // extern "C"
