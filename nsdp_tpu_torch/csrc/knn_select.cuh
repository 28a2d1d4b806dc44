// Exact k-nearest-neighbour selection of the fused attention's selection
// kernel (attention.cu, K1).  Its order, knn_less, is also the standalone
// kNN's (knn.cu, K4), which splits a query's cloud over several warps.
//
// For a query q and kv points p_j (j ascending):
//   d2_j = penalty_j + (q_x - p_x)^2 + (q_y - p_y)^2 + (q_z - p_z)^2,
// summed left to right with __fsub_rn/__fmul_rn/__fadd_rn (no FMA
// contraction), the order of the plain PyTorch version
// (ops/knn.py::select), so both agree bit for bit; the k smallest,
// ascending, ties to the lowest index.
//
// One warp per query, kWarps queries per block sharing each chunk of kv
// points staged in shared memory (the cloud is streamed, so M is
// unbounded).  Each lane scans every 32nd point from its lane index and
// keeps a sorted list of its best candidates in registers (branch-free
// insertion under the total order (d2, index)); the lists merge with k
// rounds of warp arg-min.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace knnsel {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // queries per block
constexpr int kChunk = 2048;           // kv points per staged chunk (32 KB)
constexpr int kKMax = 32;              // largest k
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool knn_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

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
// ascending indices (padding, never reached as k <= M, would become 0) and,
// with DIST, their distances.
template <int KL, bool DIST>
__device__ void warp_merge(float (&ld)[KL], int (&li)[KL], int k, int lane, int* out,
                           float* dist) {
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
    if (lane == 0) {
      out[r] = bi == INT_MAX ? 0 : bi;
      if (DIST) dist[r] = bd;
    }
  }
}

// The body of a selection kernel (launched with kThreads threads, grid
// (ceil(Nq / kWarps), B)): idx[b, n, :] (and, with DIST, dist[b, n, :]) =
// the k nearest kv points of query n.  Warp w of block x handles query
// x * kWarps + w.  penalty may be null (no mask).
template <int KL, bool DIST>
__device__ __forceinline__ void select_body(const float* __restrict__ xyz_q,
                                            const float* __restrict__ kv_xyz,
                                            const float* __restrict__ penalty, int Nq, int M,
                                            int k, int* __restrict__ idx,
                                            float* __restrict__ dist) {
  __shared__ float4 pts[kChunk];  // x, y, z, penalty
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int n = blockIdx.x * kWarps + (tid >> 5);
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
  if (live) {
    const size_t row = ((size_t)b * Nq + n) * k;
    warp_merge<KL, DIST>(ld, li, k, lane, idx + row, DIST ? dist + row : nullptr);
  }
}

}  // namespace knnsel
