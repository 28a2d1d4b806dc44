// k nearest points on Hopper (sm_90a): K4.
//
// Replaces the TPU kernel nsdp_tpu/ops/knn_pallas.py::_knn_kernel (reached
// through knn_pallas).  For every query of (B, Nq, 3) against the kv points
// of (B, M, 3):
//   d2 = penalty + sum_c (q_c - p_c)^2, exact f32, penalty first then c = 0,
//   1, 2 (the kv_mask penalty is a finite 1e30, or absent);
// the k smallest, ascending, ties to the lowest index -> (B, Nq, k) int32
// indices and, optionally, their (B, Nq, k) f32 squared distances (penalty
// included, as the TPU kernel returns them).  The plain PyTorch version is
// ops/knn.py::knn_plain; the distance is written with
// __fsub_rn/__fmul_rn/__fadd_rn in its order, so indices and distances
// agree bit for bit.
//
// What bounds it on an H100: neither bytes nor operations at the model's
// sites -- 500 x 5000 pairs are 22.5 MFLOP of f32 (0.3 us at the f32 peak)
// and ~70 KB of traffic -- but latency: a warp's scan of the cloud into
// its lanes' candidate lists, M / (32 W) dependent steps a lane, then k
// rounds of warp arg-min.  The design, knn_split_kernel:
//   * W warps share a query (ops/knn.py::split_warps, from M and B * Nq: 1
//     where the queries are enough to fill the card, up to 8 where so few
//     queries would leave it idle); part p of the cloud is the points whose
//     index e has (e / 32) % W == p, and warp p scans it, each lane keeping a
//     sorted register list of its best candidates under the total order
//     (d2, index).  The block stages the cloud in shared memory, kChunk
//     (5120) points at a time, for all its warps: 8 / W queries a block.
//   * A new candidate enters a list at once: every entry compares with it
//     independently and takes its own value, the new one or its left
//     neighbour's (a few dependent operations, against KL for a candidate
//     that bubbles down the list).
//   * With two passes (ops/knn.py::two_pass: 32 or more points a lane),
//     the first keeps only each lane's nearest distance; the k-th smallest
//     of a warp's 32 (k <= 32 distinct points lie at or below it), least
//     over the query's W warps, bounds the k-th nearest of the cloud, and
//     the second pass feeds the lists only with points at or below it.
//   * k rounds of warp arg-min (redux.sync on the distances' bits: d2 >= 0,
//     whose bits order as ints as the floats do) leave each part's k best,
//     sorted, in shared memory, padded with (+inf, INT_MAX) where a part
//     holds fewer; the W lists merge by rank: an entry's place in
//     the result is its place in its list plus the entries of the other
//     lists below it, which no two entries share, so each of the k nearest
//     lands in its own slot.
// Nothing of the TPU layout carries over: no transposed (8, T) tiles, no
// penalty row, no k passes of min-extraction over a (T, M) block.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "knn_select.cuh"  // knn_less, the order (d2, index); kKMax

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // the most warps a query (W <= kWarps)
// points staged a chunk: the model's 5000-point clouds in one (80 KB of
// dynamic shared memory, two blocks an SM, as the registers allow)
constexpr int kChunk = 5120;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
using knnsel::kKMax;
using knnsel::knn_less;

// The block's scan of the cloud, kChunk points at a time staged in shared
// memory (x, y, z, penalty) for its warps: calls f(d2, e) for the points e
// = start, start + stride, ... < M of a live warp.  d2 = penalty + sum_c
// (q_c - p_c)^2, summed in that order without contraction (knn_plain's).
// Every thread of the block calls it (it holds block barriers).  A chunk
// starts at a multiple of 32 * W, so e's part is (e / 32) % W in any chunk.
template <class F>
__device__ __forceinline__ void scan_chunks(float4* chunk, const float* kv, const float* pen,
                                            int M, bool live, int start, int stride, float qx,
                                            float qy, float qz, F&& f) {
  for (int base = 0; base < M; base += kChunk) {
    const int cn = min(kChunk, M - base);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < cn; e += kThreads) {
      const float* src = kv + 3 * (size_t)(base + e);
      chunk[e] = make_float4(src[0], src[1], src[2], pen ? pen[base + e] : 0.0f);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int e = start; e < cn; e += stride) {
      const float4 c = chunk[e];
      const float ex = __fsub_rn(qx, c.x);
      const float ey = __fsub_rn(qy, c.y);
      const float ez = __fsub_rn(qz, c.z);
      float d = __fadd_rn(c.w, __fmul_rn(ex, ex));
      d = __fadd_rn(d, __fmul_rn(ey, ey));
      d = __fadd_rn(d, __fmul_rn(ez, ez));
      f(d, base + e);
    }
  }
}

// The k-th smallest of the warp's 32 keys (non-negative ints), by bisection
// on the bits: the least v with at least k keys <= v.
__device__ __forceinline__ int kth_key(int key, int k) {
  int v = 0;
  for (int bit = 30; bit >= 0; --bit)
    if (__popc(__ballot_sync(kFull, key <= (v | ((1 << bit) - 1)))) < k) v |= 1 << bit;
  return v;
}

// Insert (d, n) into a sorted list of KL (8, 16 or 32 >= k) entries padded
// with (+inf, INT_MAX), keeping the KL smallest: the entries below it are a
// prefix, so entry i keeps its value, takes the new one (entry i - 1 is
// below it, entry i is not) or shifts from i - 1.
template <int KL>
__device__ __forceinline__ void list_insert(float (&ld)[KL], int (&li)[KL], float d, int n) {
  bool below[KL];
#pragma unroll
  for (int i = 0; i < KL; ++i) below[i] = knn_less(ld[i], li[i], d, n);
#pragma unroll
  for (int i = KL - 1; i > 0; --i) {
    ld[i] = below[i] ? ld[i] : (below[i - 1] ? d : ld[i - 1]);
    li[i] = below[i] ? li[i] : (below[i - 1] ? n : li[i - 1]);
  }
  ld[0] = below[0] ? ld[0] : d;
  li[0] = below[0] ? li[0] : n;
}

// W warps a query, kWarps / W queries a block (grid (ceil(Nq / (kWarps /
// W)), B)): warp w of block x scans part w % W of query x * (kWarps / W) +
// w / W.  penalty may be null (no mask).
template <int KL, bool DIST, bool TWO_PASS>
__global__ void __launch_bounds__(kThreads) knn_split_kernel(
    const float* __restrict__ xyz_q, const float* __restrict__ kv_xyz,
    const float* __restrict__ penalty, int Nq, int M, int k, int W, int* __restrict__ idx,
    float* __restrict__ dist) {
  __shared__ float part_d[kWarps][kKMax];  // each part's k best, ascending
  __shared__ int part_i[kWarps][kKMax];
  __shared__ int bound[kWarps];  // each warp's bound on the k-th nearest (TWO_PASS)
  extern __shared__ float4 chunk[];  // kChunk points
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = warp % W, group = warp / W, first = group * W;
  const int n = blockIdx.x * (kWarps / W) + group;
  const bool live = n < Nq;  // the same for the W warps of a query
  const float* kv = kv_xyz + (size_t)b * M * 3;
  const float* pen = penalty ? penalty + (size_t)b * M : nullptr;
  const float* xq = xyz_q + ((size_t)b * Nq + (live ? n : 0)) * 3;
  const float qx = xq[0], qy = xq[1], qz = xq[2];
  const int start = part * 32 + lane, stride = 32 * W;

  float tau = CUDART_INF_F;
  if (TWO_PASS) {
    float nearest = CUDART_INF_F;
    scan_chunks(chunk, kv, pen, M, live, start, stride, qx, qy, qz,
                [&](float d, int) { nearest = fminf(nearest, d); });
    if (live) {
      const int t = kth_key(__float_as_int(nearest), k);
      if (lane == 0) bound[warp] = t;
    }
    __syncthreads();
    if (live) {
      int t = bound[first];
      for (int q = 1; q < W; ++q) t = min(t, bound[first + q]);
      tau = __int_as_float(t);
    }
  }

  float ld[KL];
  int li[KL];
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    ld[i] = CUDART_INF_F;
    li[i] = INT_MAX;
  }
  scan_chunks(chunk, kv, pen, M, live, start, stride, qx, qy, qz, [&](float d, int e) {
    if ((!TWO_PASS || d <= tau) && knn_less(d, e, ld[KL - 1], li[KL - 1]))
      list_insert(ld, li, d, e);
  });
  if (live) {
    // the part's k best: k rounds of warp arg-min, the winner's lane pops
    // (a round of padding pops padding)
    for (int r = 0; r < k; ++r) {
      const int key = __float_as_int(ld[0]);
      const int best = __reduce_min_sync(kFull, key);
      const int bi = __reduce_min_sync(kFull, key == best ? li[0] : INT_MAX);
      if (bi == li[0]) {  // a kv index lives in one lane only
#pragma unroll
        for (int i = 0; i + 1 < KL; ++i) {
          ld[i] = ld[i + 1];
          li[i] = li[i + 1];
        }
        ld[KL - 1] = CUDART_INF_F;
        li[KL - 1] = INT_MAX;
      }
      if (lane == 0) {
        part_d[warp][r] = __int_as_float(best);
        part_i[warp][r] = bi;
      }
    }
  }
  __syncthreads();

  // merge the query's W lists by rank: thread t of its W warps places entry
  // t % k of part t / k; a real entry never ties another (its index is its
  // own), and the real entries number at least k (k <= M), so the k ranks
  // below k go to real entries, one each.  The count runs over whole lists
  // (independent loads), though they are sorted: stopping at the first
  // entry not below measured slower.
  const int t = part * 32 + lane;
  if (!live || t >= W * k) return;
  const int p = t / k, j = t - p * k;
  const float d = part_d[first + p][j];
  const int i = part_i[first + p][j];
  if (i == INT_MAX) return;
  int rank = j;
  for (int q = 0; q < W; ++q) {
    if (q == p) continue;
    for (int jj = 0; jj < k; ++jj)
      rank += knn_less(part_d[first + q][jj], part_i[first + q][jj], d, i);
  }
  if (rank < k) {
    const size_t row = ((size_t)b * Nq + n) * k;
    idx[row + rank] = i;
    if (DIST) dist[row + rank] = d;
  }
}

// Launch one instance, its shared memory above 48 KB opted in once a device.
template <class Kernel>
cudaError_t launch_one(Kernel kernel, bool (&opted)[kMaxDevices], int device, dim3 grid,
                       cudaStream_t stream, const float* xyz_q, const float* kv_xyz,
                       const float* penalty, int Nq, int M, int k, int W, int* idx, float* dist) {
  const size_t smem = sizeof(float4) * kChunk;
  if (!opted[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, W, idx, dist);
  return cudaSuccess;
}

template <int KL, bool DIST>
cudaError_t launch(const float* xyz_q, const float* kv_xyz, const float* penalty, int B, int Nq,
                   int M, int k, int W, bool two_pass, int* idx, float* dist, int device,
                   cudaStream_t stream) {
  static bool opted[2][kMaxDevices];
  const int per_block = kWarps / W;  // queries a block
  const dim3 grid((Nq + per_block - 1) / per_block, B);
  if (two_pass)
    return launch_one(knn_split_kernel<KL, DIST, true>, opted[1], device, grid, stream, xyz_q,
                      kv_xyz, penalty, Nq, M, k, W, idx, dist);
  return launch_one(knn_split_kernel<KL, DIST, false>, opted[0], device, grid, stream, xyz_q,
                    kv_xyz, penalty, Nq, M, k, W, idx, dist);
}

template <bool DIST>
cudaError_t launch_k(const float* xyz_q, const float* kv_xyz, const float* penalty, int B, int Nq,
                     int M, int k, int W, bool two_pass, int* idx, float* dist, int device,
                     cudaStream_t stream) {
  if (k <= 8)
    return launch<8, DIST>(xyz_q, kv_xyz, penalty, B, Nq, M, k, W, two_pass, idx, dist, device,
                           stream);
  if (k <= 16)
    return launch<16, DIST>(xyz_q, kv_xyz, penalty, B, Nq, M, k, W, two_pass, idx, dist, device,
                            stream);
  return launch<32, DIST>(xyz_q, kv_xyz, penalty, B, Nq, M, k, W, two_pass, idx, dist, device,
                          stream);
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// xyz_q: (B, Nq, 3), kv_xyz: (B, M, 3), penalty: (B, M) or null, all float32
// contiguous; idx: (B, Nq, k) int32; dist: (B, Nq, k) float32 or null; W
// (1, 2, 4 or 8) warps a query; two_pass nonzero for the bound pass.
int nsdp_knn(const float* xyz_q, const float* kv_xyz, const float* penalty, int B, int Nq, int M,
             int k, int W, int two_pass, int* idx, float* dist, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || k < 1 || k > kKMax || k > M || device < 0 ||
      device >= kMaxDevices || (W != 1 && W != 2 && W != 4 && W != 8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  if (err == cudaSuccess)
    err = dist ? launch_k<true>(xyz_q, kv_xyz, penalty, B, Nq, M, k, W, two_pass != 0, idx, dist,
                                device, s)
               : launch_k<false>(xyz_q, kv_xyz, penalty, B, Nq, M, k, W, two_pass != 0, idx,
                                 nullptr, device, s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a failed call also sets the last error: clear it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
