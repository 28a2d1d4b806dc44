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
// and ~70 KB of traffic -- but latency: one warp's scan of the cloud, a
// strided loop of ~M/32 steps per lane, then k rounds of warp arg-min.  The
// design is K1's selection (knn_select.cuh), shared rather than copied:
// one warp per query, eight queries per block sharing each 2048-point chunk
// of the cloud staged in shared memory, so the cloud is streamed and M has
// no limit; a per-lane register list of the best candidates, filled by
// branch-free insertion under the total order (d2, index).  Nothing of the
// TPU layout carries over: no transposed (8, T) tiles, no penalty row, no k
// passes of min-extraction over a (T, M) block.

#include <cuda_runtime.h>

#include "knn_select.cuh"

namespace {

template <int KL, bool DIST>
__global__ void __launch_bounds__(knnsel::kThreads) knn_points_kernel(
    const float* __restrict__ xyz_q, const float* __restrict__ kv_xyz,
    const float* __restrict__ penalty, int Nq, int M, int k, int* __restrict__ idx,
    float* __restrict__ dist) {
  knnsel::select_body<KL, DIST>(xyz_q, kv_xyz, penalty, Nq, M, k, idx, dist);
}

template <bool DIST>
void launch(const float* xyz_q, const float* kv_xyz, const float* penalty, int B, int Nq, int M,
            int k, int* idx, float* dist, cudaStream_t stream) {
  const dim3 grid((Nq + knnsel::kWarps - 1) / knnsel::kWarps, B);
  const int t = knnsel::kThreads;
  if (k <= 8)
    knn_points_kernel<8, DIST><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx, dist);
  else if (k <= 16)
    knn_points_kernel<16, DIST><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx, dist);
  else
    knn_points_kernel<32, DIST><<<grid, t, 0, stream>>>(xyz_q, kv_xyz, penalty, Nq, M, k, idx, dist);
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// xyz_q: (B, Nq, 3), kv_xyz: (B, M, 3), penalty: (B, M) or null, all float32
// contiguous; idx: (B, Nq, k) int32; dist: (B, Nq, k) float32 or null.
int nsdp_knn(const float* xyz_q, const float* kv_xyz, const float* penalty, int B, int Nq, int M,
             int k, int* idx, float* dist, int device, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || k < 1 || k > knnsel::kKMax || k > M || device < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a failed call also sets the last error: clear it
    return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dist)
    launch<true>(xyz_q, kv_xyz, penalty, B, Nq, M, k, idx, dist, s);
  else
    launch<false>(xyz_q, kv_xyz, penalty, B, Nq, M, k, idx, nullptr, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
