// Row gather on Hopper (sm_90a): the counterpart of P1 and P2.
//
// Replaces both TPU formulations of one gather in
// scripts/bench_gather_prefetch.py: the kernel inside onehot_gather (P1, k
// one-hot (T, M) x (M, W) MXU products per query tile) and the kernel
// inside prefetch_gather (P2, one scalar-prefetched (1, W) row DMA per grid
// step).  Both exist only because Mosaic lowers no dynamic gather; on
// Hopper the gather is by index.  It is the grouping gather of the
// PointNet++ set abstraction (nsdp_tpu/nn/blocks.py:570):
//   out[b, s, j, :] = table[b, idx[b, s, j], :]
// for a (B, M, W) float32 table and (B, S, k) int32 indices -> a contiguous
// (B, S, k, W) float32 output.  An index outside [0, M) gives a row of NaN.
// The plain PyTorch version is ops/gather.py::gather_rows_plain; a copy, so
// both agree bit for bit.
//
// What bounds it on an H100: bytes.  Each output row is one table row read
// (from L2 when rows repeat, as neighbourhoods overlap) and one row written:
// 2 x 1 KB per row at W = 256, no arithmetic.  The design: one warp per
// output row at a time (grid-stride over the rows), the row's index read by
// the warp itself (one broadcast load), then the row copied with 16-byte
// loads and stores, consecutive lanes on consecutive addresses (W = 256 is
// two float4 per lane).  A table or output not 16-byte aligned, or W not a
// multiple of 4, takes 4-byte copies.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 32;  // enough warps in flight to cover the latency

template <bool VEC>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ table, const int* __restrict__ idx, long long rows, int rows_per_b,
    int M, int W, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += warps) {
    const long long b = r / rows_per_b;
    const int j = idx[r];
    const bool ok = j >= 0 && j < M;
    const float* src = table + ((size_t)b * M + (ok ? j : 0)) * W;
    float* dst = out + (size_t)r * W;
    if (VEC) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      const float4 nan4 = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
      for (int c = lane; c < W / 4; c += 32) d4[c] = ok ? __ldg(s4 + c) : nan4;
    } else {
      for (int c = lane; c < W; c += 32) dst[c] = ok ? __ldg(src + c) : CUDART_NAN_F;
    }
  }
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// table: (B, M, W) float32 contiguous; idx: (B, S, k) int32 contiguous;
// out: (B, S, k, W) float32 contiguous.
int nsdp_gather_rows(const float* table, const int* idx, int B, int M, int W, int S, int k,
                     float* out, int device, void* stream) {
  if (B < 1 || M < 1 || W < 1 || S < 1 || k < 1 || device < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a failed call also sets the last error: clear it
    return (int)err;
  }
  const long long rows = (long long)B * S * k;
  const long long want = (rows + kWarps - 1) / kWarps;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const bool vec = W % 4 == 0 && ((reinterpret_cast<size_t>(table) | reinterpret_cast<size_t>(out)) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    gather_rows_kernel<true><<<blocks, kThreads, 0, s>>>(table, idx, rows, S * k, M, W, out);
  else
    gather_rows_kernel<false><<<blocks, kThreads, 0, s>>>(table, idx, rows, S * k, M, W, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
