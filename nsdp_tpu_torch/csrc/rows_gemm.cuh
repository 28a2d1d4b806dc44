// Row-block products on f32 CUDA cores, for the fused attention's forward
// (attention.cu, K1: the row path, and the decoder's broadcast path where a
// backward follows); the backward's (K2) and the inference broadcast path's
// run on the tensor cores (rows_mma.cuh).  Namespace gemm, beside
// rows_mma.cuh's rows, which attention.cu includes too.
//
// A block of 256 threads owns kRows = 32 (query, slot) rows whose
// activations live transposed in shared memory (D x kRP floats, 16-byte row
// reads broadcast to a warp).  A D x D weight streams through a
// double-buffered kKC-row tile filled with cp.async (rows padded to an odd
// pitch, so filling a tile down its columns meets no shared-memory bank
// conflicts); each thread accumulates an 8 x CJ register tile (CJ =
// ceil(D / 64) columns, 64 threads across the channels).
// Weights arrive in nn.Linear's (out, in) layout, contiguous.

#pragma once

#include <cuda_runtime.h>

namespace gemm {

constexpr int kNX = 64;               // threads across the channels
constexpr int kNY = 4;                // thread groups across the rows
constexpr int kThreads = kNX * kNY;   // 256
constexpr int kRows = 32;             // (query, slot) rows per block
constexpr int kRT = kRows / kNY;      // rows per thread: 8
constexpr int kRP = kRows + 4;        // padded row of a transposed activation
constexpr int kKC = 16;               // weight rows per staged tile
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Row pitch of a staged weight tile: odd, so the kKC rows of one column
// fall in distinct shared-memory banks.
__host__ __device__ __forceinline__ int tile_pitch(int D) { return D | 1; }

// Stage reduction rows [c*kKC, c*kKC + kKC) of the product x @ w^T's weight
// into dst as kKC rows of pitch P: tile[kk][d] = w[d][c*kKC + kk], kKC
// threads down each output channel's contiguous inputs.  w is (out, in) =
// D x D, row-major.
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ w, int D, int P,
                                           int c) {
  const int r0 = c * kKC;
  const int r = threadIdx.x % kKC;
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

// acc[i][j] = sum_kk xt[kk][ty*kRT + i] * w[tx + j*kNX][kk]
// xt: (D, kRP) transposed activations in shared memory; w: (D, D), (out, in),
// in global memory; ws: two kKC x P tiles of shared memory.  Ends with a
// barrier, so xt may be overwritten next.
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

// A failed runtime call also sets the thread's last error; clear it, so the
// next launch's cudaGetLastError() does not report this failure again.
inline cudaError_t failed(cudaError_t err) {
  cudaGetLastError();
  return err;
}

}  // namespace gemm
