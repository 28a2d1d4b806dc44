// Row-block products on Hopper's tensor cores, for the fused attention's
// backward (attention_bwd.cu, K2).  (K1, the forward, keeps the f32 engine
// of rows_gemm.cuh: its output's rounding moves every later activation, and
// the full-width step checks pin batch seeds chosen for those bits; PERF.md.)
//
// Contract: a block of kThreads = 256 threads (8 warps) owns kRows = 32
// (query, slot) rows whose activations live row-major in shared memory
// (kRows x act_pitch(D) floats; columns D .. pad8(D) - 1 hold zeros or
// finite values that meet zero weights).  rows_mma multiplies them by a
// D x D weight into float32 accumulators held in registers as mma.sync's C
// fragments; for_each_elem names the (row, column) of each.
//
// Arithmetic: 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// An operand x splits into hi = tf32(x) and lo = tf32(x - hi), tf32 being
// cvt.rna.tf32.f32's rounding (done in integer instructions, tf32_rna); per
// 8-deep k-step a zeroed accumulator takes a_lo b_hi, then a_hi b_lo, then
// a_hi b_hi (lo lo is dropped), and is added to the running sum in float32.
// The tensor cores add less exactly than a float32 add; summing each k-step
// apart keeps that error to one step, so the products keep float32 accuracy
// (K2's gradients failed their rule when the running sum went through the
// mma).
//
// Operands.  The activations are split once per product for all warps
// (split_rows: hi in place, lo into a second buffer) and read as A
// fragments by ldmatrix.x4 (a row pitch of 4 mod 8 floats puts the 8 rows of
// each 8 x 4 matrix in distinct bank groups).  The weights are laid out once
// per call (weight_frags_kernel, into scratch the wrapper allocates) in
// fragment order: for k-step kc, n-tile nt and lane l one float2 {b0, b1}
// with
//   b0 = B[8 kc + l % 4][8 nt + l / 4],  b1 = B[8 kc + l % 4 + 4][8 nt + l / 4],
// B zero-padded to pad8(D) x pad8(D).  Warp w owns the n-tiles w, w + 8,
// w + 16, w + 24 (NT = ceil(pad8(D) / 64) of them) over both 16-row m-tiles,
// so each lane streams exactly the float2s it multiplies, kStages k-steps
// ahead, through its own slots of a shared-memory ring by 8-byte cp.async
// and its own wait_group: the k-loop has no block barrier.  A weight is
// split as its fragment is loaded: one stored as hi and lo parts would
// double the bytes every block streams from L2 (3.5 TB/s measured then).
//
// What bounds it: mma.sync's tensor-core rate (three HMMA.1688 per
// 16 x 8 x 8 step; K1's three decoder products run on this engine took ~14
// cycles of an SM sub-partition per HMMA) and, at 32 rows a block, the
// weights' L2 stream (5 KB per row and product at D = 200).  wgmma's 64-row
// tiles would lift both (PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rows {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // 256
constexpr int kRows = 32;              // (query, slot) rows per block
constexpr int kMT = kRows / 16;        // 16-row m-tiles per block
constexpr int kStages = 4;             // k-steps of weight fragments in flight
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int pad8(int D) { return (D + 7) & ~7; }
// Row pitch of an activation buffer: 4 mod 8, so ldmatrix meets no conflicts.
__host__ __device__ __forceinline__ int act_pitch(int D) { return pad8(D) + 4; }
// Floats of one weight in fragment order.
__host__ __device__ __forceinline__ size_t frag_floats(int D) {
  return (size_t)pad8(D) * pad8(D);
}
// Register tile width: n-tiles per warp.
__host__ __device__ __forceinline__ int n_tiles_per_warp(int D) { return (pad8(D) + 63) / 64; }
// Floats of the weight ring in shared memory: per warp, kStages k-steps of
// its n-tiles' B fragments (a float2 a lane each).
__host__ __device__ __forceinline__ int ring_floats(int D) {
  return kWarps * kStages * n_tiles_per_warp(D) * 64;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest on the 13 low
// mantissa bits, ties away from zero; the same bits for every finite x), in
// two integer instructions: the split runs for every operand element, and
// there it costs more issue slots than the products it feeds.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The TF32 hi and lo parts of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a b, with a and b given as their hi and lo parts.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
// 16 bytes from gmem if valid, else 16 zero bytes (gmem is not read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Up to four weights laid out per launch; trans = 0: B[k][n] = w[n][k]
// (x w^T, a forward layer), trans = 1: B[k][n] = w[k][n] (dy w, an input
// gradient).  w is (out, in) = D x D, row-major; out receives
// frag_floats(D) floats.
struct FragJob {
  const float* w;
  float* out;
  int trans;
};
constexpr int kMaxFragJobs = 4;
struct FragParams {
  FragJob job[kMaxFragJobs];
  int n_jobs, D;
};

__global__ void __launch_bounds__(kThreads) weight_frags_kernel(const FragParams p) {
  const int D = p.D, nt_all = pad8(D) / 8;
  const int e = blockIdx.x * kThreads + threadIdx.x;  // (kc, nt, lane)
  if (e >= nt_all * nt_all * 32) return;
  const int lane = e % 32, nt = (e / 32) % nt_all, kc = e / (32 * nt_all);
  const int n = 8 * nt + lane / 4, k0 = 8 * kc + lane % 4;
#pragma unroll
  for (int q = 0; q < kMaxFragJobs; ++q) {
    if (q >= p.n_jobs) break;
    const FragJob job = p.job[q];
    float b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 4 * h;
      b[h] = k < D && n < D ? job.w[job.trans ? (size_t)k * D + n : (size_t)n * D + k] : 0.0f;
    }
    reinterpret_cast<float2*>(job.out)[e] = make_float2(b[0], b[1]);
  }
}

inline cudaError_t weight_frags(const FragParams& p, cudaStream_t stream) {
  const int n = (pad8(p.D) / 8) * (pad8(p.D) / 8) * 32;
  weight_frags_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Split the activations act (kRows x pad8(D), pitch act_pitch(D), shared)
// once for all warps: act keeps the hi parts, act_lo takes the lo parts.
__device__ __forceinline__ void split_rows(float* act, float* act_lo, int D) {
  const int q4 = pad8(D) / 4, P = act_pitch(D);
  for (int e = threadIdx.x; e < kRows * q4; e += kThreads) {
    const int r = e / q4, o = r * P + (e - r * q4) * 4;
    float4* hp = reinterpret_cast<float4*>(act + o);
    const float4 x = *hp;
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(hp) = hi;
    *reinterpret_cast<uint4*>(act_lo + o) = lo;
  }
}

// acc = act (kRows x pad8(D), pitch act_pitch(D), shared) times B, where
// wfrag is B laid out by weight_frags_kernel (global), act_lo is kRows x
// act_pitch(D) floats of scratch and ring is ring_floats(D) floats of shared
// memory.  Each lane streams the B fragments it multiplies, and only those,
// through its own kStages-deep slots of the ring (8-byte cp.async, its own
// wait_group), so the k-loop has no block barrier: the warps run apart.
// Starts with a barrier, so the caller's writes to act are seen, and ends
// with one: act (left holding the hi parts), act_lo and ring may be
// overwritten when it returns.
template <int NT>
__device__ __forceinline__ void rows_mma(float* act, float* act_lo,
                                         const float* __restrict__ wfrag, int D, float* ring,
                                         float (&acc)[kMT][NT][4]) {
  const int n_steps = pad8(D) / 8, P = act_pitch(D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this lane's fragment of (k-step kc, n-tile warp + 8 j), and its slot
  const float2* src = reinterpret_cast<const float2*>(wfrag) + warp * 32 + lane;
  float2* slots = reinterpret_cast<float2*>(ring) + warp * kStages * NT * 32 + lane;
  auto fetch = [&](int kc) {
    if (kc < n_steps) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (warp + kWarps * j < n_steps)
          cp_async8(slots + ((kc % kStages) * NT + j) * 32,
                    src + ((size_t)kc * n_steps + kWarps * j) * 32);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  __syncthreads();
  split_rows(act, act_lo, D);
  __syncthreads();
  // this lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (columns 0-3 | 4-7)
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 4;
  for (int kc = 0; kc < n_steps; ++kc) {
    cp_async_wait<kStages - 2>();  // this lane's fragments of k-step kc have landed
    fetch(kc + kStages - 1);       // into the slots this lane read at kc - 1
    uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      ldmatrix_x4(a_hi[mt], act + a_off + mt * 16 * P + kc * 8);
      ldmatrix_x4(a_lo[mt], act_lo + a_off + mt * 16 * P + kc * 8);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (warp + kWarps * j >= n_steps) continue;  // warp-uniform
      const float2 b = slots[((kc % kStages) * NT + j) * 32];
      uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
      split_tf32(b.x, b0_hi, b0_lo);
      split_tf32(b.y, b1_hi, b1_lo);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(step, a_hi[mt], a_lo[mt], b0_hi, b1_hi, b0_lo, b1_lo);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] += step[c];
      }
    }
  }
  __syncthreads();
}

// f(mt, j, c, row, column) for each accumulator element this thread holds
// (columns below pad8(D)).
template <int NT, class F>
__device__ __forceinline__ void for_each_elem(int D, F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = warp + kWarps * j;
    if (nt * 8 >= pad8(D)) continue;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) f(mt, j, c, mt * 16 + g + 8 * (c >> 1), nt * 8 + 2 * t + (c & 1));
  }
}

// Bit of element (mt, j, c) in a per-thread 32-bit mask (NT <= 4).
__device__ __forceinline__ uint32_t elem_bit(int mt, int j, int c) {
  return 1u << ((j * kMT + mt) * 4 + c);
}

// A failed runtime call also sets the thread's last error; clear it, so the
// next launch's cudaGetLastError() does not report this failure again.
inline cudaError_t failed(cudaError_t err) {
  cudaGetLastError();
  return err;
}

}  // namespace rows
