// Row-block products on Hopper's tensor cores with 16-bit operands, for the
// narrow-operand mode (compute_dtype bfloat16 / float16) of the fused
// attention's forward (attention.cu, K1).  It replaces, for that mode, the
// f32 FFMA engines that ran the mode's D x D products before
// (rows_gemm.cuh, and attention.cu's attn_bcast_kernel), which rounded each
// MLP input to 16 bits and then multiplied it in f32 on the CUDA cores.
//
// Contract: a block of 32 warps(D) threads owns kRows = 64 (query, slot)
// rows whose activations sit row-major in shared memory as 16-bit values
// (kRows x act_pitch(D) of them; columns D .. pad16(D) - 1 hold zeros).
// rows_mma16 multiplies them by a D x D weight into float32 accumulators
// held in registers as mma.sync's C fragments; for_each_pair hands the
// caller each pair of adjacent accumulator columns with its row.
//
// Arithmetic: mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}: the 16-bit
// products are exact, summed in float32 per 16-deep k-step into the running
// accumulator (the C operand) -- the JAX kernel's own arithmetic
// (attention_pallas.py::_mlp2, preferred_element_type=f32).  One HMMA
// covers 16 x 8 x 16, what took three HMMA.1688 over half the depth in K2's
// 3xTF32 engine (rows_mma.cuh).
//
// Operands.  The activations are the caller's 16-bit stores (the narrow
// rounding is the store), read as A fragments by ldmatrix.x4: a row pitch of
// pad16(D) + 8 halves (an odd number of 16-byte units) puts the 8 rows of
// each 8 x 8 matrix in distinct bank groups.  The weights are laid out once
// per call by weight_frags16_kernel, into scratch that the wrapper
// allocates, in fragment order: for k-step kc, n-tile nt and lane l one
// uint2 {b0, b1} of two 16-bit pairs,
//   b0 = {B[16 kc + 2 t][n], B[16 kc + 2 t + 1][n]},
//   b1 = {B[16 kc + 2 t + 8][n], B[16 kc + 2 t + 9][n]},  t = l % 4, n = 8 nt + l / 4,
// B (= w^T for x w^T) zero-padded to pad16(D) x pad8(D).  Warp w owns the
// n-tiles w, w + W, w + 2 W, w + 3 W (kNT = 4, W = warps(D)) over the
// block's 4 m-tiles, so each lane streams exactly the uint2s it multiplies,
// kStages k-steps ahead, through its own slots of a shared-memory ring by
// 8-byte cp.async and its own wait_group: the k-loop has no block barrier.
// At 64 rows and 4 n-tiles a warp, a block at D = 200 is 7 warps and 109 KB,
// so two fit an SM and one's gathers and softmax run beside the other's
// products.  (128-row blocks of 2 n-tiles a warp, one an SM, were measured
// no faster at the decoder and slower at the encoder sites: PERF.md.)
//
// What bounds it: shared memory and latency, not the tensor cores.  A warp
// reads each 512-byte A fragment by ldmatrix for its 4 n-tiles, and the B
// ring adds 128 bytes written and read per m16n8k16: 256 bytes an MMA, 2
// cycles of an SM's 128 bytes a cycle against the tensor cores' ~1.  The
// weights' L2 stream is pad16(D) pad8(D) 2 bytes per product and block: 1.3
// KB a row at D = 200, against 5 KB a row for the f32 engine's 32-row
// blocks (rows_mma.cuh's note).  wgmma (64-row warpgroup tiles, B read from
// shared memory by the tensor cores themselves) would lift the first; it is
// a later step, to be taken once the kernel's own time (PERF.md) shows the
// products set the pace rather than the gathers and the slot softmax, which
// take about as long in a block (PERF.md).
//
// Shared memory of attention.cu's kernel at D = 256, the widest (smem_bytes):
// the activations 33.8 KB and the ring 32.8 KB, overlaid after the products
// by the f32 logits 67.6 KB; the f32 values 67.6 KB; per row a position
// delta and a neighbour index 1.3 KB: 136.4 KB of 227 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace mma16 {

constexpr int kRows = 64;        // (query, slot) rows of a block
constexpr int kMT = kRows / 16;  // its m-tiles
constexpr int kNT = 4;           // n-tiles (8 columns each) a warp
constexpr int kStages = 4;       // k-steps of weight fragments in flight
constexpr int kMaxThreads = 256; // warps(256) = 8 warps
constexpr int kMaxSmem = 232448; // opt-in shared memory of an sm_90 block

__host__ __device__ __forceinline__ int pad8(int D) { return (D + 7) & ~7; }
__host__ __device__ __forceinline__ int pad16(int D) { return (D + 15) & ~15; }
__host__ __device__ __forceinline__ int n_tiles(int D) { return pad8(D) / 8; }
__host__ __device__ __forceinline__ int k_steps(int D) { return pad16(D) / 16; }
// Warps of a block: kNT n-tiles each.
__host__ __device__ __forceinline__ int warps(int D) { return (n_tiles(D) + kNT - 1) / kNT; }
// Row pitch of the 16-bit activations, in halves.
__host__ __device__ __forceinline__ int act_pitch(int D) { return pad16(D) + 8; }
// Row pitch of the f32 logits and values: pad8(D), moved to 8 or 24 mod 32
// so that a warp's float2 stores of its C fragments (8 rows x 8 columns)
// meet no bank conflict.
__host__ __device__ __forceinline__ int tile_pitch(int D) {
  const int p = pad8(D);
  return p % 16 == 0 ? p + 8 : p;
}
// 16-bit elements of one weight in fragment order.
__host__ __device__ __forceinline__ size_t frag_elems(int D) {
  return (size_t)pad16(D) * pad8(D);
}
__host__ __device__ __forceinline__ size_t act_bytes(int D) {
  return (size_t)kRows * act_pitch(D) * 2;
}
__host__ __device__ __forceinline__ size_t ring_bytes(int D) {
  return (size_t)warps(D) * kStages * kNT * 32 * 8;
}
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return (size_t)kRows * tile_pitch(D) * 4;
}
// The region the products use (activations, then the ring) and that the
// logits overlay after them.
__host__ __device__ __forceinline__ size_t region_bytes(int D) {
  const size_t a = act_bytes(D) + ring_bytes(D), l = tile_bytes(D);
  return a > l ? a : l;
}
// Shared memory of attention.cu's narrow kernel: the region, the f32 values,
// and per row a 4-float position delta and a neighbour index.
__host__ __device__ __forceinline__ size_t smem_bytes(int D) {
  return region_bytes(D) + tile_bytes(D) + (size_t)kRows * (16 + 4);
}

// Two floats rounded to the narrow type NW (1 bfloat16, 2 float16) to
// nearest even, packed low first: a 16-bit pair of a fragment.
template <int NW>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (NW == 1) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&u, &v, 4);
  }
  return u;
}

template <int NW>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (NW == 1)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
        " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3},"
        " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Three D x D weights (out, in), row-major f32, laid out in fragment order
// for x w^T (B[k][n] = w[n][k]) and rounded to the narrow type NW: weight m
// at out + m frag_elems(D) / 4.
template <int NW>
__global__ void __launch_bounds__(256) weight_frags16_kernel(const float* w0, const float* w1,
                                                             const float* w2, int D,
                                                             uint2* out) {
  const int nt_all = n_tiles(D);
  const size_t per = frag_elems(D) / 4;  // uint2s of one weight: (kc, nt, lane)
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < 3 * per;
       e += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(e / per), rem = (int)(e - m * per);
    const int lane = rem % 32, nt = rem / 32 % nt_all, kc = rem / (32 * nt_all);
    const float* w = m == 0 ? w0 : m == 1 ? w1 : w2;
    const int n = 8 * nt + lane / 4, k0 = 16 * kc + 2 * (lane % 4);
    auto B = [&](int k) { return k < D && n < D ? w[(size_t)n * D + k] : 0.0f; };
    out[e] = make_uint2(pack2<NW>(B(k0), B(k0 + 1)), pack2<NW>(B(k0 + 8), B(k0 + 9)));
  }
}

// acc = act (kRows x pad16(D), pitch act_pitch(D), shared) times B, where
// frag is B laid out by weight_frags16_kernel (global) and ring is
// ring_bytes(D) of shared memory.  Each lane streams the B fragments it
// multiplies, and only those, through its own kStages-deep slots of the ring
// (8-byte cp.async, its own wait_group), so the k-loop has no block barrier.
// Starts with a barrier, so the caller's writes to act are seen, and ends
// with one: act and the ring may be overwritten when it returns.
template <int NW>
__device__ __forceinline__ void rows_mma16(const uint16_t* act, const uint2* __restrict__ frag,
                                           int D, uint2* ring, float (&acc)[kMT][kNT][4]) {
  const int ks = k_steps(D), nt_all = n_tiles(D), W = warps(D), P = act_pitch(D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this lane's fragment of (k-step kc, n-tile warp + W j), and its slot
  const uint2* src = frag + warp * 32 + lane;
  uint2* slots = ring + warp * kStages * kNT * 32 + lane;
  bool live[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) live[j] = warp + W * j < nt_all;  // warp-uniform
  auto fetch = [&](int kc) {
    if (kc < ks) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (live[j])
          cp_async8(slots + ((kc % kStages) * kNT + j) * 32,
                    src + ((size_t)kc * nt_all + W * j) * 32);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  __syncthreads();
  // this lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15)
  const uint16_t* a_lane = act + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
  for (int kc = 0; kc < ks; ++kc) {
    cp_async_wait<kStages - 2>();  // this lane's fragments of k-step kc have landed
    fetch(kc + kStages - 1);       // into the slots this lane read at kc - 1
    uint2 b[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      b[j] = live[j] ? slots[((kc % kStages) * kNT + j) * 32] : make_uint2(0u, 0u);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, a_lane + mt * 16 * P + kc * 16);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        if (live[j]) mma<NW>(acc[mt][j], a, b[j].x, b[j].y);
    }
  }
  __syncthreads();
}

// f(row, column, v0, v1) for each pair of adjacent accumulator elements this
// thread holds: (row, column) and (row, column + 1), column even and below
// pad8(D).
template <class F>
__device__ __forceinline__ void for_each_pair(int D, const float (&acc)[kMT][kNT][4], F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, W = warps(D);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int nt = warp + W * j;
    if (nt >= n_tiles(D)) continue;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mt * 16 + lane / 4 + 8 * h, nt * 8 + 2 * (lane % 4), acc[mt][j][2 * h],
          acc[mt][j][2 * h + 1]);
  }
}

}  // namespace mma16
