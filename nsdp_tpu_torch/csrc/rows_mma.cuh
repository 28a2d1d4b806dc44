// Row-tile products on Hopper's tensor cores (wgmma), for the fused
// attention's backward (attention_bwd.cu, K2).  (K1, the forward, keeps the
// f32 engine of rows_gemm.cuh: its output's rounding moves every later
// activation, and the full-width step checks pin batch seeds chosen for
// those bits; PERF.md.)
//
// Contract: a block of NWG warpgroups (128 NWG threads) owns kRows = 64
// (query, slot) rows -- one wgmma M -- whose activations live row-major in
// shared memory (kRows x act_pitch(D) floats; columns D .. pad8(D) - 1 hold
// zeros or finite values that meet zero weights).  rows_mma multiplies them
// by a D x D weight into float32 accumulators held in registers as wgmma's
// D fragments: warpgroup wg owns the n-tiles (8 columns) wg NW .. wg NW +
// NW - 1 of all 64 rows; for_each_elem names the (row, column) of each of a
// thread's 4 NW elements.  The shape follows D (row_groups, wg_tiles): two
// warpgroups up to D = 128, where two blocks share an SM; four above, one
// block an SM, so that 16 warps still hide the latency of the row work
// around the products.
//
// Arithmetic: 3xTF32 on wgmma.mma_async.m64n{8 NW}k8.f32.tf32.tf32, A from
// registers, B from shared memory.  An operand x splits into hi = tf32(x)
// and lo = tf32(x - hi), tf32 being cvt.rna.tf32.f32's rounding (done in
// integer instructions, tf32_rna); per 8-deep k-step one wgmma group takes
// a_lo b_hi into a zeroed accumulator (scale-d 0), then a_hi b_lo, then
// a_hi b_hi (lo lo is dropped), and the group's sum is added to the
// running sum in float32.  The tensor cores add less exactly than a float32
// add; summing each k-step apart keeps that error to one step, so the
// products keep float32 accuracy (K2's gradients failed their rule when the
// running sum went through the mma).
//
// Operands.  A: each warp of a warpgroup reads its 16 rows of the k-step
// with ldmatrix.x4 (a row pitch of 4 mod 8 floats puts the 8 rows of each
// 8 x 4 matrix in distinct bank groups) and splits them in registers, so
// the activations need no lo copy.  B: weight_frags_kernel lays each weight
// out once per call, into scratch the wrapper allocates, split and in
// wgmma's K-major order without swizzle: for k-step kc, part q (0 hi, 1
// lo), 8-column group g, k-half h, row i and element x the float
//   part q of B[8 kc + 4 h + x][8 g + i]  at  kc 16 Np + q 8 Np + g 64 + h 32 + i 4 + x,
// B zero-padded to pad8(D) x Np, Np = tc_cols(D).  A k-step is one
// contiguous run of 16 Np floats, which one thread stages into a slot of a
// ring_stages-deep ring in shared memory by one bulk copy (the TMA),
// completing on the slot's mbarrier, once per 64 rows; the tensor cores
// read its core matrices (8 rows x 16 bytes, LBO 128 bytes along k, SBO 256
// bytes along n) in place.  (Splitting the weights in the block instead,
// from float32 slots, halves the L2 stream but cost more than it saved, and
// 16-byte cp.async by every thread more than the bulk copy: PERF.md.)
//
// What bounds it: the latency of each k-step's group -- the sum of one
// k-step must be added before the next may use the registers -- rather than
// the tensor cores' TF32 rate; the block's other warpgroups (or the other
// block's) run their groups meanwhile.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace rows {

constexpr int kThreads = 256;  // threads of a block of weight_frags_kernel
constexpr int kRows = 64;      // (query, slot) rows per block: one wgmma M
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int pad8(int D) { return (D + 7) & ~7; }
// Row pitch of an activation buffer: 4 mod 8, so ldmatrix meets no conflicts.
__host__ __device__ __forceinline__ int act_pitch(int D) { return pad8(D) + 4; }
// Warpgroups of a block at width D: two up to D = 128, four above.
__host__ __device__ __forceinline__ int row_groups(int D) { return pad8(D) <= 128 ? 2 : 4; }
// n-tiles (8 columns) a warpgroup owns: its share of pad8(D)'s, rounded up
// to a width the kernels are instantiated for.
__host__ __device__ __forceinline__ int wg_tiles(int D) {
  const int G = row_groups(D), t = (pad8(D) / 8 + G - 1) / G;
  return G == 2 ? (t <= 4 ? 4 : 8) : (t <= 7 ? 7 : 8);
}
// Columns of B the warpgroups cover: Np >= pad8(D).
__host__ __device__ __forceinline__ int tc_cols(int D) { return 8 * wg_tiles(D) * row_groups(D); }
// Floats of one weight in the engine's order: hi and lo parts.
__host__ __device__ __forceinline__ size_t frag_floats(int D) {
  return (size_t)2 * pad8(D) * tc_cols(D);
}
// Floats of one ring slot: a k-step's weights, hi and lo.
__host__ __device__ __forceinline__ int slot_floats(int D) { return 16 * tc_cols(D); }
// Ring slots for the shape (NW, NWG): as many as shared memory leaves room
// for beside the activations (218.6 KB at D = 224, 216.6 KB at D = 256;
// 110.1 KB at D = 128, two blocks an SM), so the weights' L2 latency stays
// hidden.
__host__ __device__ constexpr int ring_stages(int NW, int NWG) {
  return NWG == 4 && NW == 7 ? 7 : 5;
}
// The ring: its slots, then an mbarrier (2 floats) per slot.
__host__ __device__ __forceinline__ int ring_floats(int D) {
  return ring_stages(wg_tiles(D), row_groups(D)) * (slot_floats(D) + 2);
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

// mma.sync, for the weight gradients' reduction (attention_bwd.cu's wgrad_kernel).
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

// ---- the ring's mbarriers and bulk copies (the TMA) ----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// n mbarriers of one arrival each; by one thread, then a block barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
  for (int s = 0; s < n; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// bytes (a multiple of 16) from src to dst, completing on bar's current phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Until bar's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, 128 bytes apart along k (LBO) and
// 256 bytes apart along n (SBO).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until this warpgroup's committed groups are done.
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of r across the asm around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for one k-step: m64n{8 NW}k8, A (tf32) from registers as
// wgmma's A fragment, B from shared memory (desc_b); scale_d 0 ignores d.
template <int NW>
struct Wgmma;

template <>
struct Wgmma<4> {  // m64n32k8
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<7> {  // m64n56k8
  static __device__ __forceinline__ void mma(float (&d)[28], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<8> {  // m64n64k8
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};


// Up to six weights laid out per launch.  B[k][n] = w[n][k] (trans = 0,
// x w^T, a forward layer) or w[k][n] (trans = 1, dy w, an input gradient),
// w (out, in) = D x D row-major, zero beyond D.  ffma = 0: the engine's
// order, frag_floats(D) floats; ffma = 1: B row-major, pad8(D) x pad8(D)
// (the rows of rows_ffma in attention_bwd.cu).
struct FragJob {
  const float* w;
  float* out;
  int trans, ffma;
};
constexpr int kMaxFragJobs = 6;
struct FragParams {
  FragJob job[kMaxFragJobs];
  int n_jobs, D;
};

__global__ void __launch_bounds__(kThreads) weight_frags_kernel(const FragParams p) {
  const int D = p.D, Dp = pad8(D), Np = tc_cols(D);
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= 2 * Dp * Np) return;
  // engine order: e = kc 16 Np + q 8 Np + g 64 + h 32 + i 4 + x
  const int kc = e / (16 * Np), q = (e / (8 * Np)) % 2, r = e % (8 * Np);
  const int ke = 8 * kc + 4 * ((r / 32) % 2) + r % 4, ne = 8 * (r / 64) + (r / 4) % 8;
#pragma unroll
  for (int j = 0; j < kMaxFragJobs; ++j) {
    if (j >= p.n_jobs) break;
    const FragJob job = p.job[j];
    if (job.ffma && e >= Dp * Dp) continue;
    const int k = job.ffma ? e / Dp : ke, n = job.ffma ? e % Dp : ne;
    const float w =
        k < D && n < D ? job.w[job.trans ? (size_t)k * D + n : (size_t)n * D + k] : 0.0f;
    uint32_t hi, lo;
    split_tf32(w, hi, lo);
    job.out[e] = job.ffma ? w : __uint_as_float(q ? lo : hi);
  }
}

inline cudaError_t weight_frags(const FragParams& p, cudaStream_t stream) {
  const int n = 2 * pad8(p.D) * tc_cols(p.D);
  weight_frags_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// acc = act (kRows x pad8(D), pitch act_pitch(D), shared) times B, where
// wfrag is B laid out by weight_frags_kernel (global) and ring is
// ring_floats(D) floats of shared memory; NW = wg_tiles(D), NWG =
// row_groups(D).  Thread 0 stages each k-step's hi and lo parts, one
// contiguous run, by a bulk copy that completes on its slot's mbarrier.
// Starts with a barrier, so the caller's writes to act are seen, and ends
// with one: act and ring may be overwritten when it returns.
template <int NW, int NWG>
__device__ __forceinline__ void rows_mma(const float* act, const float* __restrict__ wfrag, int D,
                                         float* ring, float (&acc)[4 * NW]) {
  constexpr int Np = 8 * NW * NWG, kSlot = 16 * Np, kStages = ring_stages(NW, NWG);
  const int n_steps = pad8(D) / 8, P = act_pitch(D);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kSlot);
  auto fetch = [&](int kc) {  // by thread 0: k-step kc into its slot
    if (kc < n_steps)
      bulk_load(ring + (kc % kStages) * kSlot, wfrag + (size_t)kc * kSlot, kSlot * 4,
                full + kc % kStages);
  };
  float step[4 * NW];
#pragma unroll
  for (int j = 0; j < 4 * NW; ++j) acc[j] = step[j] = 0.0f;
  __syncthreads();  // the caller's rows are written; the ring is free
  if (tid == 0) {
    mbar_init(full, kStages);
    for (int s = 0; s < kStages - 1; ++s) fetch(s);
  }
  __syncthreads();
  // this lane's ldmatrix row: matrices (rows 0-7 | 8-15) x (columns 0-3 | 4-7)
  // of its warp's 16 rows
  const float* a_src = act + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 4;
  const int b_off = wg * NW * 64;  // this warpgroup's first column group, in floats
  for (int kc = 0; kc < n_steps; ++kc) {
    if (tid == 0) fetch(kc + kStages - 1);  // into the slot k-step kc - 1 used
    mbar_wait(full + kc % kStages, (kc / kStages) & 1);
    const float* b_hi = ring + (kc % kStages) * kSlot + b_off;
    uint32_t a[4], a_hi[4], a_lo[4];
    ldmatrix_x4(a, a_src + kc * 8);
#pragma unroll
    for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(a[c]), a_hi[c], a_lo[c]);
    fence_regs(step);
    wgmma_fence();
    Wgmma<NW>::mma(step, a_lo, smem_desc(b_hi), 0);
    Wgmma<NW>::mma(step, a_hi, smem_desc(b_hi + 8 * Np), 1);
    Wgmma<NW>::mma(step, a_hi, smem_desc(b_hi), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(step);
#pragma unroll
    for (int j = 0; j < 4 * NW; ++j) acc[j] += step[j];
    __syncthreads();  // every warpgroup is done with k-step kc's slot
  }
}

// f(e, row, column) for each accumulator element e this thread holds
// (columns below pad8(D)): wgmma's D fragment, rows 16 w + g (+ 8), columns
// 8 n-tile + 2 t (+ 1).
template <int NW, class F>
__device__ __forceinline__ void for_each_elem(int D, F&& f) {
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int nt = wg * NW + j;
    if (nt * 8 >= pad8(D)) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      f(4 * j + c, warp * 16 + g + 8 * (c >> 1), nt * 8 + 2 * t + (c & 1));
  }
}

// Bit of element e in a per-thread 64-bit mask (4 NW <= 64).
__device__ __forceinline__ uint64_t elem_bit(int e) { return 1ull << e; }

// A failed runtime call also sets the thread's last error; clear it, so the
// next launch's cudaGetLastError() does not report this failure again.
inline cudaError_t failed(cudaError_t err) {
  cudaGetLastError();
  return err;
}

}  // namespace rows
