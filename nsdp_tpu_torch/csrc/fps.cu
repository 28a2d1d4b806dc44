// Furthest-point sampling on Hopper (sm_90a).
//
// Replaces the TPU kernel nsdp_tpu/ops/fps_pallas.py::_fps_kernel (reached
// through furthest_point_sample_pallas).  Same semantics, which are those of
// the reference CUDA kernel (pointnet2 sampling_gpu.cu):
//   * index 0 is always the first pick;
//   * points with |p|^2 <= 1e-3 (and so zero padding) are never chosen and
//     never update the running min-distance;
//   * the running min-distance starts at 1e10;
//   * each step picks the largest running min-distance, ties to the lowest
//     index; an all-invalid cloud picks 0.
// The plain PyTorch version is ops/fps.py::furthest_point_sample_plain; the
// squared norms and distances are summed with __fmul_rn/__fadd_rn in its
// order ((x*x + y*y) + z*z) so no FMA contraction can move a near-tie, and
// the indices agree exactly.
//
// What bounds it: neither bytes (the cloud is 60 KB at 5000 points) nor
// operations (9 per point per step), but the npoint-1 dependent steps, each
// a block-wide arg-max with two barriers.  The design keeps the whole step
// inside one block: one block per batch element, 1024 threads striding over
// the points, a warp-shuffle arg-max then one across the 32 warps.  Two
// variants share that step and its arithmetic:
//   * fps_kernel, up to kSmemPoints (14,496) points: the cloud and the
//     running min-distance in shared memory (16 bytes a point);
//   * fps_global_kernel, any larger cloud: the running min-distance in a
//     (B, N) float32 scratch in device memory, the coordinates read through
//     the read-only cache.  Each thread reads and writes only its own
//     points' distances, so no step needs more than the one arg-max.  Up to
//     ~15,000 points the cloud and its distances stay in the SM's L1; a
//     larger cloud streams through it from L2 at every step (20 bytes a
//     point), and that stream, not the arg-max, bounds it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// Opt-in shared memory of an sm_90 block, less room for the static arrays;
// fps_kernel takes 16 bytes a point, so up to kSmemPoints points
// (ops/fps.py SMEM_POINTS); larger clouds take fps_global_kernel.
constexpr int kMaxSmem = 232448 - 512;
constexpr int kSmemPoints = kMaxSmem / 16;
bool g_opted_in[kMaxDevices];  // cudaFuncSetAttribute done on this device

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The block's arg-max of (best, besti), ties to the lowest index: a warp
// shuffle, then one across the 32 warps.  Thread 0 writes step s's pick
// (0 when no point is valid, besti == n) to o[s] and *next; ends with a
// barrier, so every thread may read *next.
__device__ __forceinline__ void pick_step(float best, int besti, int n, int s, int* o,
                                          float* red_v, int* red_i, int* next) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    argmax_step(best, besti, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, besti, off));
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = besti;
  }
  __syncthreads();
  if (warp == 0) {
    best = red_v[lane];
    besti = red_i[lane];
    for (int off = 16; off > 0; off >>= 1)
      argmax_step(best, besti, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, besti, off));
    if (lane == 0) {
      const int nxt = besti == n ? 0 : besti;
      *next = nxt;
      o[s] = nxt;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* px = smem;
  float* py = px + n;
  float* pz = py + n;
  float* md = pz + n;  // running min-distance; -1 marks an invalid point
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_next;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;

  for (int i = tid; i < n; i += kThreads) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    px[i] = x;
    py[i] = y;
    pz[i] = z;
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    md[i] = mag > 1e-3f ? 1e10f : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float lx = px[last], ly = py[last], lz = pz[last];
    float best = -1.0f;  // below every valid candidate (distances are >= 0)
    int besti = n;       // n == "no valid point"
    for (int i = tid; i < n; i += kThreads) {
      float m = md[i];
      if (m < 0.0f) continue;
      const float dx = __fsub_rn(px[i], lx);
      const float dy = __fsub_rn(py[i], ly);
      const float dz = __fsub_rn(pz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      m = fminf(m, d);
      md[i] = m;
      if (m > best) {  // i increases along the loop: ties keep the lower index
        best = m;
        besti = i;
      }
    }
    pick_step(best, besti, n, s, o, red_v, red_i, &s_next);
    last = s_next;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_global_kernel(const float* __restrict__ xyz, int n, int npoint, float* __restrict__ scratch,
                  int* __restrict__ out) {
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_next;

  const int b = blockIdx.x, tid = threadIdx.x;
  const float* p = xyz + (size_t)b * n * 3;
  float* md = scratch + (size_t)b * n;  // running min-distance; -1 marks an invalid point
  int* o = out + (size_t)b * npoint;

  for (int i = tid; i < n; i += kThreads) {
    const float x = __ldg(p + 3 * i), y = __ldg(p + 3 * i + 1), z = __ldg(p + 3 * i + 2);
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    md[i] = mag > 1e-3f ? 1e10f : -1.0f;
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int s = 1; s < npoint; ++s) {
    const float lx = __ldg(p + 3 * last), ly = __ldg(p + 3 * last + 1), lz = __ldg(p + 3 * last + 2);
    float best = -1.0f;
    int besti = n;
    for (int i = tid; i < n; i += kThreads) {
      float m = md[i];
      if (m < 0.0f) continue;
      const float dx = __fsub_rn(__ldg(p + 3 * i), lx);
      const float dy = __fsub_rn(__ldg(p + 3 * i + 1), ly);
      const float dz = __fsub_rn(__ldg(p + 3 * i + 2), lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      m = fminf(m, d);
      md[i] = m;
      if (m > best) {
        best = m;
        besti = i;
      }
    }
    pick_step(best, besti, n, s, o, red_v, red_i, &s_next);
    last = s_next;
  }
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// xyz: (B, N, 3) float32 contiguous; out: (B, npoint) int32; scratch: a
// (B, N) float32 buffer on the device for clouds above kSmemPoints points
// (null otherwise).
int nsdp_fps(const float* xyz, int B, int N, int npoint, float* scratch, int* out, int device,
             void* stream) {
  if (B < 1 || N < 1 || npoint < 1 || (N > kSmemPoints && scratch == nullptr) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && !g_opted_in[device]) {
    err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    g_opted_in[device] = err == cudaSuccess;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a failed call also sets the last error: clear it
    return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= kSmemPoints)
    fps_kernel<<<B, kThreads, (size_t)N * 4 * sizeof(float), s>>>(xyz, N, npoint, out);
  else
    fps_global_kernel<<<B, kThreads, 0, s>>>(xyz, N, npoint, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
