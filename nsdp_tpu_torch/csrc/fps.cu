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
// the points, a warp-shuffle arg-max then one across the 32 warps.  Three
// variants share that step and its arithmetic, chosen by the cloud's size
// (ops/fps.py::variant):
//   * fps_kernel, up to kSmemPoints (14,496) points: the cloud and the
//     running min-distance in shared memory (16 bytes a point);
//   * fps_cluster_kernel, up to kMaxCluster * kClusterBlockPoints (115,712)
//     points: one thread-block cluster of C <= 8 blocks per batch element
//     (the wrapper takes 8: the fastest at every size measured), block r
//     holding the contiguous range [r * per, (r + 1) * per) of the cloud
//     (per = ceil(N / C)) and its running min-distance in its own shared
//     memory, so nothing in the step loop touches device memory.  A step is
//     each block's arg-max over its range (global indices), which C lanes
//     of its first warp write into a slot of every block's shared memory
//     (distributed shared memory) and announce with a remote arrive on that
//     block's mbarrier; each block waits on its own mbarrier for the C
//     picks and every warp takes their arg-max, ties to the lowest global
//     index.  The slots and mbarriers alternate by the step's parity: a
//     block can only be a step ahead of a peer, so a slot is never written
//     while it is read.  A whole-cluster barrier a step (barrier.cluster)
//     in their place measured slower on an H100.  The arg-maxes reduce the
//     distances' bits as ints (redux.sync), and a point is one float4;
//   * fps_global_kernel, any larger cloud: the running min-distance in a
//     (B, N) float32 scratch in device memory, the coordinates read through
//     the read-only cache.  Each thread reads and writes only its own
//     points' distances, so no step needs more than the one arg-max.  The
//     cloud streams through the SM from L2 at every step (20 bytes a
//     point), and that stream, not the arg-max, bounds it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
// Opt-in shared memory of an sm_90 block, less room for the static arrays;
// fps_kernel takes 16 bytes a point, so up to kSmemPoints points
// (ops/fps.py SMEM_POINTS); larger clouds take fps_global_kernel.
constexpr int kMaxSmem = 232448 - 512;
constexpr int kSmemPoints = kMaxSmem / 16;
// fps_cluster_kernel: clusters of up to the portable 8 blocks, each holding
// up to kClusterBlockPoints points (16 bytes a point; its static arrays
// take up to 1 KB), so up to 8 * 14,464 = 115,712 points (ops/fps.py
// CLUSTER_POINTS).
constexpr int kMaxCluster = 8;
constexpr int kClusterSmem = 232448 - 1024;
constexpr int kClusterBlockPoints = kClusterSmem / 16;
// Returned when no cluster of the asked size and shared memory fits on the
// card (cudaOccupancyMaxActiveClusters is 0); nsdp_error_string names it.
constexpr int kErrNoCluster = -1;
bool g_opted_in[kMaxDevices];  // cudaFuncSetAttribute done on this device
// per device and cluster size, the most dynamic shared memory a block of
// fps_cluster_kernel was shown to launch with (0: not asked yet)
size_t g_cluster_fits[kMaxDevices][kMaxCluster + 1];

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

// The arg-max of (key, idx) over the warp, ties to the lowest idx; every
// lane gets it.  key is a distance's bits as an int: for the distances here
// (>= 0) and the sentinel -1 (negative as an int too) the ints order as the
// floats do.
__device__ __forceinline__ void warp_argmax(int& key, int& idx) {
  const int mx = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == mx ? idx : INT_MAX);
  key = mx;
}

// One block's pick of a step, as its peers receive it (fps_cluster_kernel).
struct alignas(16) Slot {
  int key;  // bits of its running min-distance; of -1 when the block has no valid point
  int i;    // its global index; n when the block has no valid point
  float x, y, z;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz, int n, int npoint, int* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ float4 pts[];  // x, y, z, running min-distance (-1: invalid)
  __shared__ int red_k[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ Slot inbox[2][kMaxCluster];  // by the step's parity, one slot per block
  __shared__ __align__(8) unsigned long long full[2];  // mbarriers: the inbox is full

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int b = blockIdx.x / c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + c - 1) / c, lo = r * per, cnt = max(0, min(per, n - lo));
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;

  if (tid == 0) {  // each completes a phase when all c blocks have arrived
    for (int j = 0; j < 2; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&full[j])), "r"(c)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < cnt; i += kThreads) {
    const float* q = p + 3 * (size_t)(lo + i);
    const float x = q[0], y = q[1], z = q[2];
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    pts[i] = make_float4(x, y, z, mag > 1e-3f ? 1e10f : -1.0f);
  }
  const float x0 = p[0], y0 = p[1], z0 = p[2];  // the first pick, and any all-invalid one
  if (r == 0 && tid == 0) o[0] = 0;
  cluster.sync();  // every block's barriers are set up before any peer arrives on them

  float lx = x0, ly = y0, lz = z0;
  for (int s = 1; s < npoint; ++s) {
    float best = -1.0f;  // below every valid candidate (distances are >= 0)
    int besti = n;       // n == "no valid point", in the whole cloud too
    for (int i = tid; i < cnt; i += kThreads) {
      const float4 pt = pts[i];
      if (pt.w < 0.0f) continue;
      const float dx = __fsub_rn(pt.x, lx);
      const float dy = __fsub_rn(pt.y, ly);
      const float dz = __fsub_rn(pt.z, lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(pt.w, d);
      pts[i].w = m;
      if (m > best) {  // i increases along the loop: ties keep the lower index
        best = m;
        besti = lo + i;
      }
    }
    // the block's arg-max
    int key = __float_as_int(best), idx = besti;
    warp_argmax(key, idx);
    if (lane == 0) {
      red_k[warp] = key;
      red_i[warp] = idx;
    }
    __syncthreads();
    const int par = s & 1;
    if (warp == 0) {  // lane q sends the pick to block q and arrives on its barrier
      key = red_k[lane];
      idx = red_i[lane];
      warp_argmax(key, idx);
      if (lane < c) {
        const float4 pt = pts[idx == n ? 0 : idx - lo];  // coordinates unread when idx == n
        *cluster.map_shared_rank(&inbox[par][r], lane) = Slot{key, idx, pt.x, pt.y, pt.z};
        unsigned peer;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(peer)
                     : "r"(smem_addr(&full[par])), "r"(lane));
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(peer)
                     : "memory");
      }
    }
    // wait for the c picks of this step: barrier `par` completes its phase
    // ((s - 1) >> 1) & 1 here
    const unsigned bar = smem_addr(&full[par]), phase = ((s - 1) >> 1) & 1;
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar), "r"(phase)
          : "memory");
    // the cluster's arg-max over the inbox, ties to the lowest global index;
    // every warp takes it, so no block barrier follows
    int k2 = INT_MIN, i2 = INT_MAX;  // a lane past c never wins
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (lane < c) {
      const Slot q = inbox[par][lane];
      k2 = q.key;
      i2 = q.i;
      sx = q.x;
      sy = q.y;
      sz = q.z;
    }
    const int own = i2;
    warp_argmax(k2, i2);
    if (i2 == n) {  // no valid point anywhere: pick 0, which updates nothing
      i2 = 0;
      lx = x0;
      ly = y0;
      lz = z0;
    } else {  // the winner's coordinates from the lane that holds its slot
      const int src = __ffs(__ballot_sync(kFull, own == i2)) - 1;
      lx = __shfl_sync(kFull, sx, src);
      ly = __shfl_sync(kFull, sy, src);
      lz = __shfl_sync(kFull, sz, src);
    }
    if (r == 0 && tid == 0) o[s] = i2;
  }
  cluster.sync();  // no block exits while a peer may still write to it
}

cudaError_t opt_in(int device) {
  if (g_opted_in[device]) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kClusterSmem);
  g_opted_in[device] = err == cudaSuccess;
  return err;
}

// Launch fps_cluster_kernel with clusters of c blocks; before the first
// launch at a size, ask whether such a cluster fits on the card at all.
int launch_cluster(const float* xyz, int B, int N, int npoint, int c, int* out, int device,
                   cudaStream_t stream) {
  const size_t smem = (size_t)((N + c - 1) / c) * 4 * sizeof(float);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > g_cluster_fits[device][c]) {
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, (const void*)fps_cluster_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kErrNoCluster;
    g_cluster_fits[device][c] = smem;
  }
  return (int)cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, N, npoint, out);
}

}  // namespace

extern "C" {

const char* nsdp_error_string(int err) {
  if (err == kErrNoCluster)
    return "no thread-block cluster of this size and shared memory fits on the card"
           " (cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString((cudaError_t)err);
}

// xyz: (B, N, 3) float32 contiguous; out: (B, npoint) int32.  The variant
// (ops/fps.py::variant): scratch, a (B, N) float32 buffer on the device,
// takes fps_global_kernel; else cluster >= 2 takes fps_cluster_kernel with
// clusters of that many blocks (at most kMaxCluster, each holding at most
// kClusterBlockPoints points); else fps_kernel (N <= kSmemPoints).
int nsdp_fps(const float* xyz, int B, int N, int npoint, int cluster, float* scratch, int* out,
             int device, void* stream) {
  const bool global = scratch != nullptr, clustered = !global && cluster >= 2;
  if (B < 1 || N < 1 || npoint < 1 || device < 0 || device >= kMaxDevices ||
      (clustered && (cluster > kMaxCluster || (N + cluster - 1) / cluster > kClusterBlockPoints)) ||
      (!global && !clustered && N > kSmemPoints))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = opt_in(device);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a failed call also sets the last error: clear it
    return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (global) {
    fps_global_kernel<<<B, kThreads, 0, s>>>(xyz, N, npoint, scratch, out);
  } else if (clustered) {
    const int e = launch_cluster(xyz, B, N, npoint, cluster, out, device, s);
    if (e != 0) {
      cudaGetLastError();
      return e;
    }
  } else {
    fps_kernel<<<B, kThreads, (size_t)N * 4 * sizeof(float), s>>>(xyz, N, npoint, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
