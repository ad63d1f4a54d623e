// Farthest point sampling (sm_90a): one CTA a cloud up to 8192 points, a
// thread-block cluster a cloud above, a streaming CTA beyond the cluster's
// registers.
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/fps.py:67 fps_pallas
// (_fps_kernel). Same contract: xyz [B, N, 3] f32 and start [B] i32 in,
// [B, npoint] i32 out; min_dist starts at 1e10; each step takes the argmax
// of the running min squared distance, ties to the LOWEST index; npoint > N
// wraps onto index 0 once every point is chosen; a start outside [0, N)
// writes -1 for that cloud.
//
// What bounds it: latency. The npoint steps are a recurrence (the next
// centroid is the argmax over distances to this one), so a step cannot
// start before the last has ended, and the cloud (N x 12 bytes) is read
// from device memory once. The bytes-and-operations bound (microseconds)
// says nothing useful here; the yardstick is the time of one step: a
// distance pass over the thread's points, then the way from the threads'
// maxima to the next centroid's coordinates in every thread.
//
// fps_kernel (N <= 8192) shortens that way. Each thread keeps its points
// and their running min-distance in registers (SLOTS points per thread,
// point i on thread i % T, slot i / T); the cloud also lies in shared
// memory as float4, so the next centroid is one broadcast load by index,
// not three dependent loads from device memory. A running min-distance is
// >= 0 and a padding slot -1, so the float's bits order as a signed int
// and the argmax is two hardware warp reductions (redux.sync): the max of
// the bits, then the min index among the lanes that hold it, which is the
// lowest index on ties by construction. Lane 0 of each warp writes (bits,
// index) to its slot of a double-buffered array; after ONE barrier every
// warp reduces the <= 32 partials itself with the same two reductions.
// No second barrier, no winner written back and read again. The thread
// count per cloud follows N: 4 points a thread up to 512 threads (8
// points a thread at N = 4096, 16 at 8192), the fastest of 32 .. 1024
// threads measured at every level. Fewer, fatter threads make the barrier
// and the second reduction cheaper and give the distance pass independent
// chains to overlap; half of a step at N = 4096 is then the pass itself
// (12 instructions a point on one SM's 128 lanes).
//
// fps_cluster_kernel (8192 < N <= 16 * 8192 = 131,072 where the card can
// place a cluster of 16 CTAs, else 8 * 8192): a cloud is split over the
// CTAs of a thread-block cluster, a contiguous slice each, and each CTA
// keeps its slice and its running min-distances in registers as fps_kernel
// does (at most 512 threads x 16 slots), so a step reads no device memory.
// A step: the CTA's argmax (the same two redux.sync reductions, one
// __syncthreads, every warp reducing the partials); the thread that holds
// the CTA's winner hands it, with its coordinates, to its warp, whose
// lanes store (bits, index, x, y, z) into this step's slot of every CTA's
// shared memory with st.async (distributed shared memory, double-buffered
// by the step's parity), each store counted on the receiving CTA's
// mbarrier of that parity; every thread waits on its own CTA's mbarrier,
// then every warp reduces the <= 16 slots itself, ties to the lowest
// index, and reads the next centroid's coordinates from the winning slot.
// No CTA keeps a copy of the cloud. What bounds it: the same recurrence; a
// step is the slice's distance pass, the CTA's barrier and one round trip
// of remote stores. A cluster-wide barrier in place of the mbarriers (all
// threads of all CTAs arriving, every store released) took 1.40 us a step
// at [16, 10000] against their 0.91 with the same CTAs (PERF.md). The CTA
// count follows N: ceil(N / kClusterCtaPoints), at least 2 and at most 16
// (8 where the card cannot place 16); kClusterCtaPoints and the points a
// thread (kClusterPointsPerThread) were chosen by measurement at the
// 10,000- and 16,384-point first levels (PERF.md).
//
// fps_stream_kernel (N beyond the cluster's capacity, up to 2^22): one CTA
// of 1024 threads a cloud; the kernel first packs its cloud into a
// device-memory workspace as float4 (x, y, z, 0) beside a float running
// min-distance per point, and each step streams both from there: point i
// on thread i % 1024, visited in ascending index, so the per-thread strict
// > keeps the first on ties, and the argmax is the same two redux.sync
// reductions. A thread only ever reads and writes its own points'
// min-distances, so they need no barrier; the one barrier a step is the
// argmax's. The next centroid is one float4 load of the packed cloud
// (never written after the packing barrier). What bounds it: one SM's L2
// bandwidth, some 24 bytes a point a step (the packed point and its
// min-distance read, the min-distance written).
//
// Why each N goes where it goes: up to 8192 the cloud fits one CTA's
// registers and shared memory, and one CTA a cloud leaves the other SMs to
// the other clouds; above, one CTA's pass would be an L2 stream, and a
// cluster keeps the cloud in registers spread over several SMs; beyond the
// cluster's registers the stream is what is left. (At the seam the cluster
// is no slower: 767 ns a step at 8193 against 809 at 8192 in one CTA, so
// the register kernel's range might shrink; not measured below 8192.)
// psg_fps_route(N) says which kernel a cloud takes; the op reads it there.
//
// The squared distance is written with explicit round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs: the result is then
// bit-identical to the plain version's dx*dx + dy*dy + dz*dz.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 8192;  // 16 slots of kMaxThreads
constexpr int kPointsPerThread = 4;  // T = N / 4 in whole warps, at most kMaxThreads
constexpr int kClusterCtaPoints = 2048;  // a cluster's CTAs: ceil(N / this), 2 .. 16
constexpr int kClusterPointsPerThread = 16;  // its CTAs' threads, as kPointsPerThread
constexpr int kPortableCtas = 8;         // the largest portable cluster
constexpr int kClusterMaxCtas = 16;      // the largest, where the card places it
constexpr int kClusterMaxN = kClusterMaxCtas * kMaxN;  // ops/cuda/fps.py's CLUSTER_MAX_N
constexpr int kStreamThreads = 1024;  // fps_stream_kernel's CTA
constexpr int kStreamMaxN = 1 << 22;  // its ceiling, ops/cuda/fps.py's MAX_N
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kPad = -1.0f;  // below every real distance; its bits are
                               // below every non-negative float's as an int

enum Route { kRegister = 0, kCluster = 1, kStream = 2 };

// (max value's bits, lowest index holding it) over the warp
__device__ __forceinline__ int2 warp_argmax(int bits, int idx) {
  const int m = __reduce_max_sync(kFullMask, bits);
  return make_int2(m, __reduce_min_sync(kFullMask, bits == m ? idx : INT_MAX));
}

// (x - cx)^2 + (y - cy)^2 + (z - cz)^2, rounded as the plain version (see top)
__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// every thread of the cluster: the stores before it are seen by every
// thread after it (once, before the first exchange)
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the same shared-memory word in the CTA of the given rank of the cluster
__device__ __forceinline__ unsigned peer_u32(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
}

// the one arrival of a phase, which also expects its bytes
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// until the phase of that parity has completed; the remote stores it
// counted are seen after it
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t"
      "}" ::"r"(bar), "r"(parity) : "memory");
}

// (bits, index, x, y) and z into a peer's slot, counted on its mbarrier
__device__ __forceinline__ void send(unsigned slot, unsigned slot_z, unsigned bar, int4 v,
                                     float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(slot), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(slot_z), "r"(__float_as_int(z)), "r"(bar) : "memory");
}

constexpr unsigned kSlotBytes = sizeof(int4) + sizeof(float);

template <int SLOTS>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float4 cloud[];  // [N] (x, y, z, unused)
  __shared__ int2 partial[2][32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  int* o = out + (size_t)b * npoint;

  float px[SLOTS], py[SLOTS], pz[SLOTS], md[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int i = s * T + t;
    if (i < N) {
      px[s] = p[3 * i];
      py[s] = p[3 * i + 1];
      pz[s] = p[3 * i + 2];
      md[s] = 1e10f;
      cloud[i] = make_float4(px[s], py[s], pz[s], 0.f);
    } else {  // padding slot: never chosen
      px[s] = py[s] = pz[s] = 0.f;
      md[s] = kPad;
    }
  }

  int far = start[b];
  if (far < 0 || far >= N) {  // never read outside the cloud
    for (int j = t; j < npoint; j += T) o[j] = -1;
    return;
  }
  __syncthreads();
  int2* mine = &partial[0][warp];
  const int2* theirs = &partial[0][lane];
  for (int j = 0; j < npoint; ++j) {
    if (t == 0) o[j] = far;
    if (j == npoint - 1) break;
    const float4 c = cloud[far];

    float bv = kPad;
    int bs = -1;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      // d >= 0 leaves padding slots at -1
      md[s] = fminf(md[s], sq_dist(px[s], py[s], pz[s], c.x, c.y, c.z));
      // slots run in ascending index, so a strict > keeps the first
      if (md[s] > bv) {
        bv = md[s];
        bs = s;
      }
    }
    int2 best = warp_argmax(__float_as_int(bv), bs < 0 ? INT_MAX : bs * T + t);
    if (nwarps > 1) {
      if (lane == 0) mine[(j & 1) * 32] = best;
      // the one barrier of the step; the other buffer is free again only
      // after the next one, when every warp has read it
      __syncthreads();
      best = lane < nwarps ? theirs[(j & 1) * 32] : make_int2(__float_as_int(kPad), INT_MAX);
      best = warp_argmax(best.x, best.y);
    }
    far = best.y;
  }
}

// 8192 < N <= the cluster's capacity: a slice of per_cta points a CTA (see top)
template <int SLOTS>
__global__ void __launch_bounds__(kMaxThreads)
fps_cluster_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                   int* __restrict__ out, int N, int npoint, int ctas, int per_cta) {
  __shared__ int2 partial[2][32];
  // each CTA's winner of a step, by step parity and CTA rank: (bits, index,
  // x, y) and z, written by the winner's CTA; an mbarrier a parity counts them
  __shared__ int4 win[2][kClusterMaxCtas];
  __shared__ float win_z[2][kClusterMaxCtas];
  __shared__ __align__(8) unsigned long long bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / ctas;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const int lo = rank * per_cta;  // the slice [lo, lo + per_cta) of the cloud
  const float* p = xyz + (size_t)b * N * 3;
  int* o = out + (size_t)b * npoint;

  float px[SLOTS], py[SLOTS], pz[SLOTS], md[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int i = lo + s * T + t;
    if (s * T + t < per_cta && i < N) {
      px[s] = p[3 * i];
      py[s] = p[3 * i + 1];
      pz[s] = p[3 * i + 2];
      md[s] = 1e10f;
    } else {  // padding slot: never chosen
      px[s] = py[s] = pz[s] = 0.f;
      md[s] = kPad;
    }
  }

  int far = start[b];
  if (far < 0 || far >= N) {  // never read outside the cloud; every CTA leaves
    if (rank == 0)
      for (int j = t; j < npoint; j += T) o[j] = -1;
    return;
  }
  float cx = p[3 * far], cy = p[3 * far + 1], cz = p[3 * far + 2];
  // A phase of an mbarrier is one step: it completes when thread 0 has
  // armed it with the bytes it expects (one arrival) and the CTAs' stores
  // have brought them. Thread 0 arms a step's phase before this CTA sends
  // the step before, and no CTA sends a step before it has every winner of
  // the step before: so no store reaches a phase before it is armed, and
  // the parity's last phase (two steps back) has completed by then.
  const unsigned expects = ctas * kSlotBytes;
  if (t == 0) {
    mbar_init(smem_u32(&bar[0]), 1);
    mbar_init(smem_u32(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (npoint > 1) mbar_expect(smem_u32(&bar[0]), expects);
  }
  // every CTA of the cluster is running, its mbarriers ready, before any
  // writes into its shared memory
  cluster_barrier();
  for (int j = 0; j < npoint; ++j) {
    if (rank == 0 && t == 0) o[j] = far;
    if (j == npoint - 1) break;
    const int par = j & 1;

    float bv = kPad, bx = 0.f, by = 0.f, bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      md[s] = fminf(md[s], sq_dist(px[s], py[s], pz[s], cx, cy, cz));
      // slots run in ascending index, so a strict > keeps the first
      if (md[s] > bv) {
        bv = md[s];
        bi = lo + s * T + t;
        bx = px[s];
        by = py[s];
        bz = pz[s];
      }
    }
    if (t == 0 && j + 1 < npoint - 1) mbar_expect(smem_u32(&bar[par ^ 1]), expects);
    int2 best = warp_argmax(__float_as_int(bv), bi);
    if (lane == 0) partial[par][warp] = best;
    __syncthreads();  // the CTA's one barrier of the step, as in fps_kernel
    best = lane < nwarps ? partial[par][lane] : make_int2(__float_as_int(kPad), INT_MAX);
    best = warp_argmax(best.x, best.y);
    // the warp of the thread that holds the CTA's winner sends it to every
    // CTA (a CTA without points sends its padding from warp 0)
    const int owner = best.y == INT_MAX ? 0 : (best.y - lo) % T;
    if (warp == owner >> 5) {
      const float wx = __shfl_sync(kFullMask, bx, owner & 31);
      const float wy = __shfl_sync(kFullMask, by, owner & 31);
      const float wz = __shfl_sync(kFullMask, bz, owner & 31);
      if (lane < ctas)
        send(peer_u32(smem_u32(&win[par][rank]), lane),
             peer_u32(smem_u32(&win_z[par][rank]), lane),
             peer_u32(smem_u32(&bar[par]), lane),
             make_int4(best.x, best.y, __float_as_int(wx), __float_as_int(wy)), wz);
    }
    mbar_wait(smem_u32(&bar[par]), (j >> 1) & 1);
    // every warp reduces the <= 16 slots, ties to the lowest index
    const int4 w = lane < ctas ? win[par][lane] : make_int4(__float_as_int(kPad), INT_MAX, 0, 0);
    const int2 g = warp_argmax(w.x, w.y);
    const int src = __ffs(__ballot_sync(kFullMask, lane < ctas && w.y == g.y)) - 1;
    far = g.y;
    const int4 c = win[par][src];
    cx = __int_as_float(c.z);
    cy = __int_as_float(c.w);
    cz = win_z[par][src];
  }
}

// N beyond the cluster's capacity: the cloud and its min-distances in
// device memory (see top)
__global__ void __launch_bounds__(kStreamThreads)
fps_stream_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
                  int* __restrict__ out, float4* __restrict__ packed,
                  float* __restrict__ min_dist, int N, int npoint) {
  __shared__ int2 partial[2][32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  float4* cloud = packed + (size_t)b * N;
  float* md = min_dist + (size_t)b * N;
  int* o = out + (size_t)b * npoint;

  int far = start[b];
  if (far < 0 || far >= N) {  // never read outside the cloud
    for (int j = t; j < npoint; j += T) o[j] = -1;
    return;
  }
  for (int i = t; i < N; i += T) {
    cloud[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f);
    md[i] = 1e10f;
  }
  __syncthreads();  // every thread reads centroids packed by the others
  int2* mine = &partial[0][warp];
  const int2* theirs = &partial[0][lane];
  for (int j = 0; j < npoint; ++j) {
    if (t == 0) o[j] = far;
    if (j == npoint - 1) break;
    const float4 c = cloud[far];

    float bv = kPad;
    int bi = INT_MAX;
#pragma unroll 4
    for (int i = t; i < N; i += T) {
      const float4 q = cloud[i];
      const float m = fminf(md[i], sq_dist(q.x, q.y, q.z, c.x, c.y, c.z));
      md[i] = m;
      if (m > bv) {  // ascending index: a strict > keeps the first
        bv = m;
        bi = i;
      }
    }
    int2 best = warp_argmax(__float_as_int(bv), bi);
    if (lane == 0) mine[(j & 1) * 32] = best;
    // the one barrier of the step, as in fps_kernel
    __syncthreads();
    best = lane < nwarps ? theirs[(j & 1) * 32] : make_int2(__float_as_int(kPad), INT_MAX);
    best = warp_argmax(best.x, best.y);
    far = best.y;
  }
}

template <int SLOTS>
cudaError_t launch(const float* x, const int* s, int* o, int B, int N, int npoint,
                   int threads, cudaStream_t st) {
  const size_t smem = (size_t)N * sizeof(float4);
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxN * (int)sizeof(float4));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<SLOTS><<<B, threads, smem, st>>>(x, s, o, N, npoint);
  return cudaGetLastError();
}

// the largest cluster the card can place: 16 CTAs of fps_cluster_kernel<16>
// at kMaxThreads where cudaOccupancyMaxActiveClusters says so, else 8
// (asked once a device)
int max_cluster_ctas() {
  static int known[64];  // 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return kPortableCtas;
  if (known[dev] == 0) {
    int clusters = 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterMaxCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kClusterMaxCtas);
    cfg.blockDim = dim3(kMaxThreads);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const bool placed =
        cudaFuncSetAttribute(fps_cluster_kernel<16>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<16>, &cfg) == cudaSuccess &&
        clusters > 0;
    cudaGetLastError();  // a refused query leaves no error behind
    known[dev] = placed ? kClusterMaxCtas : kPortableCtas;
  }
  return known[dev];
}

// the CTAs of a cluster for a cloud of N > kMaxN, or 0 beyond its capacity
int cluster_ctas(int N) {
  int g = (N + kClusterCtaPoints - 1) / kClusterCtaPoints;
  g = g < 2 ? 2 : g;
  const int most = max_cluster_ctas();
  g = g > most ? most : g;
  return (N + g - 1) / g <= kMaxN ? g : 0;
}

template <int SLOTS>
cudaError_t launch_cluster(const float* x, const int* s, int* o, int B, int N, int npoint,
                           int ctas, int threads, int per_cta, cudaStream_t st) {
  if (ctas > kPortableCtas) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_cluster_kernel<SLOTS>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fps_cluster_kernel<SLOTS>, x, s, o, N, npoint, ctas, per_cta);
}

// threads for n points a CTA: per_thread points a thread in whole warps,
// at most kMaxThreads; then the slots a thread
int threads_for(int n, int per_thread) {
  const int threads = ((n + per_thread - 1) / per_thread + 31) / 32 * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

// Which kernel takes a cloud of N points: 0 fps_kernel (N <= 8192), 1
// fps_cluster_kernel (up to 16 * 8192 where the card places a cluster of
// 16, else 8 * 8192), 2 fps_stream_kernel (beyond, up to 2^22); -1 outside
// the contract. The op counts each launch by this.
extern "C" int psg_fps_route(int N) {
  if (N < 1 || N > kStreamMaxN) return -1;
  if (N <= kMaxN) return kRegister;
  return cluster_ctas(N) > 0 ? kCluster : kStream;
}

// Floats of workspace a point of a cloud of N needs: a packed float4 and
// a min-distance where fps_stream_kernel takes the cloud, else 0.
extern "C" int psg_fps_workspace_floats(int N) {
  return psg_fps_route(N) == kStream ? (int)((sizeof(float4) + sizeof(float)) / sizeof(float))
                                     : 0;
}

// workspace: B * N * psg_fps_workspace_floats(N) floats (the packed cloud,
// then the min-distances); null where that is 0
extern "C" int psg_fps(const void* xyz, const void* start, void* out, void* workspace,
                       int B, int N, int npoint, void* stream) {
  const int route = psg_fps_route(N);
  if (B < 0 || route < 0 || npoint < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  if (route == kStream) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    float4* packed = static_cast<float4*>(workspace);
    float* min_dist = reinterpret_cast<float*>(packed + (size_t)B * N);
    fps_stream_kernel<<<B, kStreamThreads, 0, st>>>(x, s, o, packed, min_dist, N, npoint);
    return (int)cudaGetLastError();
  }
  if (route == kCluster) {
    const int ctas = cluster_ctas(N);
    const int per_cta = (N + ctas - 1) / ctas;
    const int threads = threads_for(per_cta, kClusterPointsPerThread);
    const int slots = (per_cta + threads - 1) / threads;
    if (slots <= 1) return (int)launch_cluster<1>(x, s, o, B, N, npoint, ctas, threads, per_cta, st);
    if (slots <= 2) return (int)launch_cluster<2>(x, s, o, B, N, npoint, ctas, threads, per_cta, st);
    if (slots <= 4) return (int)launch_cluster<4>(x, s, o, B, N, npoint, ctas, threads, per_cta, st);
    if (slots <= 8) return (int)launch_cluster<8>(x, s, o, B, N, npoint, ctas, threads, per_cta, st);
    return (int)launch_cluster<16>(x, s, o, B, N, npoint, ctas, threads, per_cta, st);
  }
  const int threads = threads_for(N, kPointsPerThread);
  const int slots = (N + threads - 1) / threads;
  if (slots <= 1) return (int)launch<1>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 2) return (int)launch<2>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 4) return (int)launch<4>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 8) return (int)launch<8>(x, s, o, B, N, npoint, threads, st);
  return (int)launch<16>(x, s, o, B, N, npoint, threads, st);
}
