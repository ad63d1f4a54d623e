// Farthest point sampling, one CTA per cloud (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/fps.py:_fps_kernel
// (entry point fps_pallas). Same contract: xyz [B, N, 3] f32 and start [B]
// i32 in, [B, npoint] i32 out; min_dist starts at 1e10; each step takes
// the argmax of the running min squared distance, ties to the LOWEST
// index; npoint > N wraps onto index 0 once every point is chosen; a start
// outside [0, N) writes -1 for that cloud.
//
// What bounds it: latency. The npoint steps are a recurrence (the next
// centroid is the argmax over distances to this one), so a step cannot
// start before the last has ended, and the cloud (N x 12 bytes) is read
// from device memory once. The bytes-and-operations bound (microseconds)
// says nothing useful here; the yardstick is the time of one step: a
// distance pass over the thread's points, then the way from the threads'
// maxima to the next centroid's coordinates in every thread.
//
// Design: it shortens that way. Each thread keeps its points and their
// running min-distance in registers (SLOTS points per thread, point i on
// thread i % T, slot i / T); the cloud also lies in shared memory as
// float4, so the next centroid is one broadcast load by index, not three
// dependent loads from device memory. A running min-distance is >= 0 and a
// padding slot -1, so the float's bits order as a signed int and the
// argmax is two hardware warp reductions (redux.sync): the max of the
// bits, then the min index among the lanes that hold it, which is the
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
// Not done: splitting a cloud over the blocks of a cluster. One CTA per
// cloud leaves most SMs idle at small B, but at N <= 8192 the distance
// pass is a few instructions a thread, and a cluster-wide barrier a step
// would cost more than the shorter pass saves.
//
// Above 8192 points (up to 2^22) a second kernel, fps_stream_kernel, takes
// the cloud: it no longer fits in one thread's registers nor in shared
// memory. One CTA of 1024 threads a cloud; the kernel first packs its cloud
// into a device-memory workspace as float4 (x, y, z, 0) beside a float
// running min-distance per point, and each step streams both from there
// (the L2 holds a [16, 10000, 3] batch many times over): point i on thread
// i % 1024, visited in ascending index, so the per-thread strict > keeps
// the first on ties, and the argmax is the same two redux.sync reductions.
// A thread only ever reads and writes its own points' min-distances, so
// they need no barrier; the one barrier a step is the argmax's. The next
// centroid is one float4 load of the packed cloud (never written after
// the packing barrier).
//
// The squared distance is written with explicit round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs: the result is then
// bit-identical to the plain version's dx*dx + dy*dy + dz*dz.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 8192;  // 16 slots of kMaxThreads
constexpr int kPointsPerThread = 4;  // T = N / 4 in whole warps, at most kMaxThreads
constexpr int kStreamThreads = 1024;  // fps_stream_kernel's CTA
constexpr int kStreamMaxN = 1 << 22;  // its ceiling, ops/cuda/fps.py's MAX_N
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kPad = -1.0f;  // below every real distance; its bits are
                               // below every non-negative float's as an int

// (max value's bits, lowest index holding it) over the warp
__device__ __forceinline__ int2 warp_argmax(int bits, int idx) {
  const int m = __reduce_max_sync(kFullMask, bits);
  return make_int2(m, __reduce_min_sync(kFullMask, bits == m ? idx : INT_MAX));
}

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
      const float dx = __fsub_rn(px[s], c.x);
      const float dy = __fsub_rn(py[s], c.y);
      const float dz = __fsub_rn(pz[s], c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[s] = fminf(md[s], d);  // d >= 0 leaves padding slots at -1
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

// N > kMaxN: the cloud and its min-distances in device memory (see top)
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
      const float dx = __fsub_rn(q.x, c.x);
      const float dy = __fsub_rn(q.y, c.y);
      const float dz = __fsub_rn(q.z, c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[i], d);
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

}  // namespace

// Floats of workspace a point of a cloud of N needs: 0 where fps_kernel
// takes the cloud, else a packed float4 and a min-distance. The op sizes
// psg_fps's workspace from this and counts a launch with a workspace as
// fps_stream_kernel's.
extern "C" int psg_fps_workspace_floats(int N) {
  return N > kMaxN ? (int)((sizeof(float4) + sizeof(float)) / sizeof(float)) : 0;
}

// workspace: B * N * psg_fps_workspace_floats(N) floats (the packed cloud,
// then the min-distances); null where that is 0
extern "C" int psg_fps(const void* xyz, const void* start, void* out, void* workspace,
                       int B, int N, int npoint, void* stream) {
  if (B < 0 || N < 1 || npoint < 1 || N > kStreamMaxN)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (psg_fps_workspace_floats(N) > 0) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    float4* packed = static_cast<float4*>(workspace);
    float* min_dist = reinterpret_cast<float*>(packed + (size_t)B * N);
    fps_stream_kernel<<<B, kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xyz), static_cast<const int*>(start),
        static_cast<int*>(out), packed, min_dist, N, npoint);
    return (int)cudaGetLastError();
  }
  int threads = ((N + kPointsPerThread - 1) / kPointsPerThread + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const int slots = (N + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  if (slots <= 1) return (int)launch<1>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 2) return (int)launch<2>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 4) return (int)launch<4>(x, s, o, B, N, npoint, threads, st);
  if (slots <= 8) return (int)launch<8>(x, s, o, B, N, npoint, threads, st);
  return (int)launch<16>(x, s, o, B, N, npoint, threads, st);
}
