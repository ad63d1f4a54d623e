// Farthest point sampling, one CTA per cloud (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/fps.py:_fps_kernel
// (entry point fps_pallas). Same contract: xyz [B, N, 3] f32 and start [B]
// i32 in, [B, npoint] i32 out; min_dist starts at 1e10; each step takes
// the argmax of the running min squared distance, ties to the LOWEST
// index; npoint > N wraps onto index 0 once every point is chosen.
//
// What bounds it: the npoint-step recurrence is sequential, so the cost is
// npoint x (one distance pass over N points + one block-wide argmax), i.e.
// latency of two __syncthreads and a shuffle tree per step, not bytes:
// the cloud (N x 12 bytes) is read from device memory once. The design
// keeps each thread's points and their running min-distance in registers
// (SLOTS points per thread, point i on thread i % T, slot i / T), so a step
// touches no memory except the broadcast centroid (three L1-cached loads)
// and 2 x 32 words of shared memory for the reduction. One CTA per cloud
// leaves most SMs idle at small B; splitting a cloud across a cluster is
// later work.
//
// The squared distance is written with explicit round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs: the result is then
// bit-identical to the plain version's dx*dx + dy*dy + dz*dz.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 8;  // N <= kMaxThreads * kMaxSlots = 8192

__device__ __forceinline__ void keep_larger(float& v, int& i, float ov, int oi) {
  // argmax order: larger value first, then lower index
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = (T + 31) >> 5;
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
    } else {  // padding slot: below every real distance, never chosen
      px[s] = py[s] = pz[s] = 0.f;
      md[s] = -1.f;
    }
  }

  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int far_s;

  int far = start[b];
  if (far < 0 || far >= N) {  // never read outside the cloud
    for (int j = t; j < npoint; j += T) o[j] = -1;
    return;
  }
  for (int j = 0; j < npoint; ++j) {
    if (t == 0) o[j] = far;
    if (j == npoint - 1) break;
    const float cx = __ldg(p + 3 * far);
    const float cy = __ldg(p + 3 * far + 1);
    const float cz = __ldg(p + 3 * far + 2);

    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const float dx = __fsub_rn(px[s], cx);
      const float dy = __fsub_rn(py[s], cy);
      const float dz = __fsub_rn(pz[s], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[s] = fminf(md[s], d);  // d >= 0 leaves padding slots at -1
      // slots run in ascending index, so a strict > keeps the first
      if (md[s] > bv) {
        bv = md[s];
        bi = s * T + t;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      keep_larger(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        keep_larger(bv, bi, ov, oi);
      }
      if (lane == 0) far_s = bi;
    }
    __syncthreads();
    far = far_s;
  }
}

}  // namespace

extern "C" int psg_fps(const void* xyz, const void* start, void* out, int B,
                       int N, int npoint, void* stream) {
  if (B < 0 || N < 1 || npoint < 1 || N > kMaxThreads * kMaxSlots)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  const int slots = (N + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  if (slots <= 1)
    fps_kernel<1><<<B, threads, 0, st>>>(x, s, o, N, npoint);
  else if (slots <= 2)
    fps_kernel<2><<<B, threads, 0, st>>>(x, s, o, N, npoint);
  else if (slots <= 4)
    fps_kernel<4><<<B, threads, 0, st>>>(x, s, o, N, npoint);
  else
    fps_kernel<8><<<B, threads, 0, st>>>(x, s, o, N, npoint);
  return (int)cudaGetLastError();
}
