// Exact bottom-k along wide rows, one warp per row (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/bottomk.py:
// _chunked_kernel / _select_bottom_k (entry point bottom_k_pallas_chunked).
// Same contract as the narrow kernel (bottomk.cu): vals [rows, N] f32 in;
// the k smallest values ascending and their int32 column indices out, ties
// to the first occurrence (a stable ascending sort cut to k), here for rows
// too wide to stage in shared memory (RandLA's 40960; N up to 2^22).
// NaN inputs are outside the contract.
//
// The chunk-superset scheme of the TPU kernel, one warp per row:
//  1. one pass over the row in chunks of 128 columns (four coalesced loads
//     per lane, a warp-shuffle min) writes each chunk's minimum to shared
//     memory;
//  2. k_sel = min(k, C) passes of a lexicographic argmin over the C chunk
//     minima pick the chunks with the smallest (minimum, chunk) pairs: a
//     superset of the chunks that hold the bottom-k, ties included (were a
//     chunk holding a bottom-k element left out, each of the k chosen
//     chunks would hold an element that precedes it, a contradiction);
//  3. the chosen chunks are gathered into shared memory (slot s of the
//     buffer holds chunk chosen[s], so an entry's column is implied);
//  4. k passes of a lexicographic argmin of (value, column) over that
//     buffer, each restricted to the entries after the previous pick, give
//     the result. The row is never written, so no sentinel can collide with
//     real data (the TPU kernel overwrote picks with 3e38).
// Pure selection, no arithmetic: the output is bit-equal to the plain
// version.
//
// What bounds it: device-memory bandwidth in step 1 (each value is read
// once; step 3 re-reads k_sel * 128 values, from L2 as a rule). Steps 2 and
// 4 cost k * C / 32 and k * k_sel * 4 shared-memory reads per lane.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kW = 128;       // chunk width
constexpr int kMaxK = 48;
constexpr int kMaxN = 1 << 22;
constexpr int kSmemBudget = 96 * 1024;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

__device__ __forceinline__ void warp_lex_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Per warp, shared memory holds max(C, k_sel * kW) floats (chunk minima,
// then the gathered values) and the k_sel chosen chunk ids.
__global__ void bottom_k_chunked_kernel(const float* __restrict__ vals,
                                        float* __restrict__ out_v,
                                        int* __restrict__ out_i, int rows,
                                        int N, int k, int k_sel,
                                        int warp_floats) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // warps are independent: no block-wide barrier
  float* buf = smem + (size_t)warp * (warp_floats + k_sel);  // minima, values
  int* chosen = reinterpret_cast<int*>(buf + warp_floats);   // chunk ids
  const float* src = vals + (size_t)row * N;
  const int C = (N + kW - 1) / kW;

  // (1) chunk minima
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const int base = c * kW + lane;
    float m = INFINITY;
#pragma unroll
    for (int t = 0; t < kW / 32; ++t) {
      const int j = base + 32 * t;
      if (j < N) m = fminf(m, __ldg(src + j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) buf[c] = m;
  }
  __syncwarp();

  // (2) the k_sel chunks with the smallest (minimum, chunk)
  float pv = -INFINITY;
  int pi = -1;
  for (int j = 0; j < k_sel; ++j) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < C; c += 32) {
      const float v = buf[c];
      const bool after = v > pv || (v == pv && c > pi);
      if (after && lex_less(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_lex_min(bv, bi);
    if (lane == 0) chosen[j] = bi;
    pv = bv;
    pi = bi;
  }
  __syncwarp();

  // (3) gather the chosen chunks (this overwrites the minima)
  for (int s = 0; s < k_sel; ++s) {
    const int c = chosen[s];
#pragma unroll
    for (int t = 0; t < kW / 32; ++t) {
      const int w = 32 * t + lane;
      const int j = c * kW + w;
      buf[s * kW + w] = j < N ? __ldg(src + j) : INFINITY;
    }
  }
  __syncwarp();

  // (4) k lexicographic passes over the buffer
  const int M = k_sel * kW;
  pv = -INFINITY;
  pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int e = lane; e < M; e += 32) {
      const float v = buf[e];
      const int c = chosen[e / kW] * kW + e % kW;  // columns >= N: padding
      const bool after = v > pv || (v == pv && c > pi);
      if (c < N && after && lex_less(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_lex_min(bv, bi);
    if (lane == 0) {
      out_v[(size_t)row * k + j] = bv;
      out_i[(size_t)row * k + j] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

}  // namespace

extern "C" int psg_bottom_k_chunked(const void* vals, void* out_v, void* out_i,
                                    int rows, int N, int k, void* stream) {
  if (rows < 0 || N < 1 || N > kMaxN || k < 1 || k > kMaxK || k > N)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int C = (N + kW - 1) / kW;
  const int k_sel = k < C ? k : C;
  const int warp_floats = C > k_sel * kW ? C : k_sel * kW;
  const size_t per_warp = sizeof(float) * ((size_t)warp_floats + k_sel);
  int warps = (int)(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bottom_k_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (rows + warps - 1) / warps;
  bottom_k_chunked_kernel<<<blocks, 32 * warps, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(out_v),
      static_cast<int*>(out_i), rows, N, k, k_sel, warp_floats);
  return (int)cudaGetLastError();
}
