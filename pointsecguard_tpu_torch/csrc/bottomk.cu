// Exact bottom-k along rows, one warp per row (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/bottomk.py:
// _bottomk_kernel (entry point bottom_k_pallas). Same contract: vals
// [rows, N] f32 in; the k smallest values ascending and their int32
// column indices out, ties to the first occurrence, k == N allowed; the
// result equals a stable ascending sort cut to k (and lax.top_k of the
// negated row). NaN inputs are outside the contract.
//
// What bounds it: k passes over a row. The row is staged once from device
// memory into shared memory (N x 4 bytes per warp, 4 warps per block), so
// device memory sees each value once and the k passes run on shared
// memory. Each pass is a warp-wide lexicographic argmin of (value, index)
// over the entries that come AFTER the previous pick in that order, so the
// row is never written to and no sentinel value can collide with real
// data (the TPU kernel overwrote picks with 3e38). Pure selection: no
// arithmetic, so the output is bit-equal to the plain version.
// The limit N <= 8192 (128 KB of shared memory per block) mirrors the
// TPU kernel's N < 8192; wider rows go to bottomk_chunked.cu, the port of
// the chunked kernel (bottom_k_pallas_chunked).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kMaxN = 8192;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
bottom_k_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                int* __restrict__ out_i, int rows, int N, int k) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // warps are independent: no block-wide barrier
  float* s = smem + (size_t)warp * N;
  const float* src = vals + (size_t)row * N;
  for (int c = lane; c < N; c += 32) s[c] = src[c];
  __syncwarp();

  float pv = -INFINITY;  // previous pick, lexicographic (value, index)
  int pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < N; c += 32) {
      const float v = s[c];
      const bool after = v > pv || (v == pv && c > pi);
      if (after && lex_less(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (lex_less(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_v[(size_t)row * k + j] = bv;
      out_i[(size_t)row * k + j] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

}  // namespace

extern "C" int psg_bottom_k(const void* vals, void* out_v, void* out_i,
                            int rows, int N, int k, void* stream) {
  if (rows < 0 || N < 1 || N > kMaxN || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)N * kRowsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bottom_k_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  bottom_k_kernel<<<blocks, 32 * kRowsPerBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<float*>(out_v),
      static_cast<int*>(out_i), rows, N, k);
  return (int)cudaGetLastError();
}
