// Exact bottom-k along wide rows, one warp per row (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/bottomk.py:225
// bottom_k_pallas_chunked (_chunked_kernel / _select_bottom_k). Same
// contract as the narrow kernel (bottomk.cu): vals [rows, N] f32 in; the k
// smallest values ascending and their int32 column indices out, ties to the
// first occurrence (a stable ascending sort cut to k), here for rows too
// wide to stage in shared memory (the 10,000-point ball query, RandLA's
// 40960; N up to 2^22). NaN inputs are outside the contract.
//
// One warp a row:
//  1. one pass over the row in chunks of 128 columns (a 16-byte load a
//     lane where the row allows it, a warp-shuffle min) writes each chunk's
//     minimum to shared memory;
//  2. k_sel = min(k, C) passes of a lexicographic argmin over the C chunk
//     minima pick the chunks with the smallest (minimum, chunk) pairs. Let
//     T be the largest minimum among them (the k_sel-th pick). Where
//     k_sel == k two facts hold:
//     - every entry below T lies in a chosen chunk (an unchosen chunk with
//       an entry below T would have a smaller pair than the k_sel-th);
//     - every entry equal to T in a chunk up to the last one picked lies in
//       a chosen chunk, and the chosen chunks hold at least k entries that
//       are below T or equal to T up to that chunk (each one's minimum), so
//       the first ties the result can need are among the chosen chunks'
//       first k ties in column order.
//     Where k_sel < k every chunk is chosen and T is +inf.
//  3. the chosen chunk ids are sorted ascending (as the TPU kernel's
//     sort_pick does), so visiting them in order is visiting columns in
//     order;
//  4. one pass over the chosen chunks, read again from device memory (L2
//     as a rule), keeps every entry below T and the first k equal to T, in
//     column order, compacted by ballot / popc into a short list of
//     `cap` (value, column) pairs in shared memory (cap: a power of two,
//     >= 4k and >= k + 32);
//  5. a bitonic sort of the list by (value, column) over the next power of
//     two of its length; its first k are the result.
// A row whose list would outgrow cap (many entries below T in one chunk,
// or the k_sel < k case of a short row) takes the exact branch of step 4:
// the list is sorted and cut to its first k, and since every later entry
// lies after them in column order, from then on only entries below the
// k-th value are kept (no ties); this may repeat. The row is never
// written, and every entry that can be in the result stays in the list,
// so the output is bit-equal to the plain version (pure selection, no
// arithmetic). Rows of the ball query (index values, the sentinel N out of
// radius) with fewer than k points in radius have T = N tied across the
// row: the list keeps k of those ties, never all of them.
//
// What bounds it: device-memory bandwidth in step 1 (each value read once;
// step 4 re-reads k_sel * 128 values a row, from L2 as a rule). Step 2
// costs k_sel * C / 32 shared-memory reads a lane, steps 4-5 a few
// thousand instructions a row: a warp's shared memory is the C minima
// (the list reuses them) and k_sel ids, some 2.5 KB at [.., 10000] k = 32,
// so a block of 8 warps fits 8 times on an SM and enough loads are in
// flight for step 1. Nothing is gathered, and the chosen chunks are read
// again once, the exact branch included.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kW = 128;      // chunk width
constexpr int kMaxK = 48;
constexpr int kMaxN = 1 << 22;
constexpr int kMaxWarps = 8;            // a block's warps, where shared memory allows
constexpr int kSmemBudget = 160 * 1024;  // a block's dynamic shared memory, at most
constexpr unsigned kFull = 0xffffffffu;

// the short list's capacity at k (ops/cuda/bottomk_chunked.py's list_capacity)
__host__ __device__ constexpr int list_capacity(int k) {
  return k <= 16 ? 64 : (k <= 32 ? 128 : 256);
}

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

__device__ __forceinline__ void warp_lex_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_min(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// Sort the warp's list of n (value, column) pairs ascending by (value,
// column): a bitonic network over the next power of two >= max(n, 32), the
// slots past n padded with (+inf, INT_MAX), which sort after every entry.
__device__ void sort_list(float* lv, int* lc, int n, int lane) {
  int n2 = 32;
  while (n2 < n) n2 <<= 1;
  for (int e = n + lane; e < n2; e += 32) {
    lv[e] = INFINITY;
    lc[e] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float vi = lv[i], vj = lv[j];
        const int ci = lc[i], cj = lc[j];
        // ascending where bit `size` of i is clear; pairs are distinct but
        // for the padding, which swaps with itself harmlessly
        if (lex_less(vj, cj, vi, ci) == ((i & size) == 0)) {
          lv[i] = vj;
          lv[j] = vi;
          lc[i] = cj;
          lc[j] = ci;
        }
      }
      __syncwarp();
    }
  }
}

// Shared memory a warp: warp_words = max(C, 2 * cap) words (the chunk
// minima, then the list's values and columns), then the k_sel chosen ids.
template <bool VEC>
__global__ void __launch_bounds__(32 * kMaxWarps)
bottom_k_chunked_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                        int* __restrict__ out_i, int* __restrict__ overflow_rows,
                        int rows, int N, int k, int k_sel, int cap, int warp_words) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // warps are independent: no block-wide barrier
  float* buf = smem + (size_t)warp * (warp_words + k_sel);
  int* chosen = reinterpret_cast<int*>(buf + warp_words);
  float* lv = buf;                               // list values (after step 2)
  int* lc = reinterpret_cast<int*>(buf + cap);   // list columns
  const float* src = vals + (size_t)row * N;
  const int C = (N + kW - 1) / kW;

  // (1) chunk minima
  if (VEC) {  // N % 4 == 0 and the rows 16-byte aligned
    const float4* src4 = reinterpret_cast<const float4*>(src);
    const int n4 = N >> 2;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const int q = c * (kW / 4) + lane;
      float m = INFINITY;
      if (q < n4) {
        const float4 x = __ldg(src4 + q);
        m = fminf(fminf(x.x, x.y), fminf(x.z, x.w));
      }
      m = warp_min(m);
      if (lane == 0) buf[c] = m;
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const int base = c * kW + lane;
      float m = INFINITY;
#pragma unroll
      for (int t = 0; t < kW / 32; ++t) {
        const int j = base + 32 * t;
        if (j < N) m = fminf(m, __ldg(src + j));
      }
      m = warp_min(m);
      if (lane == 0) buf[c] = m;
    }
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

  // (3) the chosen ids ascending (distinct: each one's rank is its place)
  {
    const int a = lane < k_sel ? chosen[lane] : INT_MAX;
    const int b = lane + 32 < k_sel ? chosen[lane + 32] : INT_MAX;
    int ra = 0, rb = 0;
    for (int s = 0; s < k_sel; ++s) {
      const int c = chosen[s];
      ra += c < a;
      rb += c < b;
    }
    __syncwarp();
    if (lane < k_sel) chosen[ra] = a;
    if (lane + 32 < k_sel) chosen[rb] = b;
    __syncwarp();
  }

  // (4) one thresholded pass over the chosen chunks into the list
  float thr = k_sel == k ? pv : INFINITY;
  bool ties = true;  // entries equal to thr are still taken (the first k)
  int n_ties = 0;    // entries equal to thr seen so far
  int count = 0;
  bool overflowed = false;
  const unsigned below_me = (1u << lane) - 1;
  float nxt[kW / 32];
  {
    const int base = chosen[0] * kW + lane;
#pragma unroll
    for (int t = 0; t < kW / 32; ++t) {
      const int j = base + 32 * t;
      nxt[t] = j < N ? __ldg(src + j) : INFINITY;
    }
  }
  for (int s = 0; s < k_sel; ++s) {
    const int base = chosen[s] * kW;
    float v[kW / 32];
#pragma unroll
    for (int t = 0; t < kW / 32; ++t) v[t] = nxt[t];
    if (s + 1 < k_sel) {  // the next chunk's loads in flight meanwhile
      const int nb = chosen[s + 1] * kW + lane;
#pragma unroll
      for (int t = 0; t < kW / 32; ++t) {
        const int j = nb + 32 * t;
        nxt[t] = j < N ? __ldg(src + j) : INFINITY;
      }
    }
#pragma unroll
    for (int t = 0; t < kW / 32; ++t) {
      const int j = base + 32 * t + lane;
      const bool in = j < N;
      const bool eq = ties && in && v[t] == thr;
      const unsigned beq = __ballot_sync(kFull, eq);
      bool keep = (in && v[t] < thr) || (eq && n_ties + __popc(beq & below_me) < k);
      n_ties += __popc(beq);
      unsigned bk = __ballot_sync(kFull, keep);
      if (count + __popc(bk) > cap) {  // the exact branch (see top)
        sort_list(lv, lc, count, lane);
        count = k;
        thr = lv[k - 1];
        ties = false;
        overflowed = true;
        keep = in && v[t] < thr;
        bk = __ballot_sync(kFull, keep);
      }
      if (keep) {
        const int p = count + __popc(bk & below_me);
        lv[p] = v[t];
        lc[p] = j;
      }
      count += __popc(bk);
    }
  }

  // (5) sort the list, write its first k
  sort_list(lv, lc, count, lane);
  for (int e = lane; e < k; e += 32) {
    out_v[(size_t)row * k + e] = lv[e];
    out_i[(size_t)row * k + e] = lc[e];
  }
  if (overflowed && overflow_rows != nullptr && lane == 0) atomicAdd(overflow_rows, 1);
}

template <bool VEC>
cudaError_t launch(const float* vals, float* out_v, int* out_i, int* overflow_rows, int rows,
                   int N, int k, int k_sel, int cap, int warp_words, int warps, size_t smem,
                   cudaStream_t st) {
  if (smem > 48 * 1024) {  // above 48 KB a kernel must opt in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        bottom_k_chunked_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (rows + warps - 1) / warps;
  bottom_k_chunked_kernel<VEC><<<blocks, 32 * warps, smem, st>>>(
      vals, out_v, out_i, overflow_rows, rows, N, k, k_sel, cap, warp_words);
  return cudaGetLastError();
}

}  // namespace

// overflow_rows: null, or one device int to which the kernel adds the
// number of rows that took the exact branch (for checks; the op passes null)
extern "C" int psg_bottom_k_chunked(const void* vals, void* out_v, void* out_i,
                                    void* overflow_rows, int rows, int N, int k,
                                    void* stream) {
  if (rows < 0 || N < 1 || N > kMaxN || k < 1 || k > kMaxK || k > N)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int C = (N + kW - 1) / kW;
  const int k_sel = k < C ? k : C;
  const int cap = list_capacity(k);
  const int warp_words = C > 2 * cap ? C : 2 * cap;
  const size_t per_warp = sizeof(float) * ((size_t)warp_words + k_sel);
  int warps = (int)(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  const float* v = static_cast<const float*>(vals);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  int* over = static_cast<int*>(overflow_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(v, ov, oi, over, rows, N, k, k_sel, cap, warp_words, warps,
                                  smem, st)
                   : launch<false>(v, ov, oi, over, rows, N, k, k_sel, cap, warp_words, warps,
                                   smem, st));
}
