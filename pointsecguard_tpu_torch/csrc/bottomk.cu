// Exact bottom-k along rows (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/bottomk.py:
// _bottomk_kernel (entry point bottom_k_pallas). Same contract: vals
// [rows, N] f32 in; the k smallest values ascending and their int32
// column indices out, ties to the first occurrence, k == N allowed; the
// result equals a stable ascending sort cut to k (and lax.top_k of the
// negated row). NaN inputs are outside the contract.
//
// What bounds it: bytes. The function reads each value once and writes
// 8*k bytes per row, and does no arithmetic, so the least time is the
// row's read from device memory. The design therefore reads every row
// exactly once, straight from device memory with 128-bit streaming loads
// (the next two per lane are in flight while these two are examined), and
// keeps only O(k) state, so that many warps fit on an SM and their loads
// overlap.
//
// k <= 32 (every call of the attack paths: k = 3, 5, 10, 16, 32): one warp
// per row. The warp keeps the 32 best (value, index) pairs so far sorted
// across its lanes, one pair a lane, in registers, and the k-th of them
// as a threshold. An element is a candidate only if it is
// below the threshold in (value, index) order, which gives ties to the
// first occurrence. One vote per 8 elements a lane skips the loads that hold
// no candidate; candidates are found with __ballot_sync. A ballot of at
// most 4 (the steady state of a random row) is inserted into the list at
// once with a shift across the lanes, which refreshes the threshold; a
// larger one is appended to a queue of 32 entries in shared memory (256
// bytes a warp, all the shared memory there is). When the queue cannot
// take the next ballot it is
// merged: a bitonic sort of the queue across the lanes (15 shuffle
// steps), the element-wise minimum of the list and the reversed queue
// (the 32 smallest of both, a bitonic sequence) and a bitonic merge
// (5 steps): about 200 warp operations, none of which touches the row.
// On a random order about k*ln(N/k) elements ever pass the threshold;
// ball-query rows (ascending index values, misses set to N) pass few; a
// descending row passes all N and costs a merge every 32 elements, still
// exact.
//
// k > 32 (outside the attack paths; k == N up to 8192 is in the
// contract): one block per row sorts the row's (value, index) pairs in
// shared memory with a bitonic network (N padded to a power of two with
// +inf keys of index >= N, which sort last) and writes the first k.
// Pure selection in both: the output is bit-equal to the plain version.
// Rows wider than 8192 go to bottomk_chunked.cu.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxN = 8192;
constexpr int kWarpK = 32;          // largest k of the warp-per-row kernel
constexpr int kWarpsPerBlock = 8;
constexpr int kQueue = 32;          // candidate queue entries per warp
constexpr int kDirect = 4;          // a ballot of at most this many is inserted at once
constexpr int kSortThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float v, int i, float ov, int oi) {
  return v < ov || (v == ov && i < oi);
}

// compare-exchange with the lane `stride` away; `ascending` is the
// direction of this lane's subsequence
__device__ __forceinline__ void exchange(float& v, int& i, int stride, bool ascending,
                                         int lane) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  const bool want_min = ((lane & stride) == 0) == ascending;
  if (lex_less(ov, oi, v, i) == want_min) {
    v = ov;
    i = oi;
  }
}

// One warp's selection state. Lane j holds the j-th best pair so far
// (+inf, INT_MAX where there is none yet).
struct WarpState {
  float lv;
  int li;
  float* qv;  // the queue, in shared memory
  int* qi;
  int qn;     // entries in the queue (warp-uniform)
  float tv;   // the k-th best so far, the threshold: (+inf, INT_MAX)
  int ti;     // until k are held, so that everything passes
};

// list <- the 32 smallest of list + queue, sorted; queue emptied
__device__ __forceinline__ void merge(WarpState& s, int k, int lane) {
  __syncwarp();
  float v = lane < s.qn ? s.qv[lane] : INFINITY;
  int i = lane < s.qn ? s.qi[lane] : INT_MAX;
  __syncwarp();
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(v, i, stride, (lane & size) == 0, lane);
  }
  // the j-th smallest of the list against the j-th largest of the queue
  const float rv = __shfl_sync(kFull, v, 31 - lane);
  const int ri = __shfl_sync(kFull, i, 31 - lane);
  if (lex_less(rv, ri, s.lv, s.li)) {
    s.lv = rv;
    s.li = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) exchange(s.lv, s.li, stride, true, lane);
  s.qn = 0;
  s.tv = __shfl_sync(kFull, s.lv, k - 1);
  s.ti = __shfl_sync(kFull, s.li, k - 1);
}

// Whether element (v, c) can still be among the k best: it is below the
// threshold in (value, index) order. (The 256 elements of one step are
// not examined in index order, so the index does decide a tie.)
__device__ __forceinline__ bool passes(const WarpState& s, float v, int c) {
  return lex_less(v, c, s.tv, s.ti);
}

// list <- list + lane src's element (v, c), which is not yet in it
__device__ __forceinline__ void insert(WarpState& s, float v, int c, int src, int lane) {
  const float cv = __shfl_sync(kFull, v, src);
  const int cc = __shfl_sync(kFull, c, src);
  const int pos = __popc(__ballot_sync(kFull, lex_less(s.lv, s.li, cv, cc)));
  const float uv = __shfl_up_sync(kFull, s.lv, 1);
  const int ui = __shfl_up_sync(kFull, s.li, 1);
  if (lane == pos) {
    s.lv = cv;
    s.li = cc;
  } else if (lane > pos) {
    s.lv = uv;
    s.li = ui;
  }
}

// one element per lane (index c, or c < 0 for a lane without one)
__device__ __forceinline__ void offer(WarpState& s, float v, int c, int k, int lane) {
  bool cand = c >= 0 && passes(s, v, c);
  unsigned mask = __ballot_sync(kFull, cand);
  if (mask == 0) return;
  if (__popc(mask) <= kDirect) {
    // the steady state of a random row: a straggler or two. Inserting
    // them refreshes the threshold at once; the queue would hold it stale
    for (; mask != 0; mask &= mask - 1) insert(s, v, c, __ffs(mask) - 1, lane);
    s.tv = __shfl_sync(kFull, s.lv, k - 1);
    s.ti = __shfl_sync(kFull, s.li, k - 1);
    return;
  }
  if (s.qn + __popc(mask) > kQueue) {
    merge(s, k, lane);
    cand = cand && passes(s, v, c);  // against the new threshold
    mask = __ballot_sync(kFull, cand);
  }
  if (cand) {
    const int pos = s.qn + __popc(mask & ((1u << lane) - 1));
    s.qv[pos] = v;
    s.qi[pos] = c;
  }
  s.qn += __popc(mask);
}

template <int V>
__device__ __forceinline__ void load_vec(const float* src, int e, int nvec, float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = INFINITY;
  if (e >= nvec) return;
  if constexpr (V == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(src) + e);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldcs(src + e);
  }
}

// V = 4: rows of N % 4 == 0 floats, read as float4; V = 1: any N
template <int V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
bottom_k_warp_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                     int* __restrict__ out_i, int rows, int N, int k) {
  __shared__ float queue_v[kWarpsPerBlock][kQueue];
  __shared__ int queue_i[kWarpsPerBlock][kQueue];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // warps are independent: no block-wide barrier
  WarpState s;
  s.lv = INFINITY;
  s.li = INT_MAX;
  s.qv = queue_v[warp];
  s.qi = queue_i[warp];
  s.qn = 0;
  s.tv = INFINITY;
  s.ti = INT_MAX;

  const float* src = vals + (size_t)row * N;
  const int nvec = N / V;  // V == 4 only when N % 4 == 0
  constexpr int U = V == 4 ? 2 : 4;  // loads in flight per lane and step
  float x[U][V], nx[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) load_vec<V>(src, u * 32 + lane, nvec, x[u]);
  for (int b = 0; b < nvec; b += 32 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec<V>(src, b + (U + u) * 32 + lane, nvec, nx[u]);
    // most steps hold no candidate: one vote on the values alone (a
    // superset of the exact test) skips them
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) any |= x[u][j] <= s.tv;
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = b + u * 32 + lane;
        if (b + u * 32 >= nvec) break;  // warp-uniform
#pragma unroll
        for (int j = 0; j < V; ++j)
          offer(s, x[u][j], e < nvec ? e * V + j : -1, k, lane);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) x[u][j] = nx[u][j];
    }
  }
  if (s.qn > 0) merge(s, k, lane);
  if (lane < k) {
    out_v[(size_t)row * k + lane] = s.lv;
    out_i[(size_t)row * k + lane] = s.li;
  }
}

// k > kWarpK: one block sorts the row (P = N rounded up to a power of two)
__global__ void __launch_bounds__(kSortThreads)
bottom_k_sort_kernel(const float* __restrict__ vals, float* __restrict__ out_v,
                     int* __restrict__ out_i, int N, int k, int P) {
  extern __shared__ float smem[];
  float* sv = smem;
  int* si = reinterpret_cast<int*>(smem + P);
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  for (int c = t; c < P; c += kSortThreads) {
    sv[c] = c < N ? vals[row * N + c] : INFINITY;
    si[c] = c;
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int e = t; e < P / 2; e += kSortThreads) {
        const int lo = 2 * e - (e & (stride - 1)), hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const float a = sv[lo], b = sv[hi];
        const int ia = si[lo], ib = si[hi];
        if (lex_less(b, ib, a, ia) == ascending) {
          sv[lo] = b; si[lo] = ib;
          sv[hi] = a; si[hi] = ia;
        }
      }
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += kSortThreads) {
    out_v[row * k + j] = sv[j];
    out_i[row * k + j] = si[j];
  }
}

}  // namespace

extern "C" int psg_bottom_k(const void* vals, void* out_v, void* out_i,
                            int rows, int N, int k, void* stream) {
  if (rows < 0 || N < 1 || N > kMaxN || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto* v = static_cast<const float*>(vals);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (k <= kWarpK) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    // float4 loads need 16-byte aligned rows: N % 4 == 0 and an aligned base
    const bool vec = N % 4 == 0 && reinterpret_cast<size_t>(vals) % 16 == 0;
    if (vec)
      bottom_k_warp_kernel<4><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(v, ov, oi, rows, N, k);
    else
      bottom_k_warp_kernel<1><<<blocks, 32 * kWarpsPerBlock, 0, st>>>(v, ov, oi, rows, N, k);
    return (int)cudaGetLastError();
  }
  int P = 1;
  while (P < N) P <<= 1;
  const size_t smem = 2 * sizeof(float) * (size_t)P;
  if (smem > 48 * 1024) {  // above 48 KB a kernel opts in
    cudaError_t e = cudaFuncSetAttribute(
        bottom_k_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bottom_k_sort_kernel<<<rows, kSortThreads, smem, st>>>(v, ov, oi, N, k, P);
  return (int)cudaGetLastError();
}
