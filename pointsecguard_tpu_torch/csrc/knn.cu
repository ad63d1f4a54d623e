// Exact k nearest neighbours fused with their squared distance (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/knn.py:_knn_kernel
// (entry point knn_pallas). Same contract: query [B, S, D] and points
// [B, N, D] f32 in; for each query the k smallest squared distances,
// ascending, and their int32 point indices, ties to the first occurrence
// (a stable sort of the distance row cut to k); the [S, N] distance matrix
// is never written to device memory. NaN inputs are outside the contract.
//
// Arithmetic: the distance is (s2 - 2*cross) + d2, rounded exactly as the
// port's square_distance (ops/distance.py) rounds it. s2 = |q|^2 and
// d2 = |p|^2 come in from the wrapper, computed by the same torch code as
// the plain version; cross = q.p is a fused multiply-add chain over the
// coordinates in index order, fma(q2, p2, fma(q1, p1, q0 * p0)), which is
// how a float32 GEMM accumulates a depth-3 product. Every step is written
// with __fmul_rn / __fmaf_rn / __fsub_rn / __fadd_rn so that nvcc cannot
// re-contract it.
//
// Design: one thread per query, 128 queries per block. The points stream
// through shared memory in tiles (each a broadcast read: all threads of a
// warp read the same point). Each thread keeps its k best (value, index)
// pairs as a sorted list in registers (KMAX slots, all indices
// compile-time constants, so the list never goes to local memory). Points
// are scanned in index order and a
// candidate enters only when strictly smaller than the current k-th value,
// after any equal values: that is first-occurrence order among ties. For
// D = 3 (RandLA's xyz) a query lives in registers and a point is one
// 16-byte shared load (x, y, z, |p|^2); any other D reads the query from
// the L1-cached row.
//
// What bounds it: the S*N distance evaluations (about ten instructions
// each); device memory sees the points once per block of queries and the
// outputs once. Insertions are rare (about k*ln(N/k) per query on a random
// order).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kRegBlock = 8;               // points per register block
constexpr int kSmemBytes = 48 * 1024;      // static-size limit, no attribute

// The k best (value, index) pairs, ascending, in the last k of KMAX slots;
// the first KMAX - k slots hold -inf and never move. So the k-th value is
// always slot KMAX - 1, and every index into the arrays is a compile-time
// constant (a runtime one would put the list in local memory).
template <int KMAX>
struct TopK {
  float v[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = j < KMAX - k ? -INFINITY : INFINITY;
      i[j] = INT_MAX;
    }
  }

  __device__ __forceinline__ float kth() const { return v[KMAX - 1]; }

  // d < kth(). d goes after every value <= d; the last slot drops out.
  __device__ __forceinline__ void insert(float d, int idx) {
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      const bool shift = v[j - 1] > d;
      const bool here = !shift && v[j] > d;
      const float nv = shift ? v[j - 1] : (here ? d : v[j]);
      const int ni = shift ? i[j - 1] : (here ? idx : i[j]);
      v[j] = nv;
      i[j] = ni;
    }
    if (v[0] > d) {
      v[0] = d;
      i[0] = idx;
    }
  }

  __device__ __forceinline__ void store(float* out_v, int* out_i, int k) const {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j >= KMAX - k) {
        out_v[j - (KMAX - k)] = v[j];
        out_i[j - (KMAX - k)] = i[j];
      }
  }
};

__device__ __forceinline__ float combine(float s2, float cross, float d2) {
  return __fadd_rn(__fsub_rn(s2, __fmul_rn(2.0f, cross)), d2);
}

// D = 3 (RandLA's xyz): the query in registers, each point one float4
// (x, y, z, |p|^2) in shared memory.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_xyz_kernel(const float* __restrict__ query, const float* __restrict__ points,
               const float* __restrict__ s2, const float* __restrict__ d2,
               float* __restrict__ out_v, int* __restrict__ out_i,
               int S, int N, int k, int tile) {
  extern __shared__ float4 sp4[];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = row < S;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, qs2 = 0.f;
  if (valid) {
    const float* qr = query + ((size_t)b * S + row) * 3;
    q0 = qr[0];
    q1 = qr[1];
    q2 = qr[2];
    qs2 = s2[(size_t)b * S + row];
  }
  TopK<KMAX> best;
  best.init(k);
  const float* pb = points + (size_t)b * N * 3;
  const float* db = d2 + (size_t)b * N;
  for (int base = 0; base < N; base += tile) {
    const int nt = min(tile, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += kThreads) {
      const float* p = pb + (size_t)(base + j) * 3;
      sp4[j] = make_float4(p[0], p[1], p[2], db[base + j]);
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < nt; ++j) {
      const float4 e = sp4[j];
      const float cross = __fmaf_rn(q2, e.z, __fmaf_rn(q1, e.y, __fmul_rn(q0, e.x)));
      const float d = combine(qs2, cross, e.w);
      if (d < best.kth()) best.insert(d, base + j);
    }
  }
  if (valid) {
    const size_t o = ((size_t)b * S + row) * k;
    best.store(out_v + o, out_i + o, k);
  }
}

// Any D: the points tile is [tile][D] in shared memory; the cross terms of
// kRegBlock points are accumulated together, one coordinate at a time.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_wide_d_kernel(const float* __restrict__ query, const float* __restrict__ points,
                  const float* __restrict__ s2, const float* __restrict__ d2,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int S, int N, int D, int k, int tile) {
  extern __shared__ float smem[];
  float* sp = smem;                        // [tile][D]
  float* sd = smem + (size_t)tile * D;     // [tile]
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = row < S;
  const float* qr = query + ((size_t)b * S + (valid ? row : 0)) * D;
  const float qs2 = valid ? s2[(size_t)b * S + row] : 0.f;
  TopK<KMAX> best;
  best.init(k);
  const float* pb = points + (size_t)b * N * D;
  const float* db = d2 + (size_t)b * N;
  for (int base = 0; base < N; base += tile) {
    const int nt = min(tile, N - base);
    __syncthreads();
    for (int j = threadIdx.x; j < nt * D; j += kThreads)
      sp[j] = pb[(size_t)base * D + j];
    for (int j = threadIdx.x; j < nt; j += kThreads) sd[j] = db[base + j];
    __syncthreads();
    if (!valid) continue;
    for (int j0 = 0; j0 < nt; j0 += kRegBlock) {
      float acc[kRegBlock];
      const float q0 = __ldg(qr);
#pragma unroll
      for (int r = 0; r < kRegBlock; ++r)
        acc[r] = __fmul_rn(q0, sp[(size_t)(j0 + r) * D]);
      for (int c = 1; c < D; ++c) {
        const float qc = __ldg(qr + c);
#pragma unroll
        for (int r = 0; r < kRegBlock; ++r)
          acc[r] = __fmaf_rn(qc, sp[(size_t)(j0 + r) * D + c], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRegBlock; ++r) {
        if (j0 + r < nt) {
          const float d = combine(qs2, acc[r], sd[j0 + r]);
          if (d < best.kth()) best.insert(d, base + j0 + r);
        }
      }
    }
  }
  if (valid) {
    const size_t o = ((size_t)b * S + row) * k;
    best.store(out_v + o, out_i + o, k);
  }
}

template <int KMAX>
cudaError_t launch(const float* q, const float* p, const float* s2,
                   const float* d2, float* ov, int* oi, int B, int S, int N,
                   int D, int k, cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads, B);
  if (D == 3) {
    const int tile = std::min(N, kSmemBytes / (int)sizeof(float4));
    knn_xyz_kernel<KMAX><<<grid, kThreads, (size_t)tile * sizeof(float4), stream>>>(
        q, p, s2, d2, ov, oi, S, N, k, tile);
  } else {
    // whole register blocks (the tail of a tile is read but masked)
    const int per_point = (D + 1) * (int)sizeof(float);
    const int tile = (kSmemBytes / per_point) / kRegBlock * kRegBlock;
    knn_wide_d_kernel<KMAX><<<grid, kThreads, (size_t)tile * per_point, stream>>>(
        q, p, s2, d2, ov, oi, S, N, D, k, tile);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int psg_knn(const void* query, const void* points, const void* s2,
                       const void* d2, void* out_v, void* out_i, int B, int S,
                       int N, int D, int k, void* stream) {
  if (B < 0 || S < 0 || N < 1 || D < 1 || k < 1 || k > 48 || k > N ||
      B > 65535 || (size_t)(D + 1) * sizeof(float) * kRegBlock > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const auto* q = static_cast<const float*>(query);
  const auto* p = static_cast<const float*>(points);
  const auto* a = static_cast<const float*>(s2);
  const auto* c = static_cast<const float*>(d2);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  // the list sizes the pyramid uses (k = 1 and 16), and the bound
  if (k <= 1) return (int)launch<1>(q, p, a, c, ov, oi, B, S, N, D, k, st);
  if (k <= 16) return (int)launch<16>(q, p, a, c, ov, oi, B, S, N, D, k, st);
  return (int)launch<48>(q, p, a, c, ov, oi, B, S, N, D, k, st);
}
