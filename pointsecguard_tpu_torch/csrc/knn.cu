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
// d2 = |p|^2 are made by two small kernels of this file with the plain
// version's own roundings (sum_sq below); cross = q.p is a fused
// multiply-add chain over the coordinates in index order,
// fma(q2, p2, fma(q1, p1, q0 * p0)), which is how a float32 GEMM
// accumulates a depth-3 product. s2 - 2*cross is one fma(-2, cross, s2):
// doubling is exact, so it rounds as the subtraction does. Every step is
// written with __fmul_rn / __fmaf_rn / __fadd_rn so that nvcc cannot
// re-contract it. Float32 FMA only: TF32 or the tensor cores would flip
// near-tie neighbours.
//
// What bounds it: operations, not bytes (device memory sees the points
// once per block of queries and the outputs once), and of the operations
// not the float pipe alone: a pair costs 5 float instructions, one compare
// (half rate on an H100) and one 16-byte broadcast load from shared
// memory, and that load is what saturates first. A warp-wide
// 16-byte load takes the SM's one load path 3 to 4 cycles, so four
// schedulers cannot get past one pair per ~13 lane-cycles however many
// warps there are; more queries a thread would halve the loads, but two
// register lists of 16 pairs leave too few warps on an SM (measured: no
// faster). Selection must stay out of that loop: a sorted-list insertion
// is ~100 predicated instructions that a whole warp walks whenever any one
// of its 32 queries has a hit (on a random order a query inserts about
// k*ln(N/k) times, so some lane of a warp hits at ~9 % of the points), and
// a data-dependent branch per point keeps the compiler from overlapping
// the distance chains of neighbouring points.
//
// Design (D = 3, RandLA's xyz): one thread per query (two at k = 1, where
// registers allow it and one load then feeds two distances), the query
// and its k best (value, index) pairs in registers (a sorted list of KMAX
// slots, all indices compile-time constants, so it never goes to local
// memory).
//  - The hot loop is arithmetic only. Points come in groups of kUnroll:
//    one 16-byte broadcast load each (x, y, z, |p|^2), kUnroll independent
//    distance chains, each compared with the thread's k-th value, the hits
//    OR-ed. One warp vote per group decides whether anything else happens.
//  - Deferred insertion. In a group with a hit, every lane appends its
//    hits (distance, index) to its own queue in shared memory, in index
//    order. When a vote says some lane's queue could overflow in the next
//    group, all 32 lanes flush together: each re-tests its queued pairs, in
//    order, against its current k-th value and inserts the survivors. The
//    queue was filtered with a stale threshold, which is never below the
//    current one, so it is a superset of what point-by-point insertion
//    would have taken, and the flush applies exactly that rule (strictly
//    below the k-th, placed after equal values): values, indices and
//    first-occurrence ties are unchanged, but the insertion's instructions
//    serve many lanes at once. k = 1 needs no queue: its "insertion"
//    is two predicated moves.
//  - The points are packed once per call as (x, y, z, |p|^2) and stream
//    through two shared-memory stages of kTile points filled by 16-byte
//    cp.async, so the next tile arrives while this one is scanned, with
//    one barrier a tile; a stage is padded to whole groups with points at
//    distance +inf, which never hit. Small blocks (kThreads queries, 32 KB
//    of shared memory at k <= 16) let 24 warps share an SM and keep the
//    grid's tail fine-grained.
// Any other D (no caller on a ported path yet) keeps the simpler kernel:
// the query read from the L1-cached row, the cross terms of kRegBlock
// points accumulated together, insertion point by point into the same
// list.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;              // queries per block
constexpr int kMinBlocks = 6;              // blocks on an SM at k <= 16: <= 80 registers
constexpr int kUnroll = 8;                 // points per group of the hot loop
constexpr int kTile = 512;                 // points per shared-memory stage
constexpr int kQueue = 16;                 // queued candidates per query
constexpr int kQptOne = 2;                 // queries per thread at k = 1 ...
constexpr int kFillBlocks = 264;           // ... if the call still has so many blocks
constexpr int kRegBlock = 8;               // any-D kernel: points per register block
constexpr int kSmemBytes = 48 * 1024;      // static-size limit, no attribute
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kTile % kUnroll == 0 && kQueue >= 2 * kUnroll, "queue holds two groups");

// The k best (value, index) pairs, ascending, in the last k of KMAX slots;
// the first KMAX - k slots hold -inf and never move. So the k-th value is
// always slot KMAX - 1, and every index into the arrays is a compile-time
// constant (a runtime one would put the list in local memory).
template <int KMAX>
struct TopK {
  float v[KMAX];
  int i[KMAX];

  // k = 0 gives a list that nothing enters (its k-th value is -inf)
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
  return __fadd_rn(__fmaf_rn(-2.0f, cross, s2), d2);
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// |x|^2 of a row of D floats, rounded exactly as the plain version's
// _sum_sq (ops/distance.py) rounds it: x0 * x0 in float32, then per
// coordinate one exact float64 square, one float64 add and one rounding to
// float32. Each step is a correctly rounded IEEE operation there and
// here, so the bits are the same.
__device__ __forceinline__ float sum_sq(const float* x, int D) {
  float acc = __fmul_rn(x[0], x[0]);
  for (int c = 1; c < D; ++c)
    acc = __double2float_rn(__dadd_rn(__dmul_rn((double)x[c], (double)x[c]), (double)acc));
  return acc;
}

// out[r] = |x_r|^2 for rows of D floats
__global__ void norms_kernel(const float* __restrict__ x, float* __restrict__ out, long rows,
                             int D) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) out[r] = sum_sq(x + r * D, D);
}

// out[r] = (x, y, z, |p_r|^2): what the D = 3 kernel streams, one 16-byte
// copy a point, and how it reads a query
__global__ void pack_xyz_kernel(const float* __restrict__ p, float4* __restrict__ out,
                                long rows) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) out[r] = make_float4(p[3 * r], p[3 * r + 1], p[3 * r + 2], sum_sq(p + 3 * r, 3));
}

// Packed points [base, base + nt) of one cloud into a stage,
// asynchronously; the rest of the last group gets points that never hit.
__device__ __forceinline__ void fill_stage(float4* stage, const float4* pb, int base, int nt) {
  for (int j = threadIdx.x; j < nt; j += kThreads) cp_async_16(stage + j, pb + base + j);
  const int padded = (nt + kUnroll - 1) / kUnroll * kUnroll;
  for (int j = nt + threadIdx.x; j < padded; j += kThreads)
    stage[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
}

// Every lane of the warp: the queued pairs, oldest first, against the
// list as it stands now. The next pair is read while this one is placed.
template <int KMAX>
__device__ __forceinline__ void flush(TopK<KMAX>& best, const int2* queue, int& cnt) {
  int2 cur = queue[0];
  for (int e = 0; __any_sync(kFullMask, e < cnt); ++e) {
    const int2 next = queue[min(e + 1, kQueue - 1) * kThreads];
    const float d = __int_as_float(cur.x);
    if (e < cnt && d < best.kth()) best.insert(d, cur.y);
    cur = next;
  }
  cnt = 0;
}

// D = 3 (RandLA's xyz). A thread serves QPT queries, rows r, r + kThreads,
// ... of its block's QPT * kThreads, so one shared load of a point feeds
// QPT distances. Shared memory: two stages of kTile float4, then
// (KMAX > 1) the queues, [QPT][kQueue][kThreads] pairs of (distance's
// bits, index).
template <int KMAX, int QPT>
__global__ void __launch_bounds__(kThreads, KMAX * QPT <= 16 ? kMinBlocks : 2)
knn_xyz_kernel(const float4* __restrict__ queries, const float4* __restrict__ packed,
               float* __restrict__ out_v, int* __restrict__ out_i, int S, int N, int k) {
  extern __shared__ float4 stages[];
  int2* queue = reinterpret_cast<int2*>(stages + 2 * kTile) + threadIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * (QPT * kThreads) + threadIdx.x;
  float q0[QPT], q1[QPT], q2[QPT], qs2[QPT];
  TopK<KMAX> best[QPT];
  int cnt[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int row = row0 + u * kThreads;
    const bool valid = row < S;
    const float4 q = queries[(size_t)b * S + (valid ? row : 0)];
    q0[u] = q.x;
    q1[u] = q.y;
    q2[u] = q.z;
    qs2[u] = q.w;
    best[u].init(valid ? k : 0);  // a row past S takes part in the votes, never hits
    cnt[u] = 0;
  }
  const bool scan = __any_sync(kFullMask, row0 < S);
  const float4* pb = packed + (size_t)b * N;
  const int tiles = (N + kTile - 1) / kTile;
  fill_stage(stages, pb, 0, min(kTile, N));
  for (int t = 0; t < tiles; ++t) {
    const int base = t * kTile;
    cp_async_commit_and_wait();
    // tile t is in its stage for every thread, and every thread is done
    // with tile t - 1, whose stage the next fill overwrites
    __syncthreads();
    if (t + 1 < tiles)
      fill_stage(stages + ((t + 1) & 1) * kTile, pb, base + kTile,
                 min(kTile, N - base - kTile));
    if (!scan) continue;
    const float4* tp = stages + (t & 1) * kTile;
    const int nt = min(kTile, N - base);
    for (int j0 = 0; j0 < nt; j0 += kUnroll) {
      float d[QPT][kUnroll];
      float kth[QPT];
      bool hit = false;
#pragma unroll
      for (int u = 0; u < QPT; ++u) kth[u] = best[u].kth();
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const float4 e = tp[j0 + r];
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
          const float cross =
              __fmaf_rn(q2[u], e.z, __fmaf_rn(q1[u], e.y, __fmul_rn(q0[u], e.x)));
          d[u][r] = combine(qs2[u], cross, e.w);
          hit |= d[u][r] < kth[u];
        }
      }
      if (!__any_sync(kFullMask, hit)) continue;
      if constexpr (KMAX == 1) {
#pragma unroll
        for (int u = 0; u < QPT; ++u)
#pragma unroll
          for (int r = 0; r < kUnroll; ++r)
            if (d[u][r] < best[u].kth()) best[u].insert(d[u][r], base + j0 + r);
      } else {
        bool full = false;
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
#pragma unroll
          for (int r = 0; r < kUnroll; ++r)
            if (d[u][r] < kth[u]) {
              queue[(u * kQueue + cnt[u]) * kThreads] =
                  make_int2(__float_as_int(d[u][r]), base + j0 + r);
              ++cnt[u];
            }
          full |= cnt[u] > kQueue - kUnroll;
        }
        if (__any_sync(kFullMask, full)) {
#pragma unroll
          for (int u = 0; u < QPT; ++u)
            flush(best[u], queue + u * kQueue * kThreads, cnt[u]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    if constexpr (KMAX > 1) {
      if (scan) flush(best[u], queue + u * kQueue * kThreads, cnt[u]);
    }
    const int row = row0 + u * kThreads;
    if (row < S) {
      const size_t o = ((size_t)b * S + row) * k;
      best[u].store(out_v + o, out_i + o, k);
    }
  }
}

template <int KMAX, int QPT>
cudaError_t launch_xyz(const float4* queries, const float4* packed, float* ov, int* oi, int B,
                       int S, int N, int k, cudaStream_t stream) {
  const dim3 grid((S + QPT * kThreads - 1) / (QPT * kThreads), B);
  constexpr size_t queues =
      KMAX > 1 ? (size_t)QPT * kQueue * kThreads * sizeof(int2) : 0;
  constexpr size_t smem = 2 * kTile * sizeof(float4) + queues;
  static_assert(smem <= kSmemBytes, "above 48 KB a kernel must opt in");
  knn_xyz_kernel<KMAX, QPT><<<grid, kThreads, smem, stream>>>(queries, packed, ov, oi, S, N, k);
  return cudaGetLastError();
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

// As many queries a thread as still leave the card kFillBlocks blocks.
template <int KMAX, int QPT>
cudaError_t dispatch_xyz(const float4* queries, const float4* packed, float* ov, int* oi, int B,
                         int S, int N, int k, cudaStream_t stream) {
  if constexpr (QPT > 1) {
    if ((long)B * S < (long)kFillBlocks * QPT * kThreads)
      return dispatch_xyz<KMAX, QPT / 2>(queries, packed, ov, oi, B, S, N, k, stream);
  }
  return launch_xyz<KMAX, QPT>(queries, packed, ov, oi, B, S, N, k, stream);
}

// scratch, D = 3: the points packed as float4 [B * N], then the queries
// [B * S] unless they are the points themselves. Any other D: |p|^2
// [B * N], then |q|^2 [B * S]. Small kernels fill it first.
template <int KMAX>
cudaError_t launch(const float* q, const float* p, float* ov, int* oi, float* scratch, int B,
                   int S, int N, int D, int k, cudaStream_t stream) {
  const long qrows = (long)B * S, prows = (long)B * N;
  constexpr int kPrep = 256;
  const unsigned qblocks = (unsigned)((qrows + kPrep - 1) / kPrep);
  const unsigned pblocks = (unsigned)((prows + kPrep - 1) / kPrep);
  if (D == 3) {
    auto* packed = reinterpret_cast<float4*>(scratch);
    float4* queries = packed;
    pack_xyz_kernel<<<pblocks, kPrep, 0, stream>>>(p, packed, prows);
    if (q != p || S != N) {
      queries = packed + prows;
      pack_xyz_kernel<<<qblocks, kPrep, 0, stream>>>(q, queries, qrows);
    }
    return dispatch_xyz<KMAX, KMAX == 1 ? kQptOne : 1>(queries, packed, ov, oi, B, S, N, k,
                                                       stream);
  }
  float* d2 = scratch;
  float* s2 = scratch + prows;
  norms_kernel<<<pblocks, kPrep, 0, stream>>>(p, d2, prows, D);
  norms_kernel<<<qblocks, kPrep, 0, stream>>>(q, s2, qrows, D);
  const dim3 grid((S + kThreads - 1) / kThreads, B);
  // whole register blocks (the tail of a tile is read but masked)
  const int per_point = (D + 1) * (int)sizeof(float);
  const int tile = (kSmemBytes / per_point) / kRegBlock * kRegBlock;
  knn_wide_d_kernel<KMAX><<<grid, kThreads, (size_t)tile * per_point, stream>>>(
      q, p, s2, d2, ov, oi, S, N, D, k, tile);
  return cudaGetLastError();
}

}  // namespace

// scratch: (B * S + B * N) * (D == 3 ? 4 : 1) floats of working space,
// 16-byte aligned.
extern "C" int psg_knn(const void* query, const void* points, void* out_v, void* out_i,
                       void* scratch, int B, int S, int N, int D, int k, void* stream) {
  if (B < 0 || S < 0 || N < 1 || D < 1 || k < 1 || k > 48 || k > N ||
      B > 65535 || (size_t)(D + 1) * sizeof(float) * kRegBlock > kSmemBytes)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const auto* q = static_cast<const float*>(query);
  const auto* p = static_cast<const float*>(points);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int*>(out_i);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  // the list sizes the pyramid uses (k = 1 and 16), and the bound
  if (k <= 1) return (int)launch<1>(q, p, ov, oi, sc, B, S, N, D, k, st);
  if (k <= 16) return (int)launch<16>(q, p, ov, oi, sc, B, S, N, D, k, st);
  return (int)launch<48>(q, p, ov, oi, sc, B, S, N, D, k, st);
}
