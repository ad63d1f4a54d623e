// Exact k nearest neighbours fused with their squared distance (sm_90a).
//
// Replaces the TPU kernel pointsecguard_tpu/ops/pallas/knn.py:_knn_kernel
// (entry point knn_pallas) with two kernels: knn_xyz_kernel for D = 3
// (RandLA's pyramid, ResGCN's head graph) and knn_tiled_kernel for every
// other D (ResGCN's feature-space graphs, D = 64 and wider). Same contract
// for both: query [B, S, D] and points [B, N, D] f32 in; for each query the
// k smallest squared distances, ascending, and their int32 point indices,
// ties to the first occurrence (a stable sort of the distance row cut to
// k); the [S, N] distance matrix is never written to device memory. NaN
// inputs are outside the contract.
//
// Arithmetic: the distance is (s2 - 2*cross) + d2, rounded exactly as the
// port's square_distance (ops/distance.py) rounds it. s2 = |q|^2 and
// d2 = |p|^2 are made by small kernels of this file with the plain
// version's own roundings (sum_sq below); cross = q.p is a fused
// multiply-add chain over the coordinates in index order,
// fma(q2, p2, fma(q1, p1, q0 * p0)), which is how a float32 GEMM
// accumulates its product. s2 - 2*cross is one fma(-2, cross, s2):
// doubling is exact, so it rounds as the subtraction does. Every step is
// written with __fmul_rn / __fmaf_rn / __fadd_rn so that nvcc cannot
// re-contract it. Float32 FMA only, in both kernels: TF32, 3xTF32 or the
// tensor cores would round the cross term otherwise and flip near-tie
// neighbours.
//
// D = 3. What bounds it: operations, not bytes (device memory sees the
// points once per block of queries and the outputs once), and of the
// operations not the float pipe alone: a pair costs 5 float instructions,
// one compare (half rate on an H100) and one 16-byte broadcast load from
// shared memory, and that load is what saturates first. A warp-wide
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
// Design (D = 3): one thread per query (two at k = 1, where registers
// allow it and one load then feeds two distances), the query and its k
// best (value, index) pairs in registers (a sorted list of KMAX slots, all
// indices compile-time constants, so it never goes to local memory).
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
//
// Any other D. What bounds it: the float pipe. A pair costs D FMAs and 3
// more instructions, so at D = 64 the bound is the FMA rate and a kernel
// that loads an operand from shared memory for every FMA (a thread per
// query, a point at a time) runs at a twentieth of it. The design is an
// SGEMM's, with the selection beside it:
//  - A block of kWQ queries walks the points in tiles of kWP. For each
//    tile it forms the [kWQ, kWP] block of cross terms in registers, each
//    thread a kWM x kWN micro-tile: per coordinate, four 16-byte shared
//    loads feed 64 FMAs. Queries and points are staged transposed,
//    [coordinate][row], in chunks of kWC coordinates, by 4-byte cp.async
//    (any D, any alignment). The points stream through two stages, so the
//    next chunk arrives while this one is multiplied, with one barrier a
//    chunk. The block's queries are copied once and stay (up to
//    kWQSlots chunks, D <= 64: ResGCN's graphs), else they stream beside
//    the points: held, they take two thirds of the copies out of every
//    chunk. The accumulators carry across chunks, so every pair's chain
//    runs in coordinate order.
//  - D is padded with zeros to a whole chunk, and rows past S or N are
//    zeros. That is exact: the chain starts from +0 instead of q0 * p0,
//    and fma(0, 0, acc) is acc; the two differ at most in the sign of a
//    zero cross term, and fma(-2, +-0, s2) + d2 is the same number either
//    way (s2, d2 >= 0).
//  - Epilogue: (s2 - 2*cross) + d2 into a [kWQ][kWP + 4] distance block in
//    shared memory (+inf past N), padded so that 16-byte rows do not
//    conflict.
//  - Selection: the tile's row is the queue of the D = 3 kernel's deferred
//    insertion. Thread t owns query t of the block and its TopK list; it
//    marks the points of its row below its k-th value as it stood at the
//    tile's start (a 64-bit mask), then the 32 lanes of a warp walk their
//    marks together, lowest index first, re-testing each against the
//    current k-th value and inserting the survivors by the rule above. A
//    warp pays the largest mark count of its lanes in a tile, not one
//    insertion per point: the first tile is nearly all marks, later ones
//    about k / t at tile t. A 48-slot list makes each step of the walk
//    three times a 16-slot one's: the call at k = 48 is the slower one.
//  - The list stays in registers (ptxas must report no spill; chip_smoke.py
//    fails the build if it does). 76 KB of dynamic shared memory a block,
//    two blocks an SM, so [8, 4096] is one wave of 256 blocks on 132 SMs.

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
constexpr int kSmemBytes = 48 * 1024;      // static-size limit, no attribute
constexpr unsigned kFullMask = 0xffffffffu;
// the any-D kernel (knn_tiled_kernel)
constexpr int kWQ = 128;                   // queries per block, one a thread in the selection
constexpr int kWP = 64;                    // points per tile
constexpr int kWC = 16;                    // coordinates per chunk (D is padded to whole ones)
constexpr int kWM = 8;                     // queries of a thread's micro-tile ...
constexpr int kWN = 8;                     // ... and its points
constexpr int kWQStride = kWQ + 4;         // floats a staged coordinate of the queries ...
constexpr int kWPStride = kWP + 4;         // ... of the points, and a row of the distance block
constexpr int kWQChunk = kWC * kWQStride;  // floats a staged chunk of the queries ...
constexpr int kWPChunk = kWC * kWPStride;  // ... and of the points
constexpr int kWQSlots = 4;                // query chunks held: all of them up to D = 64
constexpr int kLoadLanes = 8;              // lanes that copy one row's 8 coordinates
constexpr int kMaxD = 4096;                // the contract's widest D
constexpr size_t kWSmemBytes =
    (kWQSlots * kWQChunk + 2 * kWPChunk + kWQ * kWPStride + kWQ) * sizeof(float);

static_assert(kTile % kUnroll == 0 && kQueue >= 2 * kUnroll, "queue holds two groups");
static_assert(kWQ == kThreads && (kWQ / kWM) * (kWP / kWN) == kThreads, "one query a thread");
static_assert(kWM == 8 && kWN == 8 && kWP == 64, "two float4 halves a side; a 64-bit mask a row");
static_assert(kWC % kLoadLanes == 0 && kWQ % (kThreads / kLoadLanes) == 0 &&
              kWP % (kThreads / kLoadLanes) == 0, "whole copy passes");
static_assert(kWQSlots >= 2, "streamed queries take two slots");

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

// 4 bytes, or (ok false) 4 zero bytes and nothing read from gmem
__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// Any D. Rows [0, ROWS) of a [rows][D] matrix starting at `first`,
// coordinates [c0, c0 + kWC), transposed into a stage [kWC][STRIDE] by
// 4-byte cp.async; rows at or past `rows` and coordinates past D become
// zeros. Lane l copies coordinates l % 8 and 8 + l % 8 of rows l / 8 + 16 g,
// so a warp reads four 32-byte runs and writes 32 distinct banks.
template <int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(float* stage, const float* __restrict__ first,
                                          int rows, int c0, int D) {
  constexpr int kRowsPerPass = kThreads / kLoadLanes;
  const int lrow = threadIdx.x / kLoadLanes, lcol = threadIdx.x % kLoadLanes;
#pragma unroll
  for (int h = 0; h < kWC / kLoadLanes; ++h) {
    const int cc = h * kLoadLanes + lcol;
    const int c = c0 + cc;
#pragma unroll
    for (int g = 0; g < ROWS / kRowsPerPass; ++g) {
      const int r = g * kRowsPerPass + lrow;
      const bool ok = c < D && r < rows;
      cp_async_4(stage + cc * STRIDE + r, ok ? first + (size_t)r * D + c : first, ok);
    }
  }
}

// One query's row of a tile's distance block against its list: mark the
// points below the k-th value as it stood at the tile's start, then the
// warp's lanes walk their marks together, lowest index first, each
// re-tested against the current k-th value (a stale threshold is never
// below it, so the marks hold every point that point-by-point insertion
// would take).
template <int KMAX>
__device__ __forceinline__ void select_row(TopK<KMAX>& best, const float* row, int base) {
  const float kth = best.kth();
  unsigned lo = 0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < kWP / 2; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + j);
    const float4 c = *reinterpret_cast<const float4*>(row + kWP / 2 + j);
    lo |= (unsigned)(a.x < kth) << j | (unsigned)(a.y < kth) << (j + 1) |
          (unsigned)(a.z < kth) << (j + 2) | (unsigned)(a.w < kth) << (j + 3);
    hi |= (unsigned)(c.x < kth) << j | (unsigned)(c.y < kth) << (j + 1) |
          (unsigned)(c.z < kth) << (j + 2) | (unsigned)(c.w < kth) << (j + 3);
  }
  while (__any_sync(kFullMask, (lo | hi) != 0u)) {
    if ((lo | hi) != 0u) {
      int j;
      if (lo != 0u) {
        j = __ffs(lo) - 1;
        lo &= lo - 1u;
      } else {
        j = kWP / 2 + __ffs(hi) - 1;
        hi &= hi - 1u;
      }
      const float d = row[j];
      if (d < best.kth()) best.insert(d, base + j);
    }
  }
}

// Any D (see the file's note): a block of kWQ queries against tiles of kWP
// points, the cross terms as an SGEMM micro-tile from transposed chunks,
// then the tile's distance block through select_row. Thread (ty, tx) of
// the micro-tile owns queries ty * 4 + i and kWQ / 2 + ty * 4 + i and
// points tx * 4 + j and kWP / 2 + tx * 4 + j (i, j < 4); in the selection
// thread t owns query t.
template <int KMAX>
__global__ void __launch_bounds__(kThreads, 2)
knn_tiled_kernel(const float* __restrict__ query, const float* __restrict__ points,
                 const float* __restrict__ s2, const float* __restrict__ d2,
                 float* __restrict__ out_v, int* __restrict__ out_i, int S, int N, int D,
                 int k) {
  extern __shared__ float4 wsmem[];
  float* qbuf = reinterpret_cast<float*>(wsmem);  // kWQSlots x [kWC][kWQStride]
  float* pbuf = qbuf + kWQSlots * kWQChunk;       // 2 x [kWC][kWPStride]
  float* dist = pbuf + 2 * kWPChunk;              // [kWQ][kWPStride]
  float* qnorm = dist + kWQ * kWPStride;          // [kWQ]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kWQ;
  const int tx = tid % (kWP / kWN), ty = tid / (kWP / kWN);
  const bool valid = q0 + tid < S;
  qnorm[tid] = valid ? s2[(size_t)b * S + q0 + tid] : 0.f;
  TopK<KMAX> best;
  best.init(valid ? k : 0);  // a row past S never hits
  const int chunks = (D + kWC - 1) / kWC;
  const int tiles = (N + kWP - 1) / kWP;
  // the block's queries stay in shared memory when they fit (D <= 64),
  // else they stream beside the points, a chunk a stage
  const bool resident = chunks <= kWQSlots;
  const float* qfirst = query + ((size_t)b * S + q0) * D;
  const float* pfirst = points + (size_t)b * N * D;
  const float* d2b = d2 + (size_t)b * N;
  float acc[kWM][kWN];
#pragma unroll
  for (int i = 0; i < kWM; ++i)
#pragma unroll
    for (int j = 0; j < kWN; ++j) acc[i][j] = 0.f;
  for (int j = 0; j < (resident ? chunks : 1); ++j)
    load_rows<kWQ, kWQStride>(qbuf + j * kWQChunk, qfirst, S - q0, j * kWC, D);
  load_rows<kWP, kWPStride>(pbuf, pfirst, N, 0, D);
  cp_async_commit();
  int t = 0, c = 0;  // tile and chunk in stage s & 1
  for (int s = 0; t < tiles; ++s) {
    cp_async_wait_all();
    // chunk s is in its stages for every thread, and every thread is done
    // with chunk s - 1, whose stages the next copy overwrites, and with
    // the last tile's distance block
    __syncthreads();
    const bool last = c + 1 == chunks;
    const int next_t = last ? t + 1 : t, next_c = last ? 0 : c + 1;
    if (next_t < tiles) {
      if (!resident)
        load_rows<kWQ, kWQStride>(qbuf + ((s + 1) & 1) * kWQChunk, qfirst, S - q0,
                                  next_c * kWC, D);
      load_rows<kWP, kWPStride>(pbuf + ((s + 1) & 1) * kWPChunk,
                                pfirst + (size_t)next_t * kWP * D, N - next_t * kWP,
                                next_c * kWC, D);
      cp_async_commit();
    }
    float pd2[kWN];  // |p|^2 of the thread's points, +inf past N
    if (last) {
#pragma unroll
      for (int j = 0; j < kWN; ++j) {
        const int p = t * kWP + (j / 4) * (kWP / 2) + tx * 4 + j % 4;
        pd2[j] = p < N ? __ldg(d2b + p) : INFINITY;
      }
    }
    const float* qs = qbuf + (resident ? c : s & 1) * kWQChunk;
    const float* ps = pbuf + (s & 1) * kWPChunk;
#pragma unroll
    for (int cc = 0; cc < kWC; ++cc) {
      const float4 a0 = *reinterpret_cast<const float4*>(qs + cc * kWQStride + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(qs + cc * kWQStride + kWQ / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(ps + cc * kWPStride + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(ps + cc * kWPStride + kWP / 2 + tx * 4);
      const float qa[kWM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float pb[kWN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kWM; ++i)
#pragma unroll
        for (int j = 0; j < kWN; ++j) acc[i][j] = __fmaf_rn(qa[i], pb[j], acc[i][j]);
    }
    if (last) {
#pragma unroll
      for (int i = 0; i < kWM; ++i) {
        const int row = (i / 4) * (kWQ / 2) + ty * 4 + i % 4;
        const float qs2 = qnorm[row];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 o = make_float4(combine(qs2, acc[i][4 * h], pd2[4 * h]),
                                       combine(qs2, acc[i][4 * h + 1], pd2[4 * h + 1]),
                                       combine(qs2, acc[i][4 * h + 2], pd2[4 * h + 2]),
                                       combine(qs2, acc[i][4 * h + 3], pd2[4 * h + 3]));
          *reinterpret_cast<float4*>(dist + row * kWPStride + h * (kWP / 2) + tx * 4) = o;
        }
#pragma unroll
        for (int j = 0; j < kWN; ++j) acc[i][j] = 0.f;
      }
      __syncthreads();  // the tile's distance block is whole
      select_row(best, dist + tid * kWPStride, t * kWP);
    }
    t = next_t;
    c = next_c;
  }
  if (valid) {
    const size_t o = ((size_t)b * S + q0 + tid) * k;
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
// [B * N], then |q|^2 [B * S] (unused when the queries are the points).
// Small kernels fill it first.
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
  if (q != p || S != N)
    norms_kernel<<<qblocks, kPrep, 0, stream>>>(q, s2, qrows, D);
  else
    s2 = d2;
  // above 48 KB of dynamic shared memory a kernel must opt in
  const cudaError_t attr = cudaFuncSetAttribute(
      knn_tiled_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kWQ - 1) / kWQ, B);
  knn_tiled_kernel<KMAX><<<grid, kThreads, kWSmemBytes, stream>>>(q, p, s2, d2, ov, oi, S, N,
                                                                  D, k);
  return cudaGetLastError();
}

}  // namespace

// scratch: (B * S + B * N) * (D == 3 ? 4 : 1) floats of working space,
// 16-byte aligned.
extern "C" int psg_knn(const void* query, const void* points, void* out_v, void* out_i,
                       void* scratch, int B, int S, int N, int D, int k, void* stream) {
  if (B < 0 || S < 0 || N < 1 || D < 1 || k < 1 || k > 48 || k > N ||
      B > 65535 || D > kMaxD)
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
