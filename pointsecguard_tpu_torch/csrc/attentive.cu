// Fused attentive pooling, forward and backward (sm_90a).
//
// Replaces the TPU kernels of pointsecguard_tpu/ops/pallas/attentive.py:
// _fwd_kernel (forward of attentive_pool_fused) and _bwd_kernel (its
// hand-written VJP). Same contract: fn, fx [K, M, D] f32 (k-major
// neighbour features and position encodings) and the [2D, 2D] score
// projection w in x.W layout; forward
//   s1_k = fn_k.W_tt + fx_k.W_bt,   s2_k = fn_k.W_tb + fx_k.W_bb,
//   p = softmax over k per (row, channel),
//   agg_fn = sum_k p1_k * fn_k,     agg_fx = sum_k p2_k * fx_k   [M, D];
// backward, from g1 = d agg_fn and g2 = d agg_fx [M, D]:
//   r = sum_k p_k * x_k * g,  ds_k = p_k * (x_k * g - r),
//   dfn_k = p1_k * g1 + ds1_k.W_tt^T + ds2_k.W_tb^T,
//   dfx_k = p2_k * g2 + ds1_k.W_bt^T + ds2_k.W_bb^T,
//   dW = sum over rows and k of the outer products x^T.ds (four quadrants).
// W_tt, W_bt, W_tb, W_bb are w[:D, :D], w[D:, :D], w[:D, D:], w[D:, D:].
//
// What bounds it: per row the scores are a [K, 2D] x [2D, 2D] product,
// 8*K*D*D flop for 8*K*D bytes read, D flop a byte. The card's balance
// is 67 TFLOP/s : 3.35 TB/s = 20 flop a byte in float32 outside the
// tensor cores, so D = 8 is bound by bytes and D = 32 by both alike (the
// backward does the product twice and also writes dfn, dfx). Float32
// FMAs are kept (no TF32): the callers hold the result to 1e-6.
//
// Design. Channels are padded to Dp = D rounded up to 4 (zeros in shared
// memory only), and the 2*Dp score columns are cut into tiles of 4. A
// thread owns one row and one column tile at all K: a [K, 4] register
// tile of the product. Per pair of input channels it loads two float4 of
// W and K float2 of the row, and runs 8*K FMAs, so one shared-memory
// load feeds 7 FMAs (K = 16) and the FMA pipes, not the shared-memory
// port, are the limit. The threads of a row sit in one warp and read the
// same row addresses (a broadcast); W is row-major so that the column
// tiles of a warp read one contiguous line. The K scores of a channel
// never leave the registers: softmax, the weighted sum and ds are formed
// in place.
// Blocks are persistent and walk the row tiles with a stride of the grid.
// A tile (the rows of the block at every k, 32 KB at K = 16) is copied
// with cp.async into one of two stages, and the copy of the next tile is
// started before this one is computed, so device-memory reads overlap the
// arithmetic within a block as well as across blocks. 16-byte copies when
// D % 4 == 0, 4-byte copies into the padded layout otherwise: one kernel
// serves every D.
// Backward: ds (same shape as the tile) is written over the thread's own
// columns of the stage once every thread has read its scores' inputs, and
// the second product (ds . W^T, from a transposed copy of W) runs with
// the same register tile; the thread that owns score columns j owns
// channels j of dfn / dfx, so p*g starts its accumulators. When dW is
// wanted, ds goes to the second stage's room (x is still needed, and the
// copies then overlap arithmetic only across blocks), each 4 x 4 tile of
// dW is summed by one thread over the tile's rows in a fixed order and
// added to the block's slot of a [blocks, 2D, 2D] buffer, and a second
// kernel sums the slots in block order: no float atomics, dW is the same
// on every run. dW is skipped when w needs no gradient (dw == nullptr).
// Bounds: float32, 1 <= D <= 63, K in {4, 16}, M >= 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlab = 2 * kThreads;        // floats of one k of one array in a stage
constexpr int kStages = 2;                 // of the tile pipeline (the backward with dW: 1)
constexpr int kMaxD = 63;
constexpr int kSMs = 132;                  // H100 SXM; any other count is only slower
constexpr int kSmemLimit = 227 * 1024;     // H100: dynamic shared memory per block
constexpr int kStaticSmem = 48 * 1024;     // above this, opt in per kernel

// How a block of kThreads threads is laid over rows and column tiles.
struct Layout {
  int D, Dp, n;   // channels, padded channels, n = 2 * Dp score columns
  int tpr;        // threads per row: a power of two >= n / 4, at most 32
  int R;          // rows per tile
  __host__ __device__ explicit Layout(int d) : D(d), Dp((d + 3) & ~3), n(2 * Dp) {
    tpr = 1;
    while (tpr < n / 4) tpr <<= 1;
    R = kThreads / tpr;
  }
};
// A stage holds fs [K][kSlab] and xs [K][kSlab]; row r of the tile starts
// at r * Dp of each slab (R * Dp <= kSlab, with equality when Dp / 2 is a
// power of two). The constant stride keeps the K addresses of a load
// loop immediate offsets of one register.

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 16 : 0;  // 0: the destination is filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// w [2D, 2D] into ws [n][n] over the padded channels (zeros in the
// padding), and, when wt is given, its transpose
__device__ __forceinline__ void load_w(const float* __restrict__ w, float* ws, float* wt,
                                       const Layout& L) {
  const int D = L.D, Dp = L.Dp, n = L.n;
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int row = e / n, col = e % n;  // in the padded layout
    const int r = row < Dp ? row : row - Dp, c = col < Dp ? col : col - Dp;
    float v = 0.f;
    if (r < D && c < D) v = w[((row < Dp ? 0 : D) + r) * 2 * D + (col < Dp ? 0 : D) + c];
    ws[e] = v;
    if (wt != nullptr) wt[col * n + row] = v;
  }
}

// start the copy of rows [m0, m0 + R) of fn and fx at every k into fs, xs
// ([K][R][Dp] each); rows past M arrive as zeros
template <int K, bool VEC>
__device__ __forceinline__ void copy_tile(const float* __restrict__ fn,
                                           const float* __restrict__ fx, float* fs,
                                           float* xs, size_t m0, int M, const Layout& L) {
  const size_t MD = (size_t)M * L.D;
  constexpr int slab = kSlab;
  if constexpr (VEC) {  // D == Dp: the rows of one k are R*D contiguous floats
    const int V = L.R * L.D / 4;
    const size_t base = m0 * L.D;
    for (int e = threadIdx.x; e < K * V; e += kThreads) {
      const int k = e / V, v = e % V;
      const bool valid = base + 4 * v < MD;
      const size_t g = valid ? k * MD + base + 4 * v : 0;
      cp_async16(fs + k * slab + 4 * v, fn + g, valid);
      cp_async16(xs + k * slab + 4 * v, fx + g, valid);
    }
  } else {
    const int D = L.D, RD = L.R * D;
    for (int e = threadIdx.x; e < K * RD; e += kThreads) {
      const int k = e / RD, rem = e % RD, r = rem / D, c = rem % D;
      const bool valid = m0 + r < (size_t)M;
      const size_t g = valid ? k * MD + (m0 + r) * D + c : 0;
      cp_async4(fs + k * slab + r * L.Dp + c, fn + g, valid);
      cp_async4(xs + k * slab + r * L.Dp + c, fx + g, valid);
    }
  }
}

// The tile pipeline of a persistent block. With two stages the copy of
// the block's next tile is started before this one is waited for; with
// one, copies overlap arithmetic only across the blocks of an SM.
template <int K, bool VEC, int S>
__device__ __forceinline__ void pipeline_start(const float* __restrict__ fn,
                                               const float* __restrict__ fx, float* stages,
                                               size_t tile, size_t tiles, int M,
                                               const Layout& L) {
  if constexpr (S == 2) {
    if (tile < tiles)
      copy_tile<K, VEC>(fn, fx, stages, stages + K * kSlab, tile * L.R, M, L);
    cp_async_commit();
  }
}

// the stage that holds `tile` (fs; xs follows it), complete and visible
template <int K, bool VEC, int S>
__device__ __forceinline__ float* pipeline_acquire(const float* __restrict__ fn,
                                                   const float* __restrict__ fx,
                                                   float* stages, int it, size_t tile,
                                                   size_t tiles, int M, const Layout& L) {
  constexpr int stage = 2 * K * kSlab;
  float* fs = stages + (S == 2 ? (it & 1) * stage : 0);
  if constexpr (S == 2) {
    float* nfs = stages + ((it + 1) & 1) * stage;
    if (tile + gridDim.x < tiles)
      copy_tile<K, VEC>(fn, fx, nfs, nfs + K * kSlab, (tile + gridDim.x) * L.R, M, L);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    copy_tile<K, VEC>(fn, fx, fs, fs + K * kSlab, tile * L.R, M, L);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  return fs;
}

// acc[k][i] += sum over c < Dp of a_k[c] * w[c][i] + b_k[c] * w[Dp + c][i]:
// a, b point at the thread's row in the first slab of two [K][R][Dp]
// arrays, w at the thread's 4 columns of a [2Dp][n] matrix
template <int K>
__device__ __forceinline__ void row_product(float (&acc)[K][4], const float* a,
                                            const float* b, const float* w,
                                            const Layout& L) {
  const int n = L.n;
  constexpr int slab = kSlab;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const float* x = half == 0 ? a : b;
    const float* wr = w + (size_t)half * L.Dp * n;
#pragma unroll 2
    for (int c = 0; c < L.Dp; c += 2) {
      const float4 w0 = *reinterpret_cast<const float4*>(wr + c * n);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + (c + 1) * n);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 v = *reinterpret_cast<const float2*>(x + k * slab + c);
        acc[k][0] = fmaf(v.y, w1.x, fmaf(v.x, w0.x, acc[k][0]));
        acc[k][1] = fmaf(v.y, w1.y, fmaf(v.x, w0.y, acc[k][1]));
        acc[k][2] = fmaf(v.y, w1.z, fmaf(v.x, w0.z, acc[k][2]));
        acc[k][3] = fmaf(v.y, w1.w, fmaf(v.x, w0.w, acc[k][3]));
      }
    }
  }
}

// in place, per column: scores -> softmax over k
template <int K>
__device__ __forceinline__ void softmax_k(float (&s)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = s[0][i];
#pragma unroll
    for (int k = 1; k < K; ++k) mx = fmaxf(mx, s[k][i]);
    float z = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k][i] = expf(s[k][i] - mx);
      z += s[k][i];
    }
    const float inv = 1.0f / z;
#pragma unroll
    for (int k = 0; k < K; ++k) s[k][i] *= inv;
  }
}

// 4 channels of one row of an [M, D] array
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int ch, int D) {
  if constexpr (VEC) return *reinterpret_cast<const float4*>(p + ch);
  float4 v;
  v.x = ch + 0 < D ? p[ch + 0] : 0.f;
  v.y = ch + 1 < D ? p[ch + 1] : 0.f;
  v.z = ch + 2 < D ? p[ch + 2] : 0.f;
  v.w = ch + 3 < D ? p[ch + 3] : 0.f;
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int ch, int D, float4 v) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p + ch) = v;
  } else {
    if (ch + 0 < D) p[ch + 0] = v.x;
    if (ch + 1 < D) p[ch + 1] = v.y;
    if (ch + 2 < D) p[ch + 2] = v.z;
    if (ch + 3 < D) p[ch + 3] = v.w;
  }
}

// The thread's place in the block: its row of the tile, its column tile,
// and whether that tile belongs to the fn half (columns < Dp) or fx half.
struct Place {
  int r, col, ch;   // row in the tile, first padded column, first channel of its half
  bool active, top; // a tile to work on; columns of s1 / channels of fn
  __device__ Place(const Layout& L) {
    r = threadIdx.x / L.tpr;
    col = 4 * (threadIdx.x % L.tpr);
    active = col < L.n;
    top = col < L.Dp;
    ch = top ? col : col - L.Dp;
  }
};

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads)
attentive_fwd_kernel(const float* __restrict__ fn, const float* __restrict__ fx,
                     const float* __restrict__ w, float* __restrict__ afn,
                     float* __restrict__ afx, int M, int D) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D);
  const Place P(L);
  constexpr int slab = kSlab, stage = 2 * K * slab;
  float* ws = smem;
  float* tiles_s = ws + L.n * L.n;  // the stages: fs [K][kSlab], xs [K][kSlab] each
  const size_t tiles = ((size_t)M + L.R - 1) / L.R;
  if constexpr (!VEC) {  // the padding channels stay zero for the whole run
    for (int e = threadIdx.x; e < kStages * stage; e += kThreads) tiles_s[e] = 0.f;
    __syncthreads();
  }
  load_w(w, ws, nullptr, L);
  size_t tile = blockIdx.x;
  pipeline_start<K, VEC, kStages>(fn, fx, tiles_s, tile, tiles, M, L);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    float* fs = pipeline_acquire<K, VEC, kStages>(fn, fx, tiles_s, it, tile, tiles, M, L);
    float* xs = fs + K * slab;
    const size_t m = tile * L.R + P.r;
    if (P.active && m < (size_t)M) {
      float p[K][4];
#pragma unroll
      for (int k = 0; k < K; ++k) p[k][0] = p[k][1] = p[k][2] = p[k][3] = 0.f;
      row_product<K>(p, fs + P.r * L.Dp, xs + P.r * L.Dp, ws + P.col, L);
      softmax_k<K>(p);
      const float* own = (P.top ? fs : xs) + P.r * L.Dp + P.ch;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(own + k * slab);
        a.x = fmaf(x.x, p[k][0], a.x);
        a.y = fmaf(x.y, p[k][1], a.y);
        a.z = fmaf(x.z, p[k][2], a.z);
        a.w = fmaf(x.w, p[k][3], a.w);
      }
      store4<VEC>((P.top ? afn : afx) + m * D, P.ch, D, a);
    }
    __syncthreads();  // the stage is free for the next copy into it
  }
  cp_async_wait<0>();
}

template <int K, bool VEC, bool DW>
__global__ void __launch_bounds__(kThreads)
attentive_bwd_kernel(const float* __restrict__ fn, const float* __restrict__ fx,
                     const float* __restrict__ w, const float* __restrict__ g1,
                     const float* __restrict__ g2, float* __restrict__ dfn,
                     float* __restrict__ dfx, float* __restrict__ dw_part, int M, int D) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(D);
  const Place P(L);
  constexpr int slab = kSlab, stage = 2 * K * slab;
  const int n = L.n;
  // with dW the tile is needed beside ds: one stage, and ds after it
  constexpr int S = DW ? 1 : kStages;
  float* ws = smem;
  float* wt = ws + n * n;
  float* tiles_s = wt + n * n;
  float* ds_own = tiles_s + stage;  // DW only: ds1 [K][kSlab], ds2 [K][kSlab]
  const size_t MD = (size_t)M * D;
  const size_t tiles = ((size_t)M + L.R - 1) / L.R;
  const int E = 4 * D * D;
  float* my_dw = DW ? dw_part + (size_t)blockIdx.x * E : nullptr;
  if constexpr (!VEC) {
    for (int e = threadIdx.x; e < (DW ? 2 : S) * stage; e += kThreads) tiles_s[e] = 0.f;
    __syncthreads();
  }
  if constexpr (DW)
    for (int e = threadIdx.x; e < E; e += kThreads) my_dw[e] = 0.f;
  load_w(w, ws, wt, L);
  size_t tile = blockIdx.x;
  pipeline_start<K, VEC, S>(fn, fx, tiles_s, tile, tiles, M, L);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    float* fs = pipeline_acquire<K, VEC, S>(fn, fx, tiles_s, it, tile, tiles, M, L);
    float* xs = fs + K * slab;
    float* d1 = DW ? ds_own : fs;  // without dW, ds overwrites the tile
    float* d2 = d1 + K * slab;
    const size_t m = tile * L.R + P.r;
    const bool valid = P.active && m < (size_t)M;
    float acc[K][4];
    if (P.active) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
      row_product<K>(acc, fs + P.r * L.Dp, xs + P.r * L.Dp, ws + P.col, L);
      softmax_k<K>(acc);
    }
    if constexpr (!DW) __syncthreads();  // every thread has read the tile's rows
    if (P.active) {
      // own columns: r, then ds (to shared memory) and p*g (kept in acc)
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 g = valid ? load4<VEC>((P.top ? g1 : g2) + m * D, P.ch, D) : z;
      const int off = P.r * L.Dp + P.ch;
      const float* own = (P.top ? fs : xs) + off;
      float* dst = (P.top ? d1 : d2) + off;
      float4 r = z;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(own + k * slab);
        r.x = fmaf(acc[k][0], x.x * g.x, r.x);
        r.y = fmaf(acc[k][1], x.y * g.y, r.y);
        r.z = fmaf(acc[k][2], x.z * g.z, r.z);
        r.w = fmaf(acc[k][3], x.w * g.w, r.w);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // x_k is read again rather than kept: 4*K registers fewer
        const float4 x = *reinterpret_cast<const float4*>(own + k * slab);
        const float4 d = make_float4(acc[k][0] * (x.x * g.x - r.x), acc[k][1] * (x.y * g.y - r.y),
                                     acc[k][2] * (x.z * g.z - r.z), acc[k][3] * (x.w * g.w - r.w));
        *reinterpret_cast<float4*>(dst + k * slab) = d;
        acc[k][0] *= g.x;
        acc[k][1] *= g.y;
        acc[k][2] *= g.z;
        acc[k][3] *= g.w;
      }
    }
    __syncthreads();
    if (valid) {
      // channels P.ch.. of dfn_k or dfx_k: p*g + ds . W^T over the row's ds
      row_product<K>(acc, d1 + P.r * L.Dp, d2 + P.r * L.Dp, wt + P.col, L);
      float* out = (P.top ? dfn : dfx) + m * D;
#pragma unroll
      for (int k = 0; k < K; ++k)
        store4<VEC>(out + k * MD, P.ch, D,
                    make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
    }
    if constexpr (DW) {
      // dW over the padded channels in 4 x 4 register tiles: x channels
      // ra.. (fn, then fx) against ds channels cb.. (ds1, then ds2), over
      // the tile's rows and every k; rows past M hold zeros in both. A
      // tile always belongs to the same thread and the rows come in a
      // fixed order, so the block's slot is the same on every run.
      const int nb = n / 4, Dp = L.Dp;
      for (int b = threadIdx.x; b < nb * nb; b += kThreads) {
        const int ra = 4 * (b / nb), cb = 4 * (b % nb);
        const float* x = ra < Dp ? fs + ra : xs + (ra - Dp);
        const float* d = cb < Dp ? d1 + cb : d2 + (cb - Dp);
        float s[4][4] = {};
        for (int r = 0; r < L.R; ++r) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float4 xv = *reinterpret_cast<const float4*>(x + k * slab + r * Dp);
            const float4 dv = *reinterpret_cast<const float4*>(d + k * slab + r * Dp);
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
            const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xa[i], da[j], s[i][j]);
            }
          }
        }
        // padded (ra + i, cb + j) -> entry of the [2D, 2D] slot
        const int r0 = ra < Dp ? ra : ra - Dp, c0 = cb < Dp ? cb : cb - Dp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (r0 + i < D && c0 + j < D)
              my_dw[((ra < Dp ? 0 : D) + r0 + i) * 2 * D + (cb < Dp ? 0 : D) + c0 + j] +=
                  s[i][j];
          }
        }
      }
    }
    __syncthreads();  // the stage (and ds) is free for the next tile
  }
  cp_async_wait<0>();
}

// dw[e] = sum of the blocks' parts, in block order
__global__ void dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                 int blocks, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * E + e];
  dw[e] = s;
}

size_t fwd_smem(int K, int D) {
  const Layout L(D);
  return sizeof(float) * ((size_t)L.n * L.n + (size_t)4 * K * kSlab);
}

// the stages of the tile without dW; the tile and ds with it
size_t bwd_smem(int K, int D, bool dw) {
  const Layout L(D);
  return sizeof(float) * ((size_t)2 * L.n * L.n + (size_t)(dw ? 2 : kStages) * 2 * K * kSlab);
}

// persistent blocks: as many as fit on the card at once, at most one per tile
int grid_for(int M, int D, size_t smem) {
  const Layout L(D);
  const long long tiles = ((long long)M + L.R - 1) / L.R;
  long long per_sm = kSmemLimit / (long long)(smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  const long long blocks = per_sm * kSMs;
  return (int)(tiles < blocks ? tiles : blocks);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int K, bool VEC>
cudaError_t launch_fwd(const float* fn, const float* fx, const float* w, float* afn,
                       float* afx, int M, int D, cudaStream_t st) {
  const size_t bytes = fwd_smem(K, D);
  cudaError_t err = allow_smem(attentive_fwd_kernel<K, VEC>, bytes);
  if (err != cudaSuccess) return err;
  attentive_fwd_kernel<K, VEC><<<grid_for(M, D, bytes), kThreads, bytes, st>>>(
      fn, fx, w, afn, afx, M, D);
  return cudaGetLastError();
}

template <int K, bool VEC, bool DW>
cudaError_t launch_bwd(const float* fn, const float* fx, const float* w, const float* g1,
                       const float* g2, float* dfn, float* dfx, float* dw_part, float* dw,
                       int M, int D, cudaStream_t st) {
  const size_t bytes = bwd_smem(K, D, DW);
  cudaError_t err = allow_smem(attentive_bwd_kernel<K, VEC, DW>, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = grid_for(M, D, bytes);
  attentive_bwd_kernel<K, VEC, DW><<<blocks, kThreads, bytes, st>>>(
      fn, fx, w, g1, g2, dfn, dfx, dw_part, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DW) return err;
  const int E = 4 * D * D;
  dw_reduce_kernel<<<(E + 255) / 256, 256, 0, st>>>(dw_part, dw, blocks, E);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch_bwd(bool vec, bool want_dw, const float* fn, const float* fx,
                         const float* w, const float* g1, const float* g2, float* dfn,
                         float* dfx, float* dw_part, float* dw, int M, int D,
                         cudaStream_t st) {
  if (vec && want_dw)
    return launch_bwd<K, true, true>(fn, fx, w, g1, g2, dfn, dfx, dw_part, dw, M, D, st);
  if (vec) return launch_bwd<K, true, false>(fn, fx, w, g1, g2, dfn, dfx, dw_part, dw, M, D, st);
  if (want_dw)
    return launch_bwd<K, false, true>(fn, fx, w, g1, g2, dfn, dfx, dw_part, dw, M, D, st);
  return launch_bwd<K, false, false>(fn, fx, w, g1, g2, dfn, dfx, dw_part, dw, M, D, st);
}

bool bad_shape(int K, int M, int D) {
  return M < 0 || D < 1 || D > kMaxD || (K != 4 && K != 16);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

// Slots of the [blocks, 2D, 2D] dW buffer that psg_attentive_bwd needs
// when it sums dW with these K, M, D.
extern "C" int psg_attentive_dw_blocks(int K, int M, int D) {
  if (bad_shape(K, M, D) || M < 1) return 0;
  return grid_for(M, D, bwd_smem(K, D, true));
}

extern "C" int psg_attentive_fwd(const void* fn, const void* fx, const void* w,
                                 void* afn, void* afx, int K, int M, int D, void* stream) {
  if (bad_shape(K, M, D) || fwd_smem(K, D) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const auto* a = static_cast<const float*>(fn);
  const auto* b = static_cast<const float*>(fx);
  const auto* c = static_cast<const float*>(w);
  auto* oa = static_cast<float*>(afn);
  auto* ob = static_cast<float*>(afx);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned16(fn) && aligned16(fx) && aligned16(afn) &&
                   aligned16(afx);
  if (K == 4)
    return (int)(vec ? launch_fwd<4, true>(a, b, c, oa, ob, M, D, st)
                     : launch_fwd<4, false>(a, b, c, oa, ob, M, D, st));
  return (int)(vec ? launch_fwd<16, true>(a, b, c, oa, ob, M, D, st)
                   : launch_fwd<16, false>(a, b, c, oa, ob, M, D, st));
}

// dw_part and dw are null when w needs no gradient; otherwise dw_part
// holds psg_attentive_dw_blocks(K, M, D) slots of 4*D*D floats.
extern "C" int psg_attentive_bwd(const void* fn, const void* fx, const void* w,
                                 const void* g1, const void* g2, void* dfn, void* dfx,
                                 void* dw_part, void* dw, int K, int M, int D,
                                 void* stream) {
  const bool want_dw = dw != nullptr;
  if (bad_shape(K, M, D) || bwd_smem(K, D, want_dw) > (size_t)kSmemLimit ||
      (want_dw && dw_part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const auto* a = static_cast<const float*>(fn);
  const auto* b = static_cast<const float*>(fx);
  const auto* c = static_cast<const float*>(w);
  const auto* ga = static_cast<const float*>(g1);
  const auto* gb = static_cast<const float*>(g2);
  auto* da = static_cast<float*>(dfn);
  auto* db = static_cast<float*>(dfx);
  auto* part = static_cast<float*>(dw_part);
  auto* out = static_cast<float*>(dw);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && aligned16(fn) && aligned16(fx) && aligned16(g1) &&
                   aligned16(g2) && aligned16(dfn) && aligned16(dfx);
  if (K == 4) return (int)dispatch_bwd<4>(vec, want_dw, a, b, c, ga, gb, da, db, part, out, M, D, st);
  return (int)dispatch_bwd<16>(vec, want_dw, a, b, c, ga, gb, da, db, part, out, M, D, st);
}
