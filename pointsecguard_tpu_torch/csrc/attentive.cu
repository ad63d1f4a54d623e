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
// Design: one thread per (row, channel). A block holds R = T / D rows
// (T threads); it stages w in shared memory (row stride 2D + 1, so a warp
// reading one column of it hits distinct banks) and the block's fn and
// fx rows at every k ([K][T] each, one coalesced element per thread). A
// thread keeps its K scores of both halves in registers (K is a template
// argument: the instances built are K = 4 and 16) and never writes a
// score to memory; exponentials are expf. The backward writes ds1, ds2
// to shared memory so that each thread can form its channel of dfn, dfx
// from the whole row. dW has no float atomics: a backward block walks
// several row tiles, sums its part of dW in shared memory, and writes it
// to its own slot of a [blocks, 2D, 2D] buffer; a second kernel sums the
// slots in block order, so dW is the same on every run. The dW work is
// skipped when w needs no gradient (dw == nullptr).
//
// What bounds it: at the RandLA shapes (K = 16, D = 8 and 32) the forward
// does 4*K*D FMAs per output element and reads fn and fx once (84 MB at
// [16, 163840, 8]); the backward about three times the forward's work
// plus the writes of dfn and dfx. Bounds: float32, 1 <= D <= 63,
// K in {4, 16}, M >= 0.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;
constexpr int kMaxD = 63;
constexpr int kMaxDwBlocks = 512;          // backward blocks when dW is summed
constexpr int kSmemLimit = 227 * 1024;     // H100: dynamic shared memory per block
constexpr int kStaticSmem = 48 * 1024;     // above this, opt in per kernel

__host__ __device__ inline int rows_per_block(int threads, int D) {
  return threads / D > 0 ? threads / D : 1;
}

// w [2D, 2D] into shared memory with row stride 2D + 1
__device__ __forceinline__ void load_w(const float* __restrict__ w, float* ws, int D) {
  const int n = 2 * D;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    ws[(e / n) * (n + 1) + e % n] = w[e];
}

// rows [m0, m0 + R) of fn and fx at every k into fs, xs ([K][T], T = R*D,
// thread t holds element t of each k-slab); rows past M read as 0
template <int K>
__device__ __forceinline__ void load_rows(const float* __restrict__ fn,
                                          const float* __restrict__ fx, float* fs,
                                          float* xs, size_t MD, size_t base, int T) {
  const int t = threadIdx.x;
  const bool valid = base + t < MD;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fs[k * T + t] = valid ? fn[k * MD + base + t] : 0.f;
    xs[k * T + t] = valid ? fx[k * MD + base + t] : 0.f;
  }
}

// the scores of channel j of one row, both halves, at every k
template <int K>
__device__ __forceinline__ void scores(const float* fs, const float* xs, const float* ws,
                                       int D, int T, int row, int j, float (&s1)[K],
                                       float (&s2)[K]) {
  const int n1 = 2 * D + 1;
#pragma unroll
  for (int k = 0; k < K; ++k) s1[k] = s2[k] = 0.f;
  for (int c = 0; c < D; ++c) {
    const float wtt = ws[c * n1 + j], wtb = ws[c * n1 + D + j];
    const float wbt = ws[(D + c) * n1 + j], wbb = ws[(D + c) * n1 + D + j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float a = fs[k * T + row + c], b = xs[k * T + row + c];
      s1[k] = fmaf(b, wbt, fmaf(a, wtt, s1[k]));
      s2[k] = fmaf(b, wbb, fmaf(a, wtb, s2[k]));
    }
  }
}

// in place: scores -> softmax over k
template <int K>
__device__ __forceinline__ void softmax_k(float (&s)[K]) {
  float mx = s[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, s[k]);
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = expf(s[k] - mx);
    z += s[k];
  }
  const float inv = 1.0f / z;
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] *= inv;
}

template <int K>
__global__ void attentive_fwd_kernel(const float* __restrict__ fn,
                                     const float* __restrict__ fx,
                                     const float* __restrict__ w, float* __restrict__ afn,
                                     float* __restrict__ afx, int M, int D) {
  extern __shared__ float smem[];
  const int T = blockDim.x;  // R * D
  const int n = 2 * D;
  float* ws = smem;
  float* fs = ws + n * (n + 1);
  float* xs = fs + K * T;
  const size_t MD = (size_t)M * D;
  const size_t base = (size_t)blockIdx.x * T;
  load_w(w, ws, D);
  load_rows<K>(fn, fx, fs, xs, MD, base, T);
  __syncthreads();
  const int t = threadIdx.x;
  if (base + t >= MD) return;
  const int row = (t / D) * D, j = t % D;
  float p1[K], p2[K];
  scores<K>(fs, xs, ws, D, T, row, j, p1, p2);
  softmax_k<K>(p1);
  softmax_k<K>(p2);
  float a1 = 0.f, a2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a1 = fmaf(fs[k * T + t], p1[k], a1);
    a2 = fmaf(xs[k * T + t], p2[k], a2);
  }
  afn[base + t] = a1;
  afx[base + t] = a2;
}

template <int K>
__global__ void attentive_bwd_kernel(const float* __restrict__ fn,
                                     const float* __restrict__ fx,
                                     const float* __restrict__ w,
                                     const float* __restrict__ g1,
                                     const float* __restrict__ g2, float* __restrict__ dfn,
                                     float* __restrict__ dfx, float* __restrict__ dw_part,
                                     int M, int D) {
  extern __shared__ float smem[];
  const int T = blockDim.x;  // R * D
  const int n = 2 * D, n1 = n + 1, E = n * n;
  float* ws = smem;
  float* fs = ws + n * n1;
  float* xs = fs + K * T;
  float* d1 = xs + K * T;  // ds1 [K][T]
  float* d2 = d1 + K * T;  // ds2 [K][T]
  float* acc = d2 + K * T; // this block's part of dW [2D, 2D]
  const int t = threadIdx.x, row = (t / D) * D, j = t % D, R = T / D;
  const size_t MD = (size_t)M * D;
  const size_t tiles = ((size_t)M + R - 1) / R;
  load_w(w, ws, D);
  if (dw_part != nullptr)
    for (int e = t; e < E; e += T) acc[e] = 0.f;
  for (size_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t base = tile * T;
    const bool valid = base + t < MD;
    __syncthreads();  // the previous tile's readers are done
    load_rows<K>(fn, fx, fs, xs, MD, base, T);
    __syncthreads();
    float p1[K], p2[K];
    scores<K>(fs, xs, ws, D, T, row, j, p1, p2);
    softmax_k<K>(p1);
    softmax_k<K>(p2);
    const float ga = valid ? g1[base + t] : 0.f;
    const float gb = valid ? g2[base + t] : 0.f;
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r1 = fmaf(p1[k], fs[k * T + t] * ga, r1);
      r2 = fmaf(p2[k], xs[k * T + t] * gb, r2);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      d1[k * T + t] = p1[k] * (fs[k * T + t] * ga - r1);
      d2[k * T + t] = p2[k] * (xs[k * T + t] * gb - r2);
    }
    __syncthreads();
    if (valid) {
      // channel j of dfn_k, dfx_k: a sum over the row's ds channels i
      float a[K], b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = p1[k] * ga;
        b[k] = p2[k] * gb;
      }
      for (int i = 0; i < D; ++i) {
        const float wtt = ws[j * n1 + i], wtb = ws[j * n1 + D + i];
        const float wbt = ws[(D + j) * n1 + i], wbb = ws[(D + j) * n1 + D + i];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float u = d1[k * T + row + i], v = d2[k * T + row + i];
          a[k] = fmaf(v, wtb, fmaf(u, wtt, a[k]));
          b[k] = fmaf(v, wbb, fmaf(u, wbt, b[k]));
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        dfn[k * MD + base + t] = a[k];
        dfx[k * MD + base + t] = b[k];
      }
    }
    if (dw_part != nullptr) {
      // entry (ra, cb) of dW: x channel ra (fn, then fx) against ds
      // channel cb (ds1, then ds2), over the tile's rows and every k;
      // rows past M hold zeros in both
      for (int e = t; e < E; e += T) {
        const int ra = e / n, cb = e % n;
        const float* x = ra < D ? fs + ra : xs + (ra - D);
        const float* d = cb < D ? d1 + cb : d2 + (cb - D);
        float s = acc[e];
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int k = 0; k < K; ++k) s = fmaf(x[k * T + r * D], d[k * T + r * D], s);
        }
        acc[e] = s;
      }
    }
  }
  if (dw_part != nullptr)
    for (int e = t; e < E; e += T) dw_part[(size_t)blockIdx.x * E + e] = acc[e];
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
  const int T = rows_per_block(kFwdThreads, D) * D;
  return sizeof(float) * ((size_t)2 * D * (2 * D + 1) + (size_t)2 * K * T);
}

size_t bwd_smem(int K, int D, bool dw) {
  const int T = rows_per_block(kBwdThreads, D) * D;
  return sizeof(float) * ((size_t)2 * D * (2 * D + 1) + (size_t)4 * K * T +
                          (dw ? (size_t)4 * D * D : 0));
}

int bwd_blocks(int M, int D, bool dw) {
  const long long R = rows_per_block(kBwdThreads, D);
  const long long tiles = (M + R - 1) / R;
  return (int)(dw && tiles > kMaxDwBlocks ? kMaxDwBlocks : tiles);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int K>
cudaError_t launch_fwd(const float* fn, const float* fx, const float* w, float* afn,
                       float* afx, int M, int D, cudaStream_t st) {
  const int T = rows_per_block(kFwdThreads, D) * D;
  const size_t bytes = fwd_smem(K, D);
  cudaError_t err = allow_smem(attentive_fwd_kernel<K>, bytes);
  if (err != cudaSuccess) return err;
  const size_t blocks = ((size_t)M * D + T - 1) / T;
  attentive_fwd_kernel<K><<<(unsigned)blocks, T, bytes, st>>>(fn, fx, w, afn, afx, M, D);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_bwd(const float* fn, const float* fx, const float* w, const float* g1,
                       const float* g2, float* dfn, float* dfx, float* dw_part, float* dw,
                       int M, int D, cudaStream_t st) {
  const bool want_dw = dw != nullptr;
  const int T = rows_per_block(kBwdThreads, D) * D;
  const size_t bytes = bwd_smem(K, D, want_dw);
  cudaError_t err = allow_smem(attentive_bwd_kernel<K>, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = bwd_blocks(M, D, want_dw);
  attentive_bwd_kernel<K><<<blocks, T, bytes, st>>>(fn, fx, w, g1, g2, dfn, dfx,
                                                    want_dw ? dw_part : nullptr, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_dw) return err;
  const int E = 4 * D * D;
  dw_reduce_kernel<<<(E + 255) / 256, 256, 0, st>>>(dw_part, dw, blocks, E);
  return cudaGetLastError();
}

bool bad_shape(int K, int M, int D) {
  return M < 0 || D < 1 || D > kMaxD || (K != 4 && K != 16);
}

}  // namespace

// Slots of the [blocks, 2D, 2D] dW buffer that psg_attentive_bwd needs
// when it sums dW.
extern "C" int psg_attentive_dw_blocks(int M, int D) {
  if (M < 1 || D < 1 || D > kMaxD) return 0;
  return bwd_blocks(M, D, true);
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
  if (K == 4) return (int)launch_fwd<4>(a, b, c, oa, ob, M, D, st);
  return (int)launch_fwd<16>(a, b, c, oa, ob, M, D, st);
}

// dw_part and dw are null when w needs no gradient; otherwise dw_part
// holds psg_attentive_dw_blocks(M, D) slots of 4*D*D floats.
extern "C" int psg_attentive_bwd(const void* fn, const void* fx, const void* w,
                                 const void* g1, const void* g2, void* dfn, void* dfx,
                                 void* dw_part, void* dw, int K, int M, int D,
                                 void* stream) {
  if (bad_shape(K, M, D) || bwd_smem(K, D, dw != nullptr) > (size_t)kSmemLimit ||
      (dw != nullptr && dw_part == nullptr))
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
  if (K == 4) return (int)launch_bwd<4>(a, b, c, ga, gb, da, db, part, out, M, D, st);
  return (int)launch_bwd<16>(a, b, c, ga, gb, da, db, part, out, M, D, st);
}
