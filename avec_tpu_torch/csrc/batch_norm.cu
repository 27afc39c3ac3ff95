// Training-mode BatchNorm with batch statistics for Hopper (sm_90a): the
// statistics, the normalise-and-affine with an optional residual add and
// ReLU, and the backward's two passes.
//
// Replaces: no Pallas kernel. The JAX package leaves BatchNorm to XLA, which
// fuses its statistics, normalisation, affine, ReLU and residual add into
// the surrounding fusions; run op by op in PyTorch the same arithmetic took
// about 16 fp32 kernels forward and 34 backward per BatchNorm, and autograd
// kept three fp32 copies of every activation. Reached from
// `ops/batch_norm.py` (the ResNet trunk's BatchNorms through
// `ops/layers.py:BatchNorm`, the video stem's statistics and BN backward in
// `ops/stem.py:_FusedStemTrain`).
//
// x is viewed as (outer, C, inner): NCHW and (B, C, T) tensors have inner =
// H*W or T ("planes"); channels-last tensors, rows of C channels, have inner
// = 1 ("rows"). Activations are bf16 or fp32; every sum and every per-element
// step is fp32, each multiply and add rounded on its own as the plain
// PyTorch version computes them, and outputs are rounded to x's dtype.
//
//   stats:      per channel S1 = sum x, S2 = sum x^2; mean = S1/n,
//               var = max(S2/n - mean^2, 0), rstd = 1 / sqrt(var + eps)
//   apply:      y = round((x - mean) rstd w + b); y = round(y + res) with a
//               residual; y = relu(y) with ReLU
//   bwd-reduce: g' = g where y > 0, else 0 (with ReLU; else g' = g);
//               xhat = (x - mean) rstd from the saved x; per channel
//               db = sum g', dw = sum g' xhat
//   bwd-dx:     dx = round(w rstd ((g' - db/n) - xhat dw/n)); g' written
//               for the residual branch where the ReLU gated it
//
// What bounds it on the H100: memory, a few operations per byte. A trunk
// BatchNorm of stage 1 (6432 frames of 64 x 22 x 22 bf16) reads 398 MB for
// its statistics, 398 MB and writes 398 MB to apply them (0.24 ms at 3.35
// TB/s with no residual), and the backward reads x, y and g twice and writes
// dx (and g').
//
// Design: each thread loads 16 bytes at a time (8 bf16 or 4 fp32 values;
// one value where C or inner or a pointer's alignment does not allow it).
// Rows: a block of 256 threads is TX threads across channel groups by TY
// across rows (TX the power of two at or above C / 8, at most 32), so a warp
// reads whole rows and a thread keeps its channels' parameters in registers
// while it walks rows TY * gridDim.x apart. Planes: a block owns one channel
// (blockIdx.y) and a share of its (outer, inner) positions. The two sums are
// per-block partials in a fixed order (a shared-memory tree, warp shuffles),
// then one small kernel adds the partials of each channel in a fixed order
// and finishes the per-channel values: no atomics, so the same input gives
// the same bits. gridDim.x (the number of partials) is the wrapper's, a
// function of the shape alone. The statistics' plain version
// (`ops/batch_norm.py:sums_reference`) adds the same terms in this order,
// and every step of the statistics is an IEEE fp32 operation, so the plain
// path and the kernels normalise with the same bits.

#include <initializer_list>

#include "tile.cuh"

namespace {

using avec::load16;
using avec::rnd;

constexpr int THREADS = 256;
// The finishing kernel: FINISH_ROWS threads across a channel's partials
// (few serial adds each, so that the plain version's walk is short) by
// FINISH_COLS channels a block.
constexpr int FINISH_ROWS = 64;
constexpr int FINISH_COLS = THREADS / FINISH_ROWS;

enum Mode { STATS = 0, BWD = 1 };

struct Shape {
  long long outer;  // rows when inner == 1
  long long inner;
  int c;
  int tx, ty;  // rows: threads across channel groups and across rows
  float n;     // positions per channel
};

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  auto bits = [](float x) { return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x)); };
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = bits(v[2 * i]) | bits(v[2 * i + 1]) << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, int V>
__device__ __forceinline__ void loadv(const T* p, float (&v)[V]) {
  if constexpr (V == 1) v[0] = avec::to_f(*p);
  else load16(p, v);
}
template <typename T, int V>
__device__ __forceinline__ void storev(T* p, const float (&v)[V]) {
  if constexpr (V == 1) *p = avec::from_f<T>(v[0]);
  else store16(p, v);
}

__device__ __forceinline__ float xhat(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

// relu as torch.relu computes it: x <= 0 gives +0, NaN stays NaN.
__device__ __forceinline__ float relu(float x) { return x <= 0.f ? 0.f : x; }

// The incoming gradient gated by the ReLU's output y (threshold_backward).
__device__ __forceinline__ float gate(float g, float y) { return y <= 0.f ? 0.f : g; }

// The two per-element terms summed by the reduction of `MODE`.
template <int MODE>
__device__ __forceinline__ void terms(float x, float g, float y, bool gated, float mean,
                                      float rstd, float& a, float& b) {
  if constexpr (MODE == STATS) {
    a = __fadd_rn(a, x);
    b = __fadd_rn(b, __fmul_rn(x, x));
  } else {
    const float gp = gated ? gate(g, y) : g;
    a += gp;
    b = fmaf(gp, xhat(x, mean, rstd), b);
  }
}

// Rows: this thread's channel group, first channel (c0) and first row.
struct RowWalk {
  int tx, ty, c0;
  bool active;
  __device__ RowWalk(const Shape& s, int v) {
    tx = threadIdx.x % s.tx;
    ty = threadIdx.x / s.tx;
    c0 = (blockIdx.y * s.tx + tx) * v;
    active = c0 < s.c;
  }
};

// Per-block partials of the two sums of `MODE` (STATS: x, x^2; BWD: g',
// g' xhat) into part[(blockIdx.x * 2 + k) * C + c].
template <typename T, int V, bool ROWS, int MODE>
__global__ void __launch_bounds__(THREADS)
bn_sums_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ y,
               const float* __restrict__ st, float* __restrict__ part, Shape s) {
  const bool gated = y != nullptr;
  if constexpr (ROWS) {
    __shared__ float sh[2][THREADS * V];
    const RowWalk w(s, V);
    float a[V], b[V], mean[V], rstd[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] = b[v] = 0.f;
      mean[v] = rstd[v] = 0.f;
      if (MODE == BWD && w.active) mean[v] = st[w.c0 + v], rstd[v] = st[2 * s.c + w.c0 + v];
    }
    if (w.active) {
      const long long step = (long long)gridDim.x * s.ty;
      for (long long r = (long long)blockIdx.x * s.ty + w.ty; r < s.outer; r += step) {
        const long long off = r * s.c + w.c0;
        float xv[V], gv[V], yv[V];
        loadv<T, V>(x + off, xv);
        if (MODE == BWD) loadv<T, V>(g + off, gv);
        if (MODE == BWD && gated) loadv<T, V>(y + off, yv);
#pragma unroll
        for (int v = 0; v < V; ++v)
          terms<MODE>(xv[v], MODE == BWD ? gv[v] : 0.f, MODE == BWD && gated ? yv[v] : 0.f,
                      gated, mean[v], rstd[v], a[v], b[v]);
      }
    }
    const int col = w.tx * V;
    const int row_w = s.tx * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sh[0][w.ty * row_w + col + v] = a[v];
      sh[1][w.ty * row_w + col + v] = b[v];
    }
    for (int half = s.ty / 2; half > 0; half /= 2) {
      __syncthreads();
      if (w.ty < half)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sh[0][w.ty * row_w + col + v] += sh[0][(w.ty + half) * row_w + col + v];
          sh[1][w.ty * row_w + col + v] += sh[1][(w.ty + half) * row_w + col + v];
        }
    }
    if (w.ty == 0 && w.active) {
      float* p = part + (long long)blockIdx.x * 2 * s.c + w.c0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        p[v] = sh[0][col + v];
        p[s.c + v] = sh[1][col + v];
      }
    }
  } else {
    __shared__ float sh[2][THREADS / 32];
    const long long per = s.inner / V;  // vectors in one (outer, c) run
    const long long m = s.outer * per;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int c = blockIdx.y; c < s.c; c += gridDim.y) {
      const float mean = MODE == BWD ? st[c] : 0.f, rstd = MODE == BWD ? st[2 * s.c + c] : 0.f;
      float a = 0.f, b = 0.f;
      for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < m;
           e += (long long)gridDim.x * THREADS) {
        const long long o = e / per;
        const long long off = (o * s.c + c) * s.inner + (e - o * per) * V;
        float xv[V], gv[V], yv[V];
        loadv<T, V>(x + off, xv);
        if (MODE == BWD) loadv<T, V>(g + off, gv);
        if (MODE == BWD && gated) loadv<T, V>(y + off, yv);
        float ea = 0.f, eb = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v)
          terms<MODE>(xv[v], MODE == BWD ? gv[v] : 0.f, MODE == BWD && gated ? yv[v] : 0.f,
                      gated, mean, rstd, ea, eb);
        a += ea;
        b += eb;
      }
#pragma unroll
      for (int d = 16; d > 0; d /= 2) {
        a += __shfl_down_sync(0xffffffffu, a, d);
        b += __shfl_down_sync(0xffffffffu, b, d);
      }
      __syncthreads();  // the previous channel's reads of sh are done
      if (lane == 0) sh[0][warp] = a, sh[1][warp] = b;
      __syncthreads();
      if (threadIdx.x == 0) {
        float ta = 0.f, tb = 0.f;
        for (int i = 0; i < THREADS / 32; ++i) ta += sh[0][i], tb += sh[1][i];
        part[(long long)blockIdx.x * 2 * s.c + c] = ta;
        part[((long long)blockIdx.x * 2 + 1) * s.c + c] = tb;
      }
    }
  }
}

// Adds each channel's `splits` partials in a fixed order and finishes it.
// STATS: out = (mean, var, rstd), (3, C). BWD: out = (db, dw, w rstd, db/n,
// dw/n), (5, C).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
bn_finish_kernel(const float* __restrict__ part, int splits, int c, float n, float eps,
                 const float* __restrict__ st, const float* __restrict__ wt,
                 float* __restrict__ out) {
  __shared__ float sh[2][FINISH_ROWS][FINISH_COLS];
  const int tx = threadIdx.x % FINISH_COLS, ty = threadIdx.x / FINISH_COLS;
  const int ch = blockIdx.x * FINISH_COLS + tx;
  float a = 0.f, b = 0.f;
  if (ch < c)
    for (int j = ty; j < splits; j += FINISH_ROWS) {
      a += part[(long long)j * 2 * c + ch];
      b += part[((long long)j * 2 + 1) * c + ch];
    }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  for (int half = FINISH_ROWS / 2; half > 0; half /= 2) {
    __syncthreads();
    if (ty < half) {
      sh[0][ty][tx] += sh[0][ty + half][tx];
      sh[1][ty][tx] += sh[1][ty + half][tx];
    }
  }
  if (ty != 0 || ch >= c) return;
  a = sh[0][0][tx];
  b = sh[1][0][tx];
  if constexpr (MODE == STATS) {
    const float mean = __fdiv_rn(a, n);
    float var = __fsub_rn(__fdiv_rn(b, n), __fmul_rn(mean, mean));
    var = var < 0.f ? 0.f : var;  // clamp(min=0): NaN stays NaN
    out[ch] = mean;
    out[c + ch] = var;
    out[2 * c + ch] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  } else {
    out[ch] = a;
    out[c + ch] = b;
    out[2 * c + ch] = __fmul_rn(wt[ch], st[2 * c + ch]);
    out[3 * c + ch] = __fdiv_rn(a, n);
    out[4 * c + ch] = __fdiv_rn(b, n);
  }
}

template <typename T>
__device__ __forceinline__ float apply1(float x, float r, bool res, bool relu_, float mean,
                                        float rstd, float w, float b) {
  float y = rnd<T>(__fadd_rn(__fmul_rn(xhat(x, mean, rstd), w), b));
  if (res) y = rnd<T>(__fadd_rn(y, r));
  return relu_ ? relu(y) : y;
}

template <typename T, int V, bool ROWS>
__global__ void __launch_bounds__(THREADS)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ st,
                const float* __restrict__ wt, const float* __restrict__ bs, T* __restrict__ out,
                bool relu_, Shape s) {
  const bool has_res = res != nullptr;
  if constexpr (ROWS) {
    const RowWalk w(s, V);
    if (!w.active) return;
    float mean[V], rstd[V], wv[V], bv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mean[v] = st[w.c0 + v];
      rstd[v] = st[2 * s.c + w.c0 + v];
      wv[v] = wt[w.c0 + v];
      bv[v] = bs[w.c0 + v];
    }
    const long long step = (long long)gridDim.x * s.ty;
    for (long long r = (long long)blockIdx.x * s.ty + w.ty; r < s.outer; r += step) {
      const long long off = r * s.c + w.c0;
      float xv[V], rv[V], o[V];
      loadv<T, V>(x + off, xv);
      if (has_res) loadv<T, V>(res + off, rv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = apply1<T>(xv[v], has_res ? rv[v] : 0.f, has_res, relu_, mean[v], rstd[v], wv[v],
                         bv[v]);
      storev<T, V>(out + off, o);
    }
  } else {
    const long long per = s.inner / V;
    const long long m = s.outer * per;
    for (int c = blockIdx.y; c < s.c; c += gridDim.y) {
      const float mean = st[c], rstd = st[2 * s.c + c], wc = wt[c], bc = bs[c];
      for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < m;
           e += (long long)gridDim.x * THREADS) {
        const long long o = e / per;
        const long long off = (o * s.c + c) * s.inner + (e - o * per) * V;
        float xv[V], rv[V], ov[V];
        loadv<T, V>(x + off, xv);
        if (has_res) loadv<T, V>(res + off, rv);
#pragma unroll
        for (int v = 0; v < V; ++v)
          ov[v] = apply1<T>(xv[v], has_res ? rv[v] : 0.f, has_res, relu_, mean, rstd, wc, bc);
        storev<T, V>(out + off, ov);
      }
    }
  }
}

// dx = w rstd ((g' - db/n) - xhat dw/n), each step rounded as the plain
// version computes it.
__device__ __forceinline__ float dx1(float gp, float x, float mean, float rstd, float k,
                                     float m1, float m2) {
  return __fmul_rn(k, __fsub_rn(__fsub_rn(gp, m1), __fmul_rn(xhat(x, mean, rstd), m2)));
}

template <typename T, int V, bool ROWS>
__global__ void __launch_bounds__(THREADS)
bn_bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ x,
                 const float* __restrict__ st, const float* __restrict__ red, T* __restrict__ dx,
                 T* __restrict__ gres, Shape s) {
  const bool gated = y != nullptr, write_g = gres != nullptr;
  const float* mean_p = st;
  const float* rstd_p = st + 2 * s.c;
  const float* k_p = red + 2 * s.c;
  const float* m1_p = red + 3 * s.c;
  const float* m2_p = red + 4 * s.c;
  if constexpr (ROWS) {
    const RowWalk w(s, V);
    if (!w.active) return;
    float mean[V], rstd[V], k[V], m1[V], m2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mean[v] = mean_p[w.c0 + v];
      rstd[v] = rstd_p[w.c0 + v];
      k[v] = k_p[w.c0 + v];
      m1[v] = m1_p[w.c0 + v];
      m2[v] = m2_p[w.c0 + v];
    }
    const long long step = (long long)gridDim.x * s.ty;
    for (long long r = (long long)blockIdx.x * s.ty + w.ty; r < s.outer; r += step) {
      const long long off = r * s.c + w.c0;
      float gv[V], yv[V], xv[V], o[V];
      loadv<T, V>(g + off, gv);
      if (gated) loadv<T, V>(y + off, yv);
      loadv<T, V>(x + off, xv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (gated) gv[v] = gate(gv[v], yv[v]);
        o[v] = dx1(gv[v], xv[v], mean[v], rstd[v], k[v], m1[v], m2[v]);
      }
      storev<T, V>(dx + off, o);
      if (write_g) storev<T, V>(gres + off, gv);
    }
  } else {
    const long long per = s.inner / V;
    const long long m = s.outer * per;
    for (int c = blockIdx.y; c < s.c; c += gridDim.y) {
      const float mean = mean_p[c], rstd = rstd_p[c], k = k_p[c], m1 = m1_p[c], m2 = m2_p[c];
      for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < m;
           e += (long long)gridDim.x * THREADS) {
        const long long o = e / per;
        const long long off = (o * s.c + c) * s.inner + (e - o * per) * V;
        float gv[V], yv[V], xv[V], ov[V];
        loadv<T, V>(g + off, gv);
        if (gated) loadv<T, V>(y + off, yv);
        loadv<T, V>(x + off, xv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (gated) gv[v] = gate(gv[v], yv[v]);
          ov[v] = dx1(gv[v], xv[v], mean, rstd, k, m1, m2);
        }
        storev<T, V>(dx + off, ov);
        if (write_g) storev<T, V>(gres + off, gv);
      }
    }
  }
}

// The launch geometry of a (outer, C, inner) tensor read V values at a time
// by `splits` blocks along the reduced axis.
struct Launch {
  Shape s;
  dim3 grid;
};

Launch geometry(long long outer, int c, long long inner, int splits, int v, float n) {
  Launch l;
  l.s.outer = outer;
  l.s.inner = inner;
  l.s.c = c;
  l.s.n = n;
  if (inner == 1) {
    const int groups = c / v;
    int tx = 1;
    while (tx < groups && tx < 32) tx *= 2;
    l.s.tx = tx;
    l.s.ty = THREADS / tx;
    l.grid = dim3((unsigned)splits, (unsigned)((groups + tx - 1) / tx));
  } else {
    l.s.tx = l.s.ty = 0;
    l.grid = dim3((unsigned)splits, (unsigned)(c < 65535 ? c : 65535));
  }
  return l;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16 bytes a thread where the channel run (rows: C; planes: inner) holds a
// whole number of them and every tensor is 16-byte aligned; else one value.
template <typename T>
int width(int c, long long inner, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(T);
  if ((inner == 1 ? c % V : inner % V) != 0) return 1;
  for (const void* p : ptrs)
    if (p != nullptr && !aligned16(p)) return 1;
  return V;
}

bool bad_shape(long long outer, int c, long long inner, int splits) {
  return outer <= 0 || c <= 0 || inner <= 0 || splits <= 0 || splits > 65535 ||
         (inner == 1 && (c + 31) / 32 > 65535);
}

// Runs LAUNCH(V, ROWS) for the width v and the layout (rows where inner == 1).
#define BN_DISPATCH(T, v, inner, LAUNCH)      \
  do {                                         \
    constexpr int VV_ = 16 / sizeof(T);        \
    if ((inner) == 1) {                        \
      if ((v) == VV_) LAUNCH(VV_, true);       \
      else LAUNCH(1, true);                    \
    } else {                                   \
      if ((v) == VV_) LAUNCH(VV_, false);      \
      else LAUNCH(1, false);                   \
    }                                          \
  } while (0)

template <typename T>
cudaError_t stats(const void* x, void* part, void* st, long long outer, int c, long long inner,
                  int splits, float eps, cudaStream_t stream) {
  const int v = width<T>(c, inner, {x});
  const float n = (float)((double)outer * (double)inner);
  const Launch l = geometry(outer, c, inner, splits, v, n);
#define LAUNCH(V, ROWS)                                                                  \
  bn_sums_kernel<T, V, ROWS, STATS><<<l.grid, THREADS, 0, stream>>>(                     \
      static_cast<const T*>(x), nullptr, nullptr, nullptr, static_cast<float*>(part), l.s)
  BN_DISPATCH(T, v, inner, LAUNCH);
#undef LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_finish_kernel<STATS><<<(c + FINISH_COLS - 1) / FINISH_COLS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), splits, c, n, eps, nullptr, nullptr,
      static_cast<float*>(st));
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* x, const void* res, const void* st, const void* w, const void* b,
                  void* out, long long outer, int c, long long inner, int splits, bool relu_,
                  cudaStream_t stream) {
  const int v = width<T>(c, inner, {x, res, out});
  const Launch l = geometry(outer, c, inner, splits, v, 0.f);
#define LAUNCH(V, ROWS)                                                                    \
  bn_apply_kernel<T, V, ROWS><<<l.grid, THREADS, 0, stream>>>(                             \
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(st), \
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(out),    \
      relu_, l.s)
  BN_DISPATCH(T, v, inner, LAUNCH);
#undef LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_reduce(const void* g, const void* y, const void* x, const void* st,
                       const void* w, void* part, void* red, long long outer, int c,
                       long long inner, int splits, cudaStream_t stream) {
  const int v = width<T>(c, inner, {g, y, x});
  const float n = (float)((double)outer * (double)inner);
  const Launch l = geometry(outer, c, inner, splits, v, n);
#define LAUNCH(V, ROWS)                                                                \
  bn_sums_kernel<T, V, ROWS, BWD><<<l.grid, THREADS, 0, stream>>>(                     \
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(y),    \
      static_cast<const float*>(st), static_cast<float*>(part), l.s)
  BN_DISPATCH(T, v, inner, LAUNCH);
#undef LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_finish_kernel<BWD><<<(c + FINISH_COLS - 1) / FINISH_COLS, THREADS, 0, stream>>>(
      static_cast<const float*>(part), splits, c, n, 0.f, static_cast<const float*>(st),
      static_cast<const float*>(w), static_cast<float*>(red));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dx(const void* g, const void* y, const void* x, const void* st,
                   const void* red, void* dx, void* gres, long long outer, int c,
                   long long inner, int splits, cudaStream_t stream) {
  const int v = width<T>(c, inner, {g, y, x, dx, gres});
  const Launch l = geometry(outer, c, inner, splits, v, 0.f);
#define LAUNCH(V, ROWS)                                                                 \
  bn_bwd_dx_kernel<T, V, ROWS><<<l.grid, THREADS, 0, stream>>>(                         \
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(x),     \
      static_cast<const float*>(st), static_cast<const float*>(red), static_cast<T*>(dx), \
      static_cast<T*>(gres), l.s)
  BN_DISPATCH(T, v, inner, LAUNCH);
#undef LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Every entry: x (and g, y, res, dx, gres) viewed as (outer, c, inner) in
// the dtype is_bf16 names (else fp32), contiguous in that view; st, part,
// red, w, b fp32. `splits` blocks run along the reduced axis: part holds
// splits * 2 * c floats. A null y means no ReLU gate, a null res no residual,
// a null gres no g' written. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernels do not take).

// st = (mean, var, rstd), (3, c).
extern "C" int avec_bn_stats(const void* x, void* part, void* st, long long outer, int c,
                             long long inner, int splits, float eps, int is_bf16, void* stream) {
  if (bad_shape(outer, c, inner, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return stats<__nv_bfloat16>(x, part, st, outer, c, inner, splits, eps, s);
  return stats<float>(x, part, st, outer, c, inner, splits, eps, s);
}

// out = relu?(round(round((x - mean) rstd w + b) + res?)).
extern "C" int avec_bn_apply(const void* x, const void* res, const void* st, const void* w,
                             const void* b, void* out, long long outer, int c, long long inner,
                             int splits, int relu, int is_bf16, void* stream) {
  if (bad_shape(outer, c, inner, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return apply<__nv_bfloat16>(x, res, st, w, b, out, outer, c, inner, splits, relu != 0, s);
  return apply<float>(x, res, st, w, b, out, outer, c, inner, splits, relu != 0, s);
}

// red = (db, dw, w rstd, db / n, dw / n), (5, c).
extern "C" int avec_bn_bwd_reduce(const void* g, const void* y, const void* x, const void* st,
                                  const void* w, void* part, void* red, long long outer, int c,
                                  long long inner, int splits, int is_bf16, void* stream) {
  if (bad_shape(outer, c, inner, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_reduce<__nv_bfloat16>(g, y, x, st, w, part, red, outer, c, inner, splits, s);
  return bwd_reduce<float>(g, y, x, st, w, part, red, outer, c, inner, splits, s);
}

// dx, and g' into gres where it is not null.
extern "C" int avec_bn_bwd_dx(const void* g, const void* y, const void* x, const void* st,
                              const void* red, void* dx, void* gres, long long outer, int c,
                              long long inner, int splits, int is_bf16, void* stream) {
  if (bad_shape(outer, c, inner, splits)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_dx<__nv_bfloat16>(g, y, x, st, red, dx, gres, outer, c, inner, splits, s);
  return bwd_dx<float>(g, y, x, st, red, dx, gres, outer, c, inner, splits, s);
}
