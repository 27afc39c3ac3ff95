// Fused conformer attention module, forward and backward, for Hopper (sm_90a).
//
// Replaces: avec_tpu/ops/pallas_attention_module.py `_fwd_kernel` (:121,
// pallas_call at :316) and `_bwd_kernel` (:149, pallas_call at :345), reached
// through `fused_attention_module_3d` (:418) from AttentionModule in training
// mode.
//
// Computes, for x (B, T, d) and the module's fp32 parameters (LayerNorm w, b;
// Wq, Wk, Wv, Wo (d, d) in the Linear (out, in) layout with their biases; the
// positional Linear's weight P (d, d) and bias):
//     h = LN(x);  q, k, v = h W^T + b                 (each rounded to x's type)
//     per head:  U = q_h P_h^T                        (us / uc interleaved)
//                a1 = us sin + uc cos,  a2 = uc sin - us cos
//                s = (q_h k_h^T + a1 cos^T + a2 sin^T + q_h . b_pos) / sqrt(dh)
//                s += -1e9 on key columns at or past the length
//                o_h = softmax_fp32(s) v_h
//     y = dropout(concat(o_h) Wo^T + bo) [+ x]
// with the rounding points of the TPU kernel (every score term rounded to x's
// type, softmax in fp32, its result rounded before the product with v), and, in
// the backward, dx and the fp32 gradients of all twelve parameters, recomputing
// the forward from x: only x, the parameters, the lengths and the seed cross
// from forward to backward. Query rows past the length are computed and
// differentiated like any other, and a sequence of length 0 softmaxes
// uniformly, as the TPU kernel does. The dropout mask is the counter hash of
// pallas_conv_module.py:72-87 (one key per sequence), so forward, backward
// and the plain PyTorch version regenerate the same mask.
//
// What bounds it on the H100: operations. One forward at B=16, T=151, d=256,
// H=4 is about 2.7 GFLOP (the rel-pos score term, contracted over d, is the
// largest single product) on about 4 MB of inputs and outputs: 3 us at the
// bf16 tensor-core peak. This first version runs every product as fp32 FMAs on
// values rounded where the TPU kernel rounds them, for fp32 and bf16 inputs
// alike, and is bound by the fp32 rate and by its tile staging.
//
// Design. The TPU kernel keeps one whole sequence in VMEM; a Hopper block
// cannot (q, k, v alone pass 227 KB at T=151, d=256). Each direction is one C
// entry point that enqueues a chain of stages on the caller's stream; the
// stages hand q, k, v, the rotated rel-pos projections, the (B, H, T, T)
// softmax and the merged heads to each other through an fp32 scratch buffer
// that the wrapper allocates (about 50 MB in the backward at the shapes
// above, within the L2's reach), and nothing of it outlives the call. Heads
// are sliced, not lane-masked: head h reads rows h*dh.. of P, and the sin/cos
// tables arrive interleaved as (T, d) so that the rel-pos term is one product
// over d against P as it is stored, and dP comes out in P's own layout. Every
// product goes through one 64 x 64 register-tiled routine (`gemm_tile`) whose
// operands are fetched by small functors, so LayerNorm, rounding, head
// offsets and dropout fuse into the operand loads, and bias, rotation,
// masking, softmax and the residual into the epilogues. Scores and softmax
// share a block (it owns 64 full rows), as do dO V^T and the softmax backward.
// dq, dk, dv, dh and dx have one owner per element and are deterministic;
// the parameter gradients are summed across row splits with atomicAdd into
// fp32 buffers that the caller zeroed, so their last bits vary run to run.
// Forward: 6 stages; backward: 16 (5 of them the recomputed forward).

#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BT = GEMM_EDGE;       // output tile edge of `gemm_tile` (tile.cuh)
constexpr int BK = GEMM_BK;         // its reduction chunk
constexpr int THREADS = GEMM_THREADS;  // 16 x 16 threads, 4 x 4 register tile each
constexpr int SPLIT_ROWS = 256;  // token rows per block of a weight-gradient product
constexpr uint32_t SEED_STRIDE = 1103515245u;
constexpr uint32_t DRAW = 0x9E3779B9u;

struct Drop {
  uint32_t seed, thr;
  float inv_keep;
  int on;
};

struct Shape {
  int b, t, d, heads, dh, n;  // n = b * t token rows
};

struct Params {
  const float *ln_w, *ln_b, *wq, *bq, *wk, *bk, *wv, *bv, *pos_w, *pos_b, *wo, *bo;
};

struct Grads {
  float *ln_w, *ln_b, *wq, *bq, *wk, *bk, *wv, *bv, *pos_w, *pos_b, *wo, *bo;
};

struct Scratch {
  float *mean, *rstd, *q, *k, *v, *a12, *s, *merged;        // forward
  float *dacc, *ds, *rs, *du, *dq, *dk, *dv, *dh;            // backward only
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Multiplier (0 or 1/keep) of element (t, col) of sequence b's (T, d) output.
__device__ __forceinline__ float drop_mult(const Drop& dr, int b, int t, int col, int d) {
  if (!dr.on) return 1.f;
  const uint32_t base = dr.seed + (uint32_t)b * SEED_STRIDE;
  const uint32_t flat = (uint32_t)t * (uint32_t)d + (uint32_t)col;
  const uint32_t bits = mix32(flat ^ mix32(base + DRAW));
  return bits < dr.thr ? dr.inv_keep : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int t) {
  const int v = lengths[b];
  return v < 0 ? 0 : (v > t ? t : v);
}

// LayerNorm output h[row][col], rounded as the TPU kernel rounds it.
template <typename T>
__device__ __forceinline__ float ln_h(const T* __restrict__ x, const float* __restrict__ mean,
                                      const float* __restrict__ rstd,
                                      const float* __restrict__ ln_w,
                                      const float* __restrict__ ln_b, int row, int col, int d) {
  const float xhat = rnd<T>((to_f(x[(size_t)row * d + col]) - mean[row]) * rstd[row]);
  return rnd<T>(rnd<T>(xhat * rnd<T>(ln_w[col])) + rnd<T>(ln_b[col]));
}

// g * dropout mask, in fp32.
template <typename T>
__device__ __forceinline__ float masked_g(const T* __restrict__ g, const Drop& dr, int row,
                                          int col, int t, int d) {
  return to_f(g[(size_t)row * d + col]) * drop_mult(dr, row / t, row % t, col, d);
}

// ---- forward stages

// One warp per token row: mean and 1 / sqrt(var + eps) in fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ rstd,
                int n, int d, float eps) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;  // uniform over the warp
  const T* xr = x + (size_t)row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
  const float m = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f(xr[c]) - m;
    sq += dv * dv;
  }
  const float var = warp_sum(sq) / d;
  if (lane == 0) {
    mean[row] = m;
    rstd[row] = rsqrtf(var + eps);
  }
}

// q, k, v = round(h W^T) + b, rounded; blockIdx.z picks the projection.
template <typename T>
__global__ void __launch_bounds__(THREADS)
qkv_kernel(const T* __restrict__ x, Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, z = blockIdx.z;
  const float* w = z == 0 ? p.wq : (z == 1 ? p.wk : p.wv);
  const float* bias = z == 0 ? p.bq : (z == 1 ? p.bk : p.bv);
  float* out = z == 0 ? sc.q : (z == 1 ? sc.k : sc.v);
  const int n = sh.n, d = sh.d;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? ln_h<T>(x, sc.mean, sc.rstd, p.ln_w, p.ln_b, row, k, d) : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int col = col0 + j;
    return col < d ? rnd<T>(w[(size_t)col * d + k]) : 0.f;
  };
  gemm_tile<true, true>(acc, fa, fb, 0, d, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < d)
        out[(size_t)row * d + col] = rnd<T>(rnd<T>(acc[i][j]) + rnd<T>(bias[col]));
    }
}

// U = q_h P_h^T (columns 2m: us, 2m+1: uc), rotated by the query's angles:
// a12[.., 2m] = a2 = uc sin - us cos, a12[.., 2m+1] = a1 = us sin + uc cos.
// tab[t][2m] = sin, tab[t][2m+1] = cos.
template <typename T>
__global__ void __launch_bounds__(THREADS)
relpos_u_kernel(const T* __restrict__ tab, Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BT, bh = blockIdx.z;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const float* q = sc.q + (size_t)b * t * d + h * dh;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? q[(size_t)tt * d + k] : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int c = c0 + j;
    return c < d ? rnd<T>(p.pos_w[(size_t)(h * dh + k) * d + c]) : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, dh, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tt = t0 + ty * 4 + i;
    if (tt >= t) continue;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int c = c0 + tx * 4 + 2 * pr;
      if (c >= d) continue;  // d is even, so c + 1 < d
      const float us = rnd<T>(acc[i][2 * pr]), uc = rnd<T>(acc[i][2 * pr + 1]);
      const float sn = to_f(tab[(size_t)tt * d + c]), cs = to_f(tab[(size_t)tt * d + c + 1]);
      float* out = sc.a12 + ((size_t)bh * t + tt) * d + c;
      out[0] = rnd<T>(rnd<T>(uc * sn) - rnd<T>(us * cs));
      out[1] = rnd<T>(rnd<T>(us * sn) + rnd<T>(uc * cs));
    }
  }
}

// A block owns 64 query rows of one (sequence, head): scores for every key
// tile into sc.s, then the fp32 softmax of its rows in place.
template <typename T>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const T* __restrict__ tab, const int* __restrict__ lengths, Params p, Scratch sc,
              Shape sh, float scale) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  __shared__ float qb[BT];
  const int t0 = blockIdx.x * BT, bh = blockIdx.z, tid = threadIdx.x;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const int len = clamp_len(lengths, b, t);
  const float* q = sc.q + (size_t)b * t * d + h * dh;
  const float* kk = sc.k + (size_t)b * t * d + h * dh;
  const float* a12 = sc.a12 + (size_t)bh * t * d;
  float* srow = sc.s + (size_t)bh * t * t;
  const float neg = rnd<T>(-1e9f);
  if (tid < BT) {
    const int tt = t0 + tid;
    float a = 0.f;
    if (tt < t)
      for (int c = 0; c < dh; ++c) a = fmaf(q[(size_t)tt * d + c], rnd<T>(p.pos_b[h * dh + c]), a);
    qb[tid] = rnd<T>(a);
  }
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;
  auto fq = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? q[(size_t)tt * d + k] : 0.f;
  };
  auto fa12 = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? a12[(size_t)tt * d + k] : 0.f;
  };
  for (int u0 = 0; u0 < t; u0 += BT) {
    float ak[4][4] = {}, ae[4][4] = {};
    auto fk = [&](int k, int j) {
      const int u = u0 + j;
      return u < t ? kk[(size_t)u * d + k] : 0.f;
    };
    auto ftab = [&](int k, int j) {
      const int u = u0 + j;
      return u < t ? to_f(tab[(size_t)u * d + k]) : 0.f;
    };
    gemm_tile<true, true>(ak, fq, fk, 0, dh, sm);
    gemm_tile<true, true>(ae, fa12, ftab, 0, d, sm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tt = t0 + ty * 4 + i, u = u0 + tx * 4 + j;
        if (tt < t && u < t) {
          float v = rnd<T>(rnd<T>(rnd<T>(ak[i][j]) + rnd<T>(ae[i][j])) + qb[ty * 4 + i]);
          v = rnd<T>(v * scale);
          if (u >= len) v = rnd<T>(v + neg);
          srow[(size_t)tt * t + u] = v;
        }
      }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int tt = t0 + r;
    if (tt >= t) break;  // uniform over the warp
    float* row = srow + (size_t)tt * t;
    float m = -INFINITY;
    for (int u = lane; u < t; u += 32) m = fmaxf(m, row[u]);
    m = warp_max(m);
    float sum = 0.f;
    for (int u = lane; u < t; u += 32) {
      const float e = expf(row[u] - m);
      row[u] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int u = lane; u < t; u += 32) row[u] = row[u] / sum;
  }
}

// merged[b, t, h*dh + c] = round(sum_u round(att[t][u]) v_h[u][c]).
template <typename T>
__global__ void __launch_bounds__(THREADS)
att_v_kernel(Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BT, bh = blockIdx.z;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const float* att = sc.s + (size_t)bh * t * t;
  const float* v = sc.v + (size_t)b * t * d + h * dh;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? rnd<T>(att[(size_t)tt * t + k]) : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int c = c0 + j;
    return c < dh ? v[(size_t)k * d + c] : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, t, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = t0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (tt < t && c < dh)
        sc.merged[((size_t)b * t + tt) * d + h * dh + c] = rnd<T>(acc[i][j]);
    }
}

// y = round(round(round(merged Wo^T) + bo) * mask) [+ x].
template <typename T>
__global__ void __launch_bounds__(THREADS)
out_proj_kernel(const T* __restrict__ x, T* __restrict__ y, Params p, Scratch sc, Shape sh,
                int residual, Drop dr) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, n = sh.n, d = sh.d;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? sc.merged[(size_t)row * d + k] : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int col = col0 + j;
    return col < d ? rnd<T>(p.wo[(size_t)col * d + k]) : 0.f;
  };
  gemm_tile<true, true>(acc, fa, fb, 0, d, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < d) {
        float v = rnd<T>(rnd<T>(acc[i][j]) + rnd<T>(p.bo[col]));
        v = rnd<T>(v * drop_mult(dr, row / sh.t, row % sh.t, col, d));
        if (residual) v = rnd<T>(v + to_f(x[(size_t)row * d + col]));
        y[(size_t)row * d + col] = from_f<T>(v);
      }
    }
}

// ---- backward stages

// dacc = round(g * mask) Wo: the cotangent of the merged heads, fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_out_kernel(const T* __restrict__ g, Params p, Scratch sc, Shape sh, Drop dr) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, n = sh.n, d = sh.d, t = sh.t;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? rnd<T>(masked_g<T>(g, dr, row, k, t, d)) : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int col = col0 + j;
    return col < d ? rnd<T>(p.wo[(size_t)k * d + col]) : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, d, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < d) sc.dacc[(size_t)row * d + col] = acc[i][j];
    }
}

// Adds this thread's tile into a row-major (rows, ld) gradient.
__device__ __forceinline__ void add_tile(float* grad, const float (&acc)[4][4], int row0,
                                         int rows, int col0, int cols, int ld) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < rows && col < cols) atomicAdd(grad + (size_t)row * ld + col, acc[i][j]);
    }
}

// dWo[j][i] += sum_rows round(g * mask)[row][j] * merged[row][i]; blockIdx.z
// picks a split of SPLIT_ROWS token rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_wo_kernel(const T* __restrict__ g, Grads gr, Scratch sc, Shape sh, Drop dr) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int j0 = blockIdx.x * BT, i0 = blockIdx.y * BT, n = sh.n, d = sh.d, t = sh.t;
  const int r0 = blockIdx.z * SPLIT_ROWS, r1 = min(n, r0 + SPLIT_ROWS);
  float acc[4][4] = {};
  auto fa = [&](int i, int r) {
    const int j = j0 + i;
    return j < d ? rnd<T>(masked_g<T>(g, dr, r, j, t, d)) : 0.f;
  };
  auto fb = [&](int r, int jj) {
    const int c = i0 + jj;
    return c < d ? sc.merged[(size_t)r * d + c] : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, r0, r1, sm);
  add_tile(gr.wo, acc, j0, d, i0, d, d);
}

// A block owns 64 query rows of one (sequence, head): datt = dacc_h v_h^T for
// every key tile into sc.ds, then ds = att * (datt - rowsum(datt * att)) * scale
// in place and its row sums into sc.rs.
__global__ void __launch_bounds__(THREADS)
datt_ds_kernel(Scratch sc, Shape sh, float scale) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t0 = blockIdx.x * BT, bh = blockIdx.z, tid = threadIdx.x;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const float* dacc = sc.dacc + (size_t)b * t * d + h * dh;
  const float* v = sc.v + (size_t)b * t * d + h * dh;
  const float* att = sc.s + (size_t)bh * t * t;
  float* ds = sc.ds + (size_t)bh * t * t;
  const int ty = tid / 16, tx = tid % 16;
  auto fa = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? dacc[(size_t)tt * d + k] : 0.f;
  };
  for (int u0 = 0; u0 < t; u0 += BT) {
    float acc[4][4] = {};
    auto fb = [&](int k, int j) {
      const int u = u0 + j;
      return u < t ? v[(size_t)u * d + k] : 0.f;
    };
    gemm_tile<true, true>(acc, fa, fb, 0, dh, sm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tt = t0 + ty * 4 + i, u = u0 + tx * 4 + j;
        if (tt < t && u < t) ds[(size_t)tt * t + u] = acc[i][j];
      }
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BT; r += THREADS / 32) {
    const int tt = t0 + r;
    if (tt >= t) break;  // uniform over the warp
    float* drow = ds + (size_t)tt * t;
    const float* arow = att + (size_t)tt * t;
    float dot = 0.f;
    for (int u = lane; u < t; u += 32) dot += drow[u] * arow[u];
    dot = warp_sum(dot);
    float rsum = 0.f;
    for (int u = lane; u < t; u += 32) {
      const float val = arow[u] * (drow[u] - dot) * scale;
      drow[u] = val;
      rsum += val;
    }
    rsum = warp_sum(rsum);
    if (lane == 0) sc.rs[(size_t)bh * t + tt] = rsum;
  }
}

// dv_h = att^T dacc_h (blockIdx.z even) and dk_h = ds^T q_h (odd); each key
// tile has one owner.
__global__ void __launch_bounds__(THREADS)
grad_kv_kernel(Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int u0 = blockIdx.x * BT, c0 = blockIdx.y * BT, which = blockIdx.z & 1,
            bh = blockIdx.z >> 1;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const float* pm = (which ? sc.ds : sc.s) + (size_t)bh * t * t;
  const float* xm = (which ? sc.q : sc.dacc) + (size_t)b * t * d + h * dh;
  float* out = (which ? sc.dk : sc.dv) + (size_t)b * t * d + h * dh;
  float acc[4][4] = {};
  auto fa = [&](int i, int r) {
    const int u = u0 + i;
    return u < t ? pm[(size_t)r * t + u] : 0.f;
  };
  auto fb = [&](int r, int j) {
    const int c = c0 + j;
    return c < dh ? xm[(size_t)r * d + c] : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, 0, t, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (u < t && c < dh) out[(size_t)u * d + c] = acc[i][j];
    }
}

// dA = ds tab (columns 2m: da2, 2m+1: da1), rotated back by the query's
// angles: du[.., 2m] = dus = da1 sin - da2 cos, du[.., 2m+1] = duc = da1 cos +
// da2 sin.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_relpos_u_kernel(const T* __restrict__ tab, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BT, bh = blockIdx.z;
  const int t = sh.t, d = sh.d;
  const float* ds = sc.ds + (size_t)bh * t * t;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? ds[(size_t)tt * t + k] : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int c = c0 + j;
    return c < d ? to_f(tab[(size_t)k * d + c]) : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, t, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tt = t0 + ty * 4 + i;
    if (tt >= t) continue;
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int c = c0 + tx * 4 + 2 * pr;
      if (c >= d) continue;
      const float da2 = acc[i][2 * pr], da1 = acc[i][2 * pr + 1];
      const float sn = to_f(tab[(size_t)tt * d + c]), cs = to_f(tab[(size_t)tt * d + c + 1]);
      float* out = sc.du + ((size_t)bh * t + tt) * d + c;
      out[0] = da1 * sn - da2 * cs;
      out[1] = da1 * cs + da2 * sn;
    }
  }
}

// dq_h = ds k_h + du round(P_h) + rowsum(ds) round(b_pos_h), fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_q_kernel(Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BT, bh = blockIdx.z;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const float* ds = sc.ds + (size_t)bh * t * t;
  const float* du = sc.du + (size_t)bh * t * d;
  const float* kk = sc.k + (size_t)b * t * d + h * dh;
  float acc[4][4] = {};
  auto fds = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? ds[(size_t)tt * t + k] : 0.f;
  };
  auto fk = [&](int k, int j) {
    const int c = c0 + j;
    return c < dh ? kk[(size_t)k * d + c] : 0.f;
  };
  gemm_tile<true, false>(acc, fds, fk, 0, t, sm);
  auto fdu = [&](int i, int k) {
    const int tt = t0 + i;
    return tt < t ? du[(size_t)tt * d + k] : 0.f;
  };
  auto fp = [&](int k, int j) {
    const int c = c0 + j;
    return c < dh ? rnd<T>(p.pos_w[(size_t)(h * dh + c) * d + k]) : 0.f;
  };
  gemm_tile<true, true>(acc, fdu, fp, 0, d, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tt = t0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (tt < t && c < dh)
        sc.dq[((size_t)b * t + tt) * d + h * dh + c] =
            acc[i][j] + sc.rs[(size_t)bh * t + tt] * rnd<T>(p.pos_b[h * dh + c]);
    }
}

// dP[h*dh + c][m] += sum over token rows of q[row][h*dh + c] * du[b, h, t][m].
// blockIdx.x = head * tiles-per-head + tile, so a tile never spans two heads.
__global__ void __launch_bounds__(THREADS)
grad_pos_kernel(Grads gr, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int t = sh.t, d = sh.d, dh = sh.dh, n = sh.n, heads = sh.heads;
  const int tiles = (dh + BT - 1) / BT;
  const int h = blockIdx.x / tiles, c0 = (blockIdx.x % tiles) * BT, m0 = blockIdx.y * BT;
  const int r0 = blockIdx.z * SPLIT_ROWS, r1 = min(n, r0 + SPLIT_ROWS);
  float acc[4][4] = {};
  auto fa = [&](int i, int r) {
    const int c = c0 + i;
    return c < dh ? sc.q[(size_t)r * d + h * dh + c] : 0.f;
  };
  auto fb = [&](int r, int j) {
    const int m = m0 + j;
    return m < d ? sc.du[((size_t)((r / t) * heads + h) * t + r % t) * d + m] : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, r0, r1, sm);
  add_tile(gr.pos_w + (size_t)h * dh * d, acc, c0, dh, m0, d, d);
}

// dW[j][i] += sum_rows round(dz[row][j]) * h[row][i] for z = q, k, v;
// blockIdx.z = 3 * split + z.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_w_qkv_kernel(const T* __restrict__ x, Params p, Grads gr, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int j0 = blockIdx.x * BT, i0 = blockIdx.y * BT, z = blockIdx.z % 3, n = sh.n, d = sh.d;
  const int r0 = (blockIdx.z / 3) * SPLIT_ROWS, r1 = min(n, r0 + SPLIT_ROWS);
  const float* dz = z == 0 ? sc.dq : (z == 1 ? sc.dk : sc.dv);
  float* dw = z == 0 ? gr.wq : (z == 1 ? gr.wk : gr.wv);
  float acc[4][4] = {};
  auto fa = [&](int i, int r) {
    const int j = j0 + i;
    return j < d ? rnd<T>(dz[(size_t)r * d + j]) : 0.f;
  };
  auto fb = [&](int r, int jj) {
    const int c = i0 + jj;
    return c < d ? ln_h<T>(x, sc.mean, sc.rstd, p.ln_w, p.ln_b, r, c, d) : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, r0, r1, sm);
  add_tile(dw, acc, j0, d, i0, d, d);
}

// dh = round(dq) round(Wq) + round(dk) round(Wk) + round(dv) round(Wv), fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grad_h_kernel(Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, n = sh.n, d = sh.d;
  float acc[4][4] = {};
  for (int z = 0; z < 3; ++z) {
    const float* dz = z == 0 ? sc.dq : (z == 1 ? sc.dk : sc.dv);
    const float* w = z == 0 ? p.wq : (z == 1 ? p.wk : p.wv);
    auto fa = [&](int i, int k) {
      const int row = row0 + i;
      return row < n ? rnd<T>(dz[(size_t)row * d + k]) : 0.f;
    };
    auto fb = [&](int k, int j) {
      const int col = col0 + j;
      return col < d ? rnd<T>(w[(size_t)k * d + col]) : 0.f;
    };
    gemm_tile<true, false>(acc, fa, fb, 0, d, sm);
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < d) sc.dh[(size_t)row * d + col] = acc[i][j];
    }
}

// LayerNorm backward, one warp per token row (pallas_attention_module.py
// :266-271); the residual's cotangent g is added unmasked.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, Params p,
              Scratch sc, Shape sh, int residual) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = sh.d;
  if (row >= sh.n) return;  // uniform over the warp
  const float mean = sc.mean[row], rstd = sc.rstd[row];
  const T* xr = x + (size_t)row * d;
  const float* dhr = sc.dh + (size_t)row * d;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dxh = dhr[c] * p.ln_w[c];
    const float xhat = (to_f(xr[c]) - mean) * rstd;
    s1 += dxh;
    s2 += dxh * xhat;
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
  for (int c = lane; c < d; c += 32) {
    const float dxh = dhr[c] * p.ln_w[c];
    const float xhat = (to_f(xr[c]) - mean) * rstd;
    float v = rstd * (dxh - m1 - xhat * m2);
    if (residual) v += to_f(g[(size_t)row * d + c]);
    dx[(size_t)row * d + c] = from_f<T>(v);
  }
}

// Every gradient that is a sum over token rows of one column: dbo (g * mask),
// dbq, dbk, dbv, dLN bias (dh), dLN weight (dh * xhat) and the positional
// bias (q * rowsum(ds) of the column's head). 64 columns x 4 row lanes per
// block over 64 token rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
col_sums_kernel(const T* __restrict__ x, const T* __restrict__ g, Grads gr, Scratch sc, Shape sh,
                Drop dr) {
  constexpr int NS = 7;
  __shared__ float red[NS][4][64];
  const int cl = threadIdx.x % 64, rl = threadIdx.x / 64;
  const int col = blockIdx.x * 64 + cl, n = sh.n, d = sh.d, t = sh.t;
  float s[NS] = {};
  if (col < d) {
    const int h = col / sh.dh;
    for (int r = blockIdx.y * 64 + rl; r < min(n, (int)(blockIdx.y + 1) * 64); r += 4) {
      const size_t at = (size_t)r * d + col;
      const float dhv = sc.dh[at];
      const float xhat = (to_f(x[at]) - sc.mean[r]) * sc.rstd[r];
      s[0] += masked_g<T>(g, dr, r, col, t, d);
      s[1] += sc.dq[at];
      s[2] += sc.dk[at];
      s[3] += sc.dv[at];
      s[4] += dhv;
      s[5] += dhv * xhat;
      s[6] += sc.q[at] * sc.rs[((size_t)(r / t) * sh.heads + h) * t + r % t];
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) red[k][rl][cl] = s[k];
  __syncthreads();
  if (rl == 0 && col < d) {
    float* outs[NS] = {gr.bo, gr.bq, gr.bk, gr.bv, gr.ln_b, gr.ln_w, gr.pos_b};
#pragma unroll
    for (int k = 0; k < NS; ++k)
      atomicAdd(outs[k] + col, red[k][0][cl] + red[k][1][cl] + red[k][2][cl] + red[k][3][cl]);
  }
}

// ---- host side

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

long long scratch_floats(const Shape& sh, bool backward) {
  const long long nd = (long long)sh.n * sh.d, ntt = (long long)sh.b * sh.heads * sh.t * sh.t;
  long long total = 2LL * sh.n + 4 * nd + nd * sh.heads + ntt;
  if (backward) total += 5 * nd + ntt + (long long)sh.b * sh.heads * sh.t + nd * sh.heads;
  return total;
}

Scratch carve(float* base, const Shape& sh, bool backward) {
  const size_t nd = (size_t)sh.n * sh.d, ntt = (size_t)sh.b * sh.heads * sh.t * sh.t;
  Scratch sc{};
  float* p = base;
  auto take = [&](size_t count) {
    float* at = p;
    p += count;
    return at;
  };
  sc.mean = take(sh.n);
  sc.rstd = take(sh.n);
  sc.q = take(nd);
  sc.k = take(nd);
  sc.v = take(nd);
  sc.merged = take(nd);
  sc.a12 = take(nd * sh.heads);
  sc.s = take(ntt);
  if (backward) {
    sc.dacc = take(nd);
    sc.dq = take(nd);
    sc.dk = take(nd);
    sc.dv = take(nd);
    sc.dh = take(nd);
    sc.ds = take(ntt);
    sc.rs = take((size_t)sh.b * sh.heads * sh.t);
    sc.du = take(nd * sh.heads);
  }
  return sc;
}

#define AVEC_LAUNCH(kernel, grid, ...)                         \
  do {                                                         \
    kernel<<<grid, THREADS, 0, st>>>(__VA_ARGS__);             \
    const cudaError_t rc_ = cudaGetLastError();                \
    if (rc_ != cudaSuccess) return rc_;                        \
  } while (0)

// Stages shared by both directions: statistics, q/k/v, rel-pos projections,
// scores + softmax, att v.
template <typename T>
cudaError_t run_core(const T* x, const T* tab, const int* lengths, const Params& p,
                     const Scratch& sc, const Shape& sh, float eps, float scale,
                     cudaStream_t st) {
  const int bh = sh.b * sh.heads, tq = cdiv(sh.t, BT);
  AVEC_LAUNCH(ln_stats_kernel<T>, dim3(cdiv(sh.n, THREADS / 32)), x, sc.mean, sc.rstd, sh.n,
              sh.d, eps);
  AVEC_LAUNCH(qkv_kernel<T>, dim3(cdiv(sh.n, BT), cdiv(sh.d, BT), 3), x, p, sc, sh);
  AVEC_LAUNCH(relpos_u_kernel<T>, dim3(tq, cdiv(sh.d, BT), bh), tab, p, sc, sh);
  AVEC_LAUNCH(scores_kernel<T>, dim3(tq, 1, bh), tab, lengths, p, sc, sh, scale);
  AVEC_LAUNCH(att_v_kernel<T>, dim3(tq, cdiv(sh.dh, BT), bh), sc, sh);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_fwd(const void* x, const void* tab, const int* lengths, const Params& p, void* y,
                    float* scratch, const Shape& sh, float eps, float scale, int residual,
                    Drop dr, cudaStream_t st) {
  const Scratch sc = carve(scratch, sh, false);
  const T* xt = static_cast<const T*>(x);
  const cudaError_t rc =
      run_core<T>(xt, static_cast<const T*>(tab), lengths, p, sc, sh, eps, scale, st);
  if (rc != cudaSuccess) return rc;
  AVEC_LAUNCH(out_proj_kernel<T>, dim3(cdiv(sh.n, BT), cdiv(sh.d, BT)), xt, static_cast<T*>(y), p,
              sc, sh, residual, dr);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_bwd(const void* x, const void* g, const void* tab, const int* lengths,
                    const Params& p, void* dx, const Grads& gr, float* scratch, const Shape& sh,
                    float eps, float scale, int residual, Drop dr, cudaStream_t st) {
  const Scratch sc = carve(scratch, sh, true);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* tt = static_cast<const T*>(tab);
  const cudaError_t rc = run_core<T>(xt, tt, lengths, p, sc, sh, eps, scale, st);
  if (rc != cudaSuccess) return rc;
  const int bh = sh.b * sh.heads, tq = cdiv(sh.t, BT), splits = cdiv(sh.n, SPLIT_ROWS);
  const int nt = cdiv(sh.n, BT), dt = cdiv(sh.d, BT), ht = cdiv(sh.dh, BT);
  AVEC_LAUNCH(grad_out_kernel<T>, dim3(nt, dt), gt, p, sc, sh, dr);
  AVEC_LAUNCH(grad_wo_kernel<T>, dim3(dt, dt, splits), gt, gr, sc, sh, dr);
  AVEC_LAUNCH(datt_ds_kernel, dim3(tq, 1, bh), sc, sh, scale);
  AVEC_LAUNCH(grad_kv_kernel, dim3(tq, ht, bh * 2), sc, sh);
  AVEC_LAUNCH(grad_relpos_u_kernel<T>, dim3(tq, dt, bh), tt, sc, sh);
  AVEC_LAUNCH(grad_q_kernel<T>, dim3(tq, ht, bh), p, sc, sh);
  AVEC_LAUNCH(grad_pos_kernel, dim3(sh.heads * ht, dt, splits), gr, sc, sh);
  AVEC_LAUNCH(grad_w_qkv_kernel<T>, dim3(dt, dt, 3 * splits), xt, p, gr, sc, sh);
  AVEC_LAUNCH(grad_h_kernel<T>, dim3(nt, dt), p, sc, sh);
  AVEC_LAUNCH(ln_bwd_kernel<T>, dim3(cdiv(sh.n, THREADS / 32)), xt, gt, static_cast<T*>(dx), p,
              sc, sh, residual);
  AVEC_LAUNCH(col_sums_kernel<T>, dim3(dt, nt), xt, gt, gr, sc, sh, dr);
  return cudaSuccess;
}

bool make_shape(Shape& sh, int b, int t, int d, int heads) {
  if (b <= 0 || t <= 0 || d <= 0 || heads <= 0 || d % heads != 0 || d % 2 != 0) return false;
  if ((long long)b * heads * 2 > 65535 || (long long)b * t > 4000000 ||
      (long long)b * t > 2000000000LL / d / heads)
    return false;
  sh = Shape{b, t, d, heads, d / heads, b * t};
  return true;
}

}  // namespace

// Number of fp32 scratch elements one call needs (0 for shapes the kernels do
// not take).
extern "C" long long avec_att_scratch_floats(int b, int t, int d, int heads, int backward) {
  Shape sh;
  if (!make_shape(sh, b, t, d, heads)) return 0;
  return scratch_floats(sh, backward != 0);
}

// x, y: (b, t, d) of one dtype (fp32 or bf16); tab: (t, d) of that dtype with
// sin at even and cos at odd columns; lengths: (b,) int32; params: the twelve
// fp32 parameters in the order of `Params`, weights (out, in). Dropout is on
// when use_drop != 0: keep iff hash bits < thr, multiplier inv_keep; scale is
// 1 / sqrt(d / heads). Returns
// the first failing launch's cudaError_t.
extern "C" int avec_att_fwd(const void* x, const void* tab, const void* lengths,
                            const void* const* params, void* y, void* scratch, int b, int t,
                            int d, int heads, float eps, float scale, int residual, int use_drop,
                            unsigned seed, unsigned thr, float inv_keep, int is_bf16,
                            void* stream) {
  Shape sh;
  if (!make_shape(sh, b, t, d, heads)) return cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(params[i]); };
  const Params p{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16) return run_fwd<bf16>(x, tab, len, p, y, sc, sh, eps, scale, residual, dr, st);
  return run_fwd<float>(x, tab, len, p, y, sc, sh, eps, scale, residual, dr, st);
}

// g, dx: (b, t, d) in x's dtype; grads: twelve fp32 buffers in the order of
// `Params` that the caller zeroed on the same stream (the kernels add into
// them).
extern "C" int avec_att_bwd(const void* x, const void* g, const void* tab, const void* lengths,
                            const void* const* params, void* dx, void* const* grads,
                            void* scratch, int b, int t, int d, int heads, float eps,
                            float scale, int residual, int use_drop, unsigned seed, unsigned thr,
                            float inv_keep, int is_bf16, void* stream) {
  Shape sh;
  if (!make_shape(sh, b, t, d, heads)) return cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(params[i]); };
  auto m = [&](int i) { return static_cast<float*>(grads[i]); };
  const Params p{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11)};
  const Grads gr{m(0), m(1), m(2), m(3), m(4), m(5), m(6), m(7), m(8), m(9), m(10), m(11)};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16)
    return run_bwd<bf16>(x, g, tab, len, p, dx, gr, sc, sh, eps, scale, residual, dr, st);
  return run_bwd<float>(x, g, tab, len, p, dx, gr, sc, sh, eps, scale, residual, dr, st);
}
