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
// bf16 tensor-core peak; the backward (`att_cost` in chip_smoke.py) is about
// 7 GFLOP, 7 us at the peak.
//
// The TPU kernel keeps one whole sequence in VMEM; a Hopper block cannot (q,
// k, v alone pass 227 KB at T=151, d=256). Each direction is one C entry
// point that enqueues a chain of stages on the caller's stream, handing
// values to each other through scratch that the wrapper allocates; nothing
// of it outlives the call. Heads are sliced, not lane-masked: head h reads
// rows h*dh.. of P, and the sin/cos tables arrive interleaved as (T, d) so
// that the rel-pos term is one product over d against P as it is stored, and
// dP comes out in P's own layout.
//
// fp32 inputs (the verification path) run the first version: every product
// through one 64 x 64 fp32-FMA tile routine (`gemm_tile`, tile.cuh) whose
// operands are fetched by small functors, so LayerNorm, rounding, head
// offsets and dropout fuse into the operand loads; the stages hand q, k, v,
// the (B, H, T, T) softmax and its gradient to each other in fp32 scratch,
// and the parameter gradients are summed across row splits with atomicAdd
// into buffers the entry point zeroes, so their last bits vary run to run
// there. Forward: 6 stages; backward: 16 (5 of them the recomputed forward).
// bf16 inputs longer than 736 frames, whose (64, T) fp32 score tile does not
// fit in shared memory, or with heads wider than 128, take the same stages
// (the AV step's T is at most 151, its heads 45 to 90 wide).
//
// bf16 inputs (the training path) were redesigned for the tensor cores
// against what held that version back (no tensor cores, 6.8 TFLOP/s; 50 MB
// of fp32 scratch between 16 stages; atomics for the weight gradients). A
// first stage casts the five weights and the angle table to bf16 once per
// call and computes LayerNorm; the q/k/v projections and the forward's
// attention stage and output projection run as TMA-fed `wgmma` (hopper.cuh)
// on 64-row warpgroup tiles, with fp32 accumulation and the TPU kernel's
// rounding points read in the accumulator's fragment layout: one stage per
// (sequence, head, 64 query rows) computes the rel-pos projection of its
// queries into shared memory, the scores from two products rounded apart,
// the fp32 softmax in registers and att v from the rounded softmax as a
// register operand (the bf16 forward section below). The backward's
// remaining stages run on mma.sync with fp32 accumulation from bf16
// operands staged in 16-byte pieces (tile.cuh `mma_tile`): every value the
// TPU kernel rounds to x's type lives in bf16 scratch laid out so that rows
// start 16-byte aligned, while the values its backward multiplies unrounded
// (dO, the softmax, ds, du) stay fp32 and enter their products as three
// bf16 parts that sum to them exactly (tile.cuh `mma_tile_f32`), so those
// products are fp32's; scores, softmax, att v, dO V^T, the softmax
// backward, the rel-pos backward and dq share one stage per (sequence,
// head, 64 query rows), holding the (64, t) fp32 score tile in shared
// memory; and every parameter gradient has one owner per element (row
// splits summed in a fixed order). No atomics in either direction: the same
// bits on every run. Forward: 4 stages (past 256 frames 5: the rel-pos and
// attention stages of the backward, in their forward form); backward: 9.
//
// What bounds the bf16 forward: latency, not operations. At (16, 151, 256,
// 4) its 2.7 GFLOP take under 3 us at the tensor-core peak; the call takes
// about 54 us of device time on the H100 (`chip_smoke.py`), of which the
// attention stage 32 (per block a chain of 10 dependent groups of TMA tiles
// and products, and the epilogues' bf16 conversions and the softmax, whose
// exact `expf` and division take about 10) and the q/k/v projections 10
// (their per-head stores, one column pair each).

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BT = GEMM_EDGE;       // output tile edge of `gemm_tile` (tile.cuh)
constexpr int BK = GEMM_BK;         // its reduction chunk
constexpr int THREADS = GEMM_THREADS;  // 16 x 16 threads, 4 x 4 register tile each
constexpr int SPLIT_ROWS = 256;  // token rows per block of a weight-gradient product
constexpr uint32_t SEED_STRIDE = 1103515245u;
constexpr uint32_t DRAW = 0x9E3779B9u;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// ---- bf16 stages
//
// A first stage casts the five weights and the angle table to bf16 once per
// call, and the stages hand bf16 values to each other in layouts whose rows
// start at multiples of 8 elements: (n, d) activations with rows padded to
// ldd, q, k, v and the merged heads' cotangent per head (b, H, t, ldh), the
// softmax and ds as (b, H, t, ldt). Values the TPU kernel rounds to x's type
// are held in bf16. The backward's mma.sync stages keep the values its
// backward keeps in fp32 (dO = g Wo, the softmax where it is not rounded, ds
// and the rel-pos cotangent du) in fp32, in the scratch and in shared
// memory, and every product that takes one of them takes it at fp32
// precision (`mma_tile_f32`, `mma_tile_saf<3>`); dq, dk and dv are fp32 and
// rounded where the TPU kernel rounds them. One stage per (sequence, head,
// 64 query rows) computes the scores, the fp32 softmax and att v, and in the
// backward dO V^T, the softmax backward, the rel-pos backward and dq,
// holding its (64, t) fp32 score tile in shared memory. Every parameter
// gradient has one owner per element and every sum a fixed order.

constexpr int QT = 64;          // query rows per block of the attention stage
constexpr int LDU = BT + 8;     // row stride (floats) of the attention stage's du tile
constexpr int MAX_SMEM = 232448;  // dynamic shared memory of one block (227 KB)
constexpr int NSUMS = 7;        // column sums of the backward (see ln_bwd16_kernel)
constexpr int SUM_ROWS = 16;    // token rows per block of ln_bwd16_kernel
constexpr int NW = 5;           // weights in bf16 scratch and split partials, in this order:
constexpr int W_Q = 0, W_K = 1, W_V = 2, W_P = 3, W_O = 4;

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

struct Scratch16 {
  int ldd, ldh, ldt;            // d, d / H and t rounded up to a multiple of 8
  float *mean, *rstd;           // (n,)
  bf16 *w, *tab;                // (5, d, ldd) weights (out, in); (t, ldd) angle table
  bf16 *h, *merged;             // (n, ldd)
  bf16 *q, *k, *v;              // (b, H, t, ldh)
  bf16* a12;                    // (b, H, t, ldd)
  bf16* gm;                     // (n, ldd) round(g * mask)
  float* dacc;                  // (b, H, t, ldh) dO = round(g * mask) Wo, per head
  float *att, *ds, *du;         // (b, H, t, ldt) x 2; (b, H, t, ldd)
  float* rs;                    // (b, H, t) row sums of ds
  float *dq, *dk, *dv;          // (n, ldd)
  float *dh, *part, *part_w;    // (n, d); (n / 16, 7, d); (splits, 5, d, d)
  int splits;                   // row splits of the weight gradients
};

// Shared-memory layout of `att16_kernel`, in bytes: the fp32 (64, t) tile S
// (scores, the softmax, then dO V^T and ds; rows 8 mod 32 floats apart), in
// the backward the fp32 (64, 64) tile U of du, the staging buffer and two
// (64,) vectors.
struct AttSmem {
  int lds;  // row stride (floats) of S: t rounded up to MMA_BK, + 8
  size_t off_u, off_stage, off_small, total;
};

__host__ __device__ inline AttSmem att_smem(int t, bool bwd) {
  AttSmem L;
  L.lds = (t + MMA_BK - 1) / MMA_BK * MMA_BK + 8;
  size_t at = (size_t)QT * L.lds * 4;
  L.off_u = at;
  if (bwd) at += (size_t)QT * LDU * 4;
  L.off_stage = at;
  at += (size_t)(bwd ? MMA_STAGE_F32 : MMA_STAGE) * 2;
  L.off_small = at;
  at += 2 * QT * 4;  // q . b_pos and the rows' sums of ds
  L.total = at;
  return L;
}

// The accumulator elements of this thread in `mma_tile` order.
#define AVEC_FOR_ACC(nt, e) \
  _Pragma("unroll") for (int nt = 0; nt < 4; ++nt) _Pragma("unroll") for (int e = 0; e < 4; ++e)

__host__ __device__ __forceinline__ const bf16* weight16(const Scratch16& sc, int which, int row,
                                                        int d) {
  return sc.w + ((size_t)which * d + row) * sc.ldd;
}

// Row (b, h, t) of a per-head (b, H, t, ld) array, for token row r = b t + t'.
__device__ __forceinline__ size_t head_row(int r, int h, const Shape& sh) {
  return ((size_t)(r / sh.t) * sh.heads + h) * sh.t + r % sh.t;
}

constexpr int CAST_ROWS = 4;  // rows per block of prep16_kernel's casts

__host__ __device__ inline int cast_blocks(const Shape& sh) {
  return cdiv(NW * sh.d + sh.t, CAST_ROWS);
}

// The bf16 path's first stage. The first cast_blocks blocks: CAST_ROWS rows
// each of the five weights (Wq, Wk, Wv, P, Wo, one after the other) to bf16,
// then of the angle table; the rest: LayerNorm of 8 token rows, one warp per
// row: mean and 1 / sqrt(var + eps) in fp32, h rounded as the TPU kernel
// rounds it, and in the backward round(g * mask).
__global__ void __launch_bounds__(THREADS)
prep16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, const bf16* __restrict__ tab,
              Params p, Scratch16 sc, Shape sh, float eps, Drop dr) {
  const int d = sh.d, casts = cast_blocks(sh);
  if ((int)blockIdx.x < casts) {
    const float* ws[NW] = {p.wq, p.wk, p.wv, p.pos_w, p.wo};
    const int row0 = blockIdx.x * CAST_ROWS, rows = min(CAST_ROWS, NW * d + sh.t - row0);
    for (int r = 0; r < rows; ++r) {  // uniform over the block
      const int row = row0 + r;
      if (row < NW * d) {
        const float* src = ws[row / d] + (size_t)(row % d) * d;
        bf16* dst = sc.w + (size_t)row * sc.ldd;
        for (int c = threadIdx.x; c < d; c += THREADS) dst[c] = from_f<bf16>(src[c]);
      } else {
        const bf16* src = tab + (size_t)(row - NW * d) * d;
        bf16* dst = sc.tab + (size_t)(row - NW * d) * sc.ldd;
        for (int c = threadIdx.x; c < d; c += THREADS) dst[c] = src[c];
      }
    }
    return;
  }
  const int row = (blockIdx.x - casts) * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= sh.n) return;  // uniform over the warp
  const bf16* xr = x + (size_t)row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
  const float m = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f(xr[c]) - m;
    sq += dv * dv;
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
  if (lane == 0) {
    sc.mean[row] = m;
    sc.rstd[row] = rstd;
  }
  for (int c = lane; c < d; c += 32) {
    const float xhat = rnd<bf16>((to_f(xr[c]) - m) * rstd);
    sc.h[(size_t)row * sc.ldd + c] =
        from_f<bf16>(rnd<bf16>(xhat * rnd<bf16>(p.ln_w[c])) + rnd<bf16>(p.ln_b[c]));
    if (g != nullptr)
      sc.gm[(size_t)row * sc.ldd + c] = from_f<bf16>(masked_g<bf16>(g, dr, row, c, sh.t, d));
  }
}

// Backward: dacc = round(g * mask) Wo, the merged heads' cotangent, per head,
// in fp32 as the TPU kernel keeps it.
__global__ void __launch_bounds__(THREADS)
dacc16_kernel(Scratch16 sc, Shape sh) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, n = sh.n, d = sh.d;
  float acc[4][4] = {};
  auto a = rows_of<bf16>([&](int r) {
    const int row = row0 + r;
    return row < n ? sc.gm + (size_t)row * sc.ldd : nullptr;
  });
  auto b = cols_of<bf16>([&](int k) { return weight16(sc, W_O, k, d) + col0; }, d - col0);
  mma_tile(acc, a, b, 0, d, sm);
  AVEC_FOR_ACC(nt, e) {
    int i, j;
    mma_tile_at(nt, e, i, j);
    const int row = row0 + i, col = col0 + j;
    if (row < n && col < d)
      sc.dacc[head_row(row, col / sh.dh, sh) * sc.ldh + col % sh.dh] = acc[nt][e];
  }
}

// a12 = the rotated rel-pos projections of q (see relpos_u_kernel).
__global__ void __launch_bounds__(THREADS)
relpos16_kernel(Scratch16 sc, Shape sh) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE];
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BT, bh = blockIdx.z;
  const int h = bh % sh.heads, t = sh.t, d = sh.d, dh = sh.dh;
  const bf16* q = sc.q + (size_t)bh * t * sc.ldh;
  float acc[4][4] = {};
  auto a = rows_of<bf16>([&](int r) {
    const int tt = t0 + r;
    return tt < t ? q + (size_t)tt * sc.ldh : nullptr;
  });
  auto b = cols_of<bf16>([&](int k) { return weight16(sc, W_P, h * dh + k, d) + c0; }, d - c0);
  mma_tile(acc, a, b, 0, dh, sm);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      int i, j;
      mma_tile_at(nt, e, i, j);  // j even: (us, uc) sit in e, e + 1
      const int tt = t0 + i, c = c0 + j;
      if (tt >= t || c >= d) continue;  // d is even, so c + 1 < d
      const float us = rnd<bf16>(acc[nt][e]), uc = rnd<bf16>(acc[nt][e + 1]);
      const bf16* tr = sc.tab + (size_t)tt * sc.ldd + c;
      const float sn = to_f(tr[0]), cs = to_f(tr[1]);
      bf16* out = sc.a12 + ((size_t)bh * t + tt) * sc.ldd + c;
      out[0] = from_f<bf16>(rnd<bf16>(uc * sn) - rnd<bf16>(us * cs));
      out[1] = from_f<bf16>(rnd<bf16>(us * sn) + rnd<bf16>(uc * cs));
    }
}

// The columns c0 .. c0 + 63 of an (n, ld) array as the source of a product
// over the token rows.
template <typename T>
__device__ __forceinline__ auto token_cols(const T* base, int ld, int c0, int d) {
  return cols_of<T>([=](int r) { return base + (size_t)r * ld + c0; }, d - c0);
}

// Rows r0 .. r0 + 63 of an array with row stride ld, zero from row lim on.
template <typename T>
__device__ __forceinline__ auto tile_rows(const T* base, int ld, int r0, int lim) {
  return rows_of<T>([=](int r) {
    const int rr = r0 + r;
    return rr < lim ? base + (size_t)rr * ld : nullptr;
  });
}

// One (sequence, head, 64 query rows) per block. Forward: scores, the fp32
// softmax and merged = round(round(att) v). Backward, in addition: the
// softmax to the scratch (for dv), dO V^T, ds = att (dO V^T - rowsum) /
// sqrt(dh) and its row sums, du = the rotated ds . tab, 64 columns at a
// time, and dq = ds k + du round(P_h) + rowsum(ds) round(b_pos_h); ds and du
// to the scratch too. The products that take dO, ds and du take them at
// fp32 precision (tile.cuh, three bf16 parts), as the TPU kernel does.
template <bool BWD>
__global__ void __launch_bounds__(THREADS)
att16_kernel(const int* __restrict__ lengths, Params p, Scratch16 sc, Shape sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = sh.t, d = sh.d, dh = sh.dh;
  const AttSmem L = att_smem(t, BWD);
  float* S = reinterpret_cast<float*>(smem_raw);  // [QT][lds] scores, softmax, dO V^T, ds
  float* U = reinterpret_cast<float*>(smem_raw + L.off_u);        // [QT][LDU] du columns
  bf16* stage = reinterpret_cast<bf16*>(smem_raw + L.off_stage);
  float* qb = reinterpret_cast<float*>(smem_raw + L.off_small);  // [QT]
  float* rsum = qb + QT;                                          // [QT]
  const int t0 = blockIdx.x * QT, bh = blockIdx.z, tid = threadIdx.x;
  const int b = bh / sh.heads, h = bh % sh.heads, ldh = sc.ldh, ldd = sc.ldd, lds = L.lds;
  const int len = clamp_len(lengths, b, t);
  const bf16* q = sc.q + (size_t)bh * t * ldh;
  const bf16* kk = sc.k + (size_t)bh * t * ldh;
  const bf16* v = sc.v + (size_t)bh * t * ldh;
  const bf16* a12 = sc.a12 + (size_t)bh * t * ldd;
  const float neg = rnd<bf16>(-1e9f);
  const int warp = tid / 32, lane = tid % 32;
  const int kpad = lds - 8;  // t rounded up to MMA_BK

  if (tid < QT) {
    const int tt = t0 + tid;
    float a = 0.f;
    if (tt < t)
      for (int c = 0; c < dh; ++c)
        a = fmaf(to_f(q[(size_t)tt * ldh + c]), rnd<bf16>(p.pos_b[h * dh + c]), a);
    qb[tid] = rnd<bf16>(a);
  }
  __syncthreads();

  // scores
  for (int u0 = 0; u0 < t; u0 += BT) {
    float ak[4][4] = {}, ae[4][4] = {};
    mma_tile(ak, tile_rows(q, ldh, t0, t), tile_rows(kk, ldh, u0, t), 0, dh, stage);
    mma_tile(ae, tile_rows(a12, ldd, t0, t), tile_rows(sc.tab, ldd, u0, t), 0, d, stage);
    AVEC_FOR_ACC(nt, e) {
      int i, j;
      mma_tile_at(nt, e, i, j);
      const int u = u0 + j;
      if (u < t) {
        float s = rnd<bf16>(rnd<bf16>(rnd<bf16>(ak[nt][e]) + rnd<bf16>(ae[nt][e])) + qb[i]);
        s = rnd<bf16>(s * scale);
        if (u >= len) s = rnd<bf16>(s + neg);
        S[i * lds + u] = s;
      }
    }
  }
  __syncthreads();

  // fp32 softmax in place, zero from t to kpad; in the backward also to the
  // scratch
  for (int r = warp; r < QT; r += THREADS / 32) {
    float* row = S + r * lds;
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
    const int tt = t0 + r;
    float* att_out = BWD && tt < t ? sc.att + ((size_t)bh * t + tt) * sc.ldt : nullptr;
    for (int u = lane; u < kpad; u += 32) {
      float a = 0.f;
      if (u < t) {
        a = row[u] / sum;
        if (att_out != nullptr) att_out[u] = a;
      }
      row[u] = a;
    }
  }
  __syncthreads();

  // merged = round(round(att) v_h)
  for (int c0 = 0; c0 < dh; c0 += BT) {
    float acc[4][4] = {};
    auto bv = cols_of<bf16>([&](int u) { return v + (size_t)u * ldh + c0; }, dh - c0);
    mma_tile_saf<1>(acc, S, lds, bv, 0, t, stage);
    AVEC_FOR_ACC(nt, e) {
      int i, j;
      mma_tile_at(nt, e, i, j);
      const int tt = t0 + i, c = c0 + j;
      if (tt < t && c < dh)
        sc.merged[((size_t)b * t + tt) * ldd + h * dh + c] = from_f<bf16>(acc[nt][e]);
    }
  }
  if (!BWD) return;

  // S = dO V^T (the softmax is in the scratch now)
  const float* dacc = sc.dacc + (size_t)bh * t * ldh;
  for (int u0 = 0; u0 < t; u0 += BT) {
    float acc[4][4] = {};
    mma_tile_f32(acc, tile_rows(dacc, ldh, t0, t), tile_rows(v, ldh, u0, t), 0, dh, stage);
    AVEC_FOR_ACC(nt, e) {
      int i, j;
      mma_tile_at(nt, e, i, j);
      const int u = u0 + j;
      if (u < t) S[i * lds + u] = acc[nt][e];
    }
  }
  __syncthreads();

  // S = ds = att (S - rowsum(S att)) scale, zero past t and on query rows
  // past t, and to the scratch; its row sums
  for (int r = warp; r < QT; r += THREADS / 32) {
    const int tt = t0 + r;
    const bool real = tt < t;
    float* row = S + r * lds;
    const size_t at = ((size_t)bh * t + (real ? tt : 0)) * sc.ldt;
    const float* arow = sc.att + at;
    float dot = 0.f;
    if (real)
      for (int u = lane; u < t; u += 32) dot += row[u] * arow[u];
    dot = warp_sum(dot);
    float rsv = 0.f;
    for (int u = lane; u < kpad; u += 32) {
      float val = 0.f;
      if (real && u < t) {
        val = arow[u] * (row[u] - dot) * scale;
        sc.ds[at + u] = val;
      }
      rsv += val;
      row[u] = val;
    }
    rsv = warp_sum(rsv);
    if (lane == 0) {
      rsum[r] = rsv;
      if (real) sc.rs[(size_t)bh * t + tt] = rsv;
    }
  }
  __syncthreads();

  // dq = ds k_h, then per 64 columns m0 of du = rotate(ds . tab): into U and
  // the scratch, and dq += du round(P_h)
  const int hc = cdiv(dh, BT);  // at most 2 (use_mma)
  float dq[2][4][4] = {};
#pragma unroll
  for (int ci = 0; ci < 2; ++ci)
    if (ci < hc) {
      auto bk = cols_of<bf16>([&](int u) { return kk + (size_t)u * ldh + ci * BT; },
                              dh - ci * BT);
      mma_tile_saf<3>(dq[ci], S, lds, bk, 0, t, stage);
    }
  for (int m0 = 0; m0 < d; m0 += BT) {
    float acc[4][4] = {};
    auto btab = cols_of<bf16>([&](int u) { return sc.tab + (size_t)u * ldd + m0; }, d - m0);
    mma_tile_saf<3>(acc, S, lds, btab, 0, t, stage);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int i, j;
        mma_tile_at(nt, e, i, j);  // j even: (da2, da1) sit in e, e + 1
        const int tt = t0 + i, c = m0 + j;
        float us = 0.f, uc = 0.f;
        if (c < d && tt < t) {  // d is even, so c + 1 < d
          const float da2 = acc[nt][e], da1 = acc[nt][e + 1];
          const float sn = to_f(sc.tab[(size_t)tt * ldd + c]);
          const float cs = to_f(sc.tab[(size_t)tt * ldd + c + 1]);
          us = da1 * sn - da2 * cs;
          uc = da1 * cs + da2 * sn;
          float* out = sc.du + ((size_t)bh * t + tt) * ldd + c;
          out[0] = us;
          out[1] = uc;
        }
        U[i * LDU + j] = us;
        U[i * LDU + j + 1] = uc;
      }
    __syncthreads();
    const int kn = min(BT, d - m0);
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
      if (ci < hc) {
        auto bp = rows_of<bf16>([&](int j) {
          const int c = ci * BT + j;
          return c < dh ? weight16(sc, W_P, h * dh + c, d) + m0 : nullptr;
        });
        mma_tile_saf<3>(dq[ci], U, LDU, bp, 0, kn, stage);
      }
  }
#pragma unroll
  for (int ci = 0; ci < 2; ++ci)
    if (ci < hc) {
      AVEC_FOR_ACC(nt, e) {
        int i, j;
        mma_tile_at(nt, e, i, j);
        const int tt = t0 + i, c = ci * BT + j;
        if (tt < t && c < dh)
          sc.dq[((size_t)b * t + tt) * ldd + h * dh + c] =
              dq[ci][nt][e] + rsum[i] * rnd<bf16>(p.pos_b[h * dh + c]);
      }
    }
}

// ---- the forward's tensor-core stages (TMA-fed `wgmma`, hopper.cuh)
//
// The projections and the attention stage of the bf16 forward: one
// warpgroup per 64-row output tile, operands brought by TMA into
// 128-byte-swizzled shared memory, products on `wgmma` with fp32
// accumulation, every rounding point of the TPU kernel read in the
// accumulator's fragment layout. No atomics: every output element has one
// owner, so the forward gives the same bits on every run.

constexpr int WG = 128;           // one warpgroup
constexpr int PROJ_RING = 4;      // ring stages ({A, B}) of a projection
constexpr int ATT_MAX_KT = 4;     // key tiles it holds in registers: t <= 256
enum ProjMode { PROJ_QKV = 0, PROJ_OUT = 1 };

struct ProjMaps {
  CUtensorMap a, w;  // h or merged (n, d); the five weights (5 d, d): boxes of 64 x 64
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Both values rounded to bf16 (kept in fp32) by one paired conversion: the
// epilogues below are bound by their conversions.
__device__ __forceinline__ float2 rnd2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return make_float2(__low2float(v), __high2float(v));
}

// Ring stages of a projection: {h, Wq, Wk, Wv} or {merged, Wo}.
__host__ __device__ constexpr int proj_ring(int mode) { return mode == PROJ_QKV ? 3 : 4; }
__host__ __device__ constexpr int proj_nb(int mode) { return mode == PROJ_QKV ? 3 : 1; }
constexpr size_t proj_smem(int mode) {
  return 1024 + (size_t)proj_ring(mode) * (1 + proj_nb(mode)) * hopper::TILE_BYTES +
         proj_ring(mode) * 8;
}

// PROJ_QKV: q, k, v = round(round(h W^T) + round(b)) of the same 64 columns,
// written per head (b, H, t, ldh). PROJ_OUT: y = round(round(round(merged
// Wo^T) + round(bo)) * mask) [+ x]. One warpgroup per (64 rows, 64 output
// columns): the TMA / `wgmma` main loop over d (h's tile read once for the
// three weights), then the epilogue in the accumulator's layout.
template <int MODE>
__global__ void __launch_bounds__(WG)
proj16_kernel(const __grid_constant__ ProjMaps maps, Params p, Scratch16 sc, Shape sh,
              const bf16* __restrict__ x, bf16* __restrict__ y, int residual, Drop dr) {
  using namespace hopper;
  constexpr int NB = proj_nb(MODE), RING = proj_ring(MODE);
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RING * (1 + NB) * TILE_BYTES);
  const int row0 = blockIdx.x * 64, col0 = blockIdx.y * 64, d = sh.d, n = sh.n;
  const CUtensorMap* mb[NB];
  int b_row[NB];  // rows past d (the next weight's) are never stored
  const float* bias[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int z = MODE == PROJ_QKV ? j : W_O;
    mb[j] = &maps.w;
    b_row[j] = z * d + col0;
    bias[j] = MODE == PROJ_OUT ? p.bo : (z == 0 ? p.bq : (z == 1 ? p.bk : p.bv));
  }
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  float bv[NB][16];  // round(bias) at this thread's 16 columns, read first
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = col0 + (i / 2) * 8 + 2 * q + (i & 1);
      bv[j][i] = col < d ? rnd<bf16>(bias[j][col]) : 0.f;
    }
  float acc[NB][32];
  const CUtensorMap* const (&mbc)[NB] = mb;
  const int (&brc)[NB] = b_row;
  wg_mainloop<NB, RING>(acc, ring, bars, &maps.a, row0, mbc, brc, 0, cdiv(d, 64));
  if (MODE == PROJ_QKV) {
    // per-head offsets of this thread's 2 rows and 16 columns
    size_t rb[2];
    int co[16];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + w * 16 + g + 8 * hh;
      rb[hh] = ((size_t)(row / sh.t) * sh.heads * sh.t + row % sh.t) * sc.ldh;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = col0 + (i / 2) * 8 + 2 * q + (i & 1), hd = col / sh.dh;
      co[i] = col < d ? hd * sh.t * sc.ldh + col - hd * sh.dh : -1;
    }
    bf16* outs[3] = {sc.q, sc.k, sc.v};
    // with an even head width a column pair lies in one head, at an even
    // offset: one 4-byte store
    const bool pairs = sh.dh % 2 == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (row0 + w * 16 + g + 8 * hh >= n) continue;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float2 a = rnd2(acc[j][4 * i + 2 * hh], acc[j][4 * i + 2 * hh + 1]);
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(a.x + bv[j][2 * i], a.y + bv[j][2 * i + 1]);
          bf16* o = outs[j] + rb[hh];
          if (pairs && co[2 * i] >= 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + co[2 * i]) = v;
            continue;
          }
          if (co[2 * i] >= 0) o[co[2 * i]] = __low2bfloat16(v);
          if (co[2 * i + 1] >= 0) o[co[2 * i + 1]] = __high2bfloat16(v);
        }
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + w * 16 + g + 8 * hh, col = col0 + i * 8 + 2 * q;
      if (row >= n || col >= d) continue;  // d is even, so col + 1 < d
      const int b = row / sh.t, tt = row % sh.t;
      const size_t at = (size_t)row * d + col;
      float2 v = rnd2(acc[0][4 * i + 2 * hh], acc[0][4 * i + 2 * hh + 1]);
      v = rnd2(v.x + bv[0][2 * i], v.y + bv[0][2 * i + 1]);
      v = make_float2(v.x * drop_mult(dr, b, tt, col, d), v.y * drop_mult(dr, b, tt, col + 1, d));
      if (residual) {
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at);
        v = rnd2(v.x, v.y);
        v = make_float2(v.x + __low2float(xv), v.y + __high2float(xv));
      }
      *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v.x, v.y);
    }
}

struct AttMaps {
  CUtensorMap q, k, v;  // per head (b H slabs of t rows x dh): boxes of 64 x 64
  CUtensorMap pos;      // P per head (H slabs of dh rows x d): boxes of 64 x 64
  CUtensorMap tab;      // the angle table (t, d): boxes of 64 x 64
};

// Streamed tiles of `att_fwd16_kernel`: a key tile's group (its k and tab
// tiles) and the first three tiles of the next, at least 8.
__host__ __device__ inline int att_ring(int d, int dh) {
  const int per_key = cdiv(dh, 64) + cdiv(d, 64);
  return per_key + 3 > 8 ? per_key + 3 : 8;
}

// Its shared memory: the block's q tiles, its rotated rel-pos projections
// a12 (64 x d, one tile per 64 columns), the ring and the barriers.
size_t att_fwd_smem(int d, int dh) {
  const int ring = att_ring(d, dh);
  return 1024 + (size_t)(cdiv(dh, 64) + cdiv(d, 64) + ring) * hopper::TILE_BYTES +
         (2 * ring + 1) * 8;
}

// The attention stage of the forward, one warpgroup per (sequence, head, 64
// query rows) and NKT = ceil(t / 64) key tiles. A producer warp streams the
// operand tiles by TMA through a ring of `ring_n` stages, in the order they
// are used, refilling a stage as soon as the four consumer warps have
// released it; the consumers take the tiles a group at a time (one commit,
// then each warp retires it and releases the group's stages):
//   U = q_h P_h^T per 64 columns of d (P_h read MN-major), rotated by the
//       query's angles in the accumulator's layout (us and uc are adjacent
//       columns of one thread), rounded: a12 (64 x d) to shared memory;
//   per key tile u: s_k = q k_u^T and s_e = a12 tab_u^T into separate
//       accumulators, each rounded before the sum, + round(q . b_pos),
//       scaled, -1e9 at keys past the length; columns past t are no keys;
//   the fp32 softmax over all key tiles (a row is held by the four lanes of
//       a quad), rounded to bf16 as the A fragments of att v;
//   o = att v per 64 columns of dh (v read MN-major), rounded into merged.
template <int NKT>
__global__ void __launch_bounds__(WG + 32)
att_fwd16_kernel(const __grid_constant__ AttMaps maps, const int* __restrict__ lengths,
                 Params p, Scratch16 sc, Shape sh, float scale) {
  using namespace hopper;
  const int t = sh.t, d = sh.d, dh = sh.dh, hc = cdiv(dh, 64), nch = cdiv(d, 64);
  const int ring_n = att_ring(d, dh);
  const int t0 = blockIdx.x * 64, bh = blockIdx.z, b = bh / sh.heads, h = bh % sh.heads;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane >> 2, qd = lane & 3;
  const int len = clamp_len(lengths, b, t);
  unsigned char* base = smem_base_1k();
  bf16* qs = reinterpret_cast<bf16*>(base);          // hc tiles
  bf16* a12 = qs + hc * TILE_ELEMS;                  // nch tiles
  bf16* ring = a12 + nch * TILE_ELEMS;               // ring_n tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_n * TILE_ELEMS);  // ring_n
  uint64_t* empty = full + ring_n;                                            // ring_n
  uint64_t* q_bar = empty + ring_n;
  __shared__ float qb[64], bpos[128];

  if (tid == 0) {
    for (int i = 0; i < ring_n; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WG / 32);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  for (int c = tid; c < dh; c += WG + 32) bpos[c] = rnd<bf16>(p.pos_b[h * dh + c]);
  __syncthreads();  // the last barrier of all WG + 32 threads

  // The producer warp (the block's last): its lane 0 asks for the q tiles,
  // then for every streamed tile in the order the products take them, each
  // into the next stage once the four consumer warps have released it: the
  // P tiles (chunk a of d, k tile b of dh), per key tile a its k (b < hc) and
  // tab tiles, then per key tile a its v tiles (b).
  if (w == WG / 32) {
    if (lane != 0) return;
    tma_prefetch_desc(&maps.q);
    tma_prefetch_desc(&maps.pos);
    tma_prefetch_desc(&maps.k);
    tma_prefetch_desc(&maps.tab);
    tma_prefetch_desc(&maps.v);
    mbar_expect_tx(q_bar, hc * TILE_BYTES);
    for (int kc = 0; kc < hc; ++kc)
      tma_load_3d(qs + kc * TILE_ELEMS, &maps.q, q_bar, kc * 64, t0, bh);
    const int parts[3][2] = {{nch, hc}, {NKT, hc + nch}, {NKT, hc}};  // (outer, inner)
    int slot = 0, use = 0;  // stage, and how often it was filled before
    for (int part = 0; part < 3; ++part)
      for (int a = 0; a < parts[part][0]; ++a)
        for (int bb = 0; bb < parts[part][1]; ++bb) {
          if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
          bf16* dst = ring + slot * TILE_ELEMS;
          mbar_expect_tx(&full[slot], TILE_BYTES);
          if (part == 0)
            tma_load_3d(dst, &maps.pos, &full[slot], a * 64, bb * 64, h);
          else if (part == 1 && bb < hc)
            tma_load_3d(dst, &maps.k, &full[slot], bb * 64, a * 64, bh);
          else if (part == 1)
            tma_load_2d(dst, &maps.tab, &full[slot], (bb - hc) * 64, a * 64);
          else
            tma_load_3d(dst, &maps.v, &full[slot], bb * 64, a * 64, bh);
          if (++slot == ring_n) slot = 0, ++use;
        }
    return;
  }

  // the consumer warpgroup's view: the first tile of the group being taken
  // (its stage and the parity of that stage's use)
  const int per_key = hc + nch;
  int out_slot = 0, out_par = 0;
  auto stage_of = [&](int i, int& par) {
    int st = out_slot + i;
    par = out_par;
    if (st >= ring_n) st -= ring_n, par ^= 1;
    return st;
  };
  auto tile = [&](int i) {  // the i-th tile of the group being taken
    int par;
    return static_cast<const bf16*>(ring + stage_of(i, par) * TILE_ELEMS);
  };
  auto wait_group = [&](int count) {
    for (int i = 0; i < count; ++i) {
      int par;
      const int st = stage_of(i, par);
      mbar_wait(&full[st], par);
    }
  };
  // this warp has retired its products on the group's `count` tiles
  auto release = [&](int count) {
    if (lane == 0)
      for (int i = 0; i < count; ++i) {
        int par;
        mbar_arrive(&empty[stage_of(i, par)]);
      }
    out_slot = stage_of(count, out_par);
  };
  mbar_wait(q_bar, 0);

  // a12 = the rotated U = q_h P_h^T, 64 columns at a time
  for (int mc = 0; mc < nch; ++mc) {
    uint32_t tabv[8][2];  // (sin, cos) of this thread's rows and column pairs
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tt = t0 + w * 16 + g + 8 * hh, c = mc * 64 + i * 8 + 2 * qd;
        tabv[i][hh] = tt < t && c < d
                          ? *reinterpret_cast<const uint32_t*>(sc.tab + (size_t)tt * sc.ldd + c)
                          : 0u;
      }
    float u[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] = 0.f;
    wait_group(hc);
    acc_fence(u);
    wgmma_fence();
    for (int kc = 0; kc < hc; ++kc)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_64x64_ss<0, 1>(u, sw128_desc(qs + kc * TILE_ELEMS + ks * 16),
                             sw128_desc(tile(kc) + ks * 16 * 64));
    wgmma_commit();
    if (mc == 0) {  // round(q . b_pos) of query row tid / 2 (two threads, half
                    // the columns each) while the first products run
      const int r = tid >> 1, c0 = (tid & 1) * 64;
      float a = 0.f;
      for (int c = c0; c < min(dh, c0 + 64); ++c)
        a = fmaf(to_f(qs[(c >> 6) * TILE_ELEMS + sw128_at(r, c & 63)]), bpos[c], a);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if ((tid & 1) == 0) qb[r] = rnd<bf16>(a);
    }
    wgmma_wait_all();
    acc_fence(u);
    release(hc);
    bf16* at = a12 + mc * TILE_ELEMS;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const __nv_bfloat162 sc2 = *reinterpret_cast<const __nv_bfloat162*>(&tabv[i][hh]);
        const float sn = __low2float(sc2), cs = __high2float(sc2);
        const float2 uu = rnd2(u[4 * i + 2 * hh], u[4 * i + 2 * hh + 1]);  // (us, uc)
        const float2 t2 = rnd2(uu.y * sn, uu.x * cs), t1 = rnd2(uu.x * sn, uu.y * cs);
        // a2 = uc sin - us cos, a1 = us sin + uc cos, rounded as they are stored
        *reinterpret_cast<__nv_bfloat162*>(at + sw128_at(w * 16 + g + 8 * hh, i * 8 + 2 * qd)) =
            __floats2bfloat162_rn(t2.x - t2.y, t1.x + t1.y);
      }
  }
  fence_proxy_async();  // a12, written by the threads, is read by `wgmma`
  asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");  // the consumers only

  // scores, one key tile at a time; s holds them all
  const float neg = rnd<bf16>(-1e9f), qb_row[2] = {qb[w * 16 + g], qb[w * 16 + g + 8]};
  float s[NKT][32];
#pragma unroll
  for (int u = 0; u < NKT; ++u) {
    float se[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[u][i] = se[i] = 0.f;
    wait_group(per_key);
    acc_fence(s[u]);
    acc_fence(se);
    wgmma_fence();
    for (int kc = 0; kc < hc; ++kc) wgmma_tile_k64(s[u], qs + kc * TILE_ELEMS, tile(kc));
    for (int mc = 0; mc < nch; ++mc) wgmma_tile_k64(se, a12 + mc * TILE_ELEMS, tile(hc + mc));
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(s[u]);
    acc_fence(se);
    release(per_key);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // columns c, c + 1 of one row
        const int c = u * 64 + i * 8 + 2 * qd, at = 4 * i + 2 * hh;
        const float2 k2 = rnd2(s[u][at], s[u][at + 1]), e2 = rnd2(se[at], se[at + 1]);
        float2 v = rnd2(k2.x + e2.x, k2.y + e2.y);
        v = rnd2(v.x + qb_row[hh], v.y + qb_row[hh]);
        v = rnd2(v.x * scale, v.y * scale);
        // -1e9 at keys past the length (adding 0 to a rounded value is exact)
        v = rnd2(v.x + (c >= len ? neg : 0.f), v.y + (c + 1 >= len ? neg : 0.f));
        s[u][at] = c < t ? v.x : -INFINITY;  // past t: no key
        s[u][at + 1] = c + 1 < t ? v.y : -INFINITY;
      }
  }

  // the fp32 softmax of this thread's two rows, then att rounded to bf16 as
  // the A fragments of att v: af[u][ks] holds key columns 64 u + 16 ks ..
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < NKT; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[u][i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
  }
#pragma unroll
  for (int u = 0; u < NKT; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = expf(s[u][i] - mx[(i >> 1) & 1]);
      s[u][i] = e;
      sum[(i >> 1) & 1] += e;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
  }
  uint32_t af[NKT][4][4];
#pragma unroll
  for (int u = 0; u < NKT; ++u)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i0 = 8 * ks + 2 * r;
        af[u][ks][r] = pack_bf16(s[u][i0] / sum[r & 1], s[u][i0 + 1] / sum[r & 1]);
      }

  // o = round(att) v per 64 columns of dh
  float o[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int u = 0; u < NKT; ++u) {
    wait_group(hc);
    acc_fence(o[0]);
    acc_fence(o[1]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (c < hc)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_64x64_rs_mn(o[c], af[u][ks], tile(c) + ks * 16 * 64);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) reg_fence(af[u][ks]);
    acc_fence(o[0]);
    acc_fence(o[1]);
    release(hc);
  }
  const bool pairs = dh % 2 == 0;  // a column pair in one 4-byte store
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= hc) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tt = t0 + w * 16 + g + 8 * hh, cc = c * 64 + i * 8 + 2 * qd;
        if (tt >= t || cc >= dh) continue;
        bf16* m = sc.merged + ((size_t)b * t + tt) * sc.ldd + h * dh + cc;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(o[c][4 * i + 2 * hh], o[c][4 * i + 2 * hh + 1]);
        if (pairs) {  // dh even: cc + 1 < dh
          *reinterpret_cast<__nv_bfloat162*>(m) = v;
        } else {
          m[0] = __low2bfloat16(v);
          if (cc + 1 < dh) m[1] = __high2bfloat16(v);
        }
      }
  }
}

// dv_h = att^T dO_h (blockIdx.z even) and dk_h = ds^T q_h (odd), fp32, att,
// dO and ds at fp32 precision; each key tile has one owner.
__global__ void __launch_bounds__(THREADS)
kv16_kernel(Scratch16 sc, Shape sh) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE_F32];
  const int u0 = blockIdx.x * BT, c0 = blockIdx.y * BT, which = blockIdx.z & 1,
            bh = blockIdx.z >> 1;
  const int b = bh / sh.heads, h = bh % sh.heads, t = sh.t, dh = sh.dh;
  const float* pm = (which ? sc.ds : sc.att) + (size_t)bh * t * sc.ldt;
  const size_t head = (size_t)bh * t * sc.ldh;
  float* out = (which ? sc.dk : sc.dv) + (size_t)b * t * sc.ldd + h * dh;
  float acc[4][4] = {};
  auto a = token_cols(pm, sc.ldt, u0, t);
  if (which)
    mma_tile_f32(acc, a, token_cols(sc.q + head, sc.ldh, c0, dh), 0, t, sm);
  else
    mma_tile_f32<true>(acc, a, token_cols(sc.dacc + head, sc.ldh, c0, dh), 0, t, sm);
  AVEC_FOR_ACC(nt, e) {
    int i, j;
    mma_tile_at(nt, e, i, j);
    const int u = u0 + i, c = c0 + j;
    if (u < t && c < dh) out[(size_t)u * sc.ldd + c] = acc[nt][e];
  }
}

// Every product with a parameter's or dh's tile as its output, one owner per
// 64 x 64 tile, blockIdx.x over the jobs in this order: dWo (d, d), dP per
// head (dh, d), dWq, dWk, dWv (d, d), dh (n, d). The weight gradients reduce
// over the token rows of split blockIdx.y, into the gradient itself when
// there is one split and into sc.part_w otherwise; dh is split 0's.
__global__ void __launch_bounds__(THREADS)
weights16_kernel(Grads gr, Scratch16 sc, Shape sh) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE_F32];
  const int n = sh.n, d = sh.d, dh = sh.dh, heads = sh.heads, ldd = sc.ldd;
  const int dt = cdiv(d, BT), ht = cdiv(dh, BT), sq = dt * dt;
  const int split = blockIdx.y, per = cdiv(n, sc.splits);
  const int r_begin = split * per, r_end = min(n, r_begin + per);
  int blk = blockIdx.x;
  float acc[4][4] = {};
  auto store = [&](float* out, int r0, int rows, int c0, int cols, int ld) {
    AVEC_FOR_ACC(nt, e) {
      int i, j;
      mma_tile_at(nt, e, i, j);
      const int r = r0 + i, c = c0 + j;
      if (r < rows && c < cols) out[(size_t)r * ld + c] = acc[nt][e];
    }
  };
  // weight `which`'s d x d gradient, or this split's partial of it
  auto weight_out = [&](int which, float* grad) {
    return sc.splits == 1 ? grad : sc.part_w + ((size_t)split * NW + which) * d * d;
  };
  if (blk < sq) {  // dWo[j][i] = sum_r round(g mask)[r][j] merged[r][i]
    const int j0 = (blk / dt) * BT, i0 = (blk % dt) * BT;
    mma_tile(acc, token_cols(sc.gm, ldd, j0, d), token_cols(sc.merged, ldd, i0, d), r_begin,
             r_end, sm);
    store(weight_out(W_O, gr.wo), j0, d, i0, d, d);
    return;
  }
  blk -= sq;
  if (blk < heads * ht * dt) {  // dP[h dh + c][m] = sum_r q[r][h dh + c] du[b, h, t][m]
    const int h = blk / (ht * dt), c0 = ((blk / dt) % ht) * BT, m0 = (blk % dt) * BT;
    // the tile transposed, du (fp32) as its A: acc[i][j] = dP[c0 + j][m0 + i]
    auto a = cols_of<float>([&](int r) { return sc.du + head_row(r, h, sh) * ldd + m0; },
                            d - m0);
    auto b = cols_of<bf16>([&](int r) { return sc.q + head_row(r, h, sh) * sc.ldh + c0; },
                           dh - c0);
    mma_tile_f32(acc, a, b, r_begin, r_end, sm);
    float* out = weight_out(W_P, gr.pos_w) + (size_t)h * dh * d;
    AVEC_FOR_ACC(nt, e) {
      int i, j;
      mma_tile_at(nt, e, i, j);
      if (c0 + j < dh && m0 + i < d) out[(size_t)(c0 + j) * d + m0 + i] = acc[nt][e];
    }
    return;
  }
  blk -= heads * ht * dt;
  if (blk < 3 * sq) {  // dW[j][i] = sum_r round(dz[r][j]) h[r][i]
    const int z = blk / sq, j0 = ((blk % sq) / dt) * BT, i0 = (blk % dt) * BT;
    const float* dz = z == 0 ? sc.dq : (z == 1 ? sc.dk : sc.dv);
    mma_tile(acc, token_cols(dz, ldd, j0, d), token_cols(sc.h, ldd, i0, d), r_begin, r_end, sm);
    store(weight_out(z, z == 0 ? gr.wq : (z == 1 ? gr.wk : gr.wv)), j0, d, i0, d, d);
    return;
  }
  blk -= 3 * sq;
  if (split > 0) return;  // uniform over the block
  // dh = round(dq) round(Wq) + round(dk) round(Wk) + round(dv) round(Wv)
  const int row0 = (blk / dt) * BT, col0 = (blk % dt) * BT;
  for (int z = 0; z < 3; ++z) {
    const float* dz = z == 0 ? sc.dq : (z == 1 ? sc.dk : sc.dv);
    auto a = rows_of<float>([&](int r) {
      const int row = row0 + r;
      return row < n ? dz + (size_t)row * ldd : nullptr;
    });
    auto b = cols_of<bf16>([&](int k) { return weight16(sc, z, k, d) + col0; }, d - col0);
    mma_tile(acc, a, b, 0, d, sm);
  }
  store(sc.dh, row0, n, col0, d, d);
}

// SUM_ROWS token rows per block: the LayerNorm backward into dx (the
// residual's cotangent g added unmasked), and the rows' partial sums of the
// seven column sums: dbo (g * mask), dbq, dbk, dbv, dLN bias (dh), dLN weight
// (dh * xhat) and the positional bias (q * rowsum(ds) of the column's head).
__global__ void __launch_bounds__(THREADS)
ln_bwd16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, bf16* __restrict__ dx,
                Params p, Scratch16 sc, Shape sh, int residual, Drop dr) {
  const int row0 = blockIdx.x * SUM_ROWS, tid = threadIdx.x, d = sh.d, t = sh.t;
  const int rows = min(SUM_ROWS, sh.n - row0);
  for (int col = tid; col < d; col += THREADS) {
    const int h = col / sh.dh, c = col % sh.dh;
    float s[NSUMS] = {};
    for (int r = row0; r < row0 + rows; ++r) {
      const size_t at = (size_t)r * d + col, atp = (size_t)r * sc.ldd + col;
      const size_t hr = head_row(r, h, sh);
      const float dhv = sc.dh[at];
      const float xhat = (to_f(x[at]) - sc.mean[r]) * sc.rstd[r];
      s[0] += masked_g<bf16>(g, dr, r, col, t, d);
      s[1] += sc.dq[atp];
      s[2] += sc.dk[atp];
      s[3] += sc.dv[atp];
      s[4] += dhv;
      s[5] += dhv * xhat;
      s[6] += to_f(sc.q[hr * sc.ldh + c]) * sc.rs[hr];
    }
#pragma unroll
    for (int k = 0; k < NSUMS; ++k) sc.part[((size_t)blockIdx.x * NSUMS + k) * d + col] = s[k];
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    const int row = row0 + r;
    const float mean = sc.mean[row], rstd = sc.rstd[row];
    const bf16* xr = x + (size_t)row * d;
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
      float val = rstd * (dxh - m1 - xhat * m2);
      if (residual) val += to_f(g[(size_t)row * d + c]);
      dx[(size_t)row * d + c] = from_f<bf16>(val);
    }
  }
}

// The partial sums added in a fixed order: one warp per column sum over the
// row blocks (blockIdx.x < sum_blocks, lanes striding, then a fixed shuffle
// tree), and where the weight gradients were split, one thread per element
// over the splits.
__global__ void __launch_bounds__(THREADS)
reduce16_kernel(Grads gr, Scratch16 sc, Shape sh, int sum_blocks) {
  const int d = sh.d, lane = threadIdx.x % 32;
  if ((int)blockIdx.x < sum_blocks) {
    const int e = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
    if (e >= NSUMS * d) return;  // uniform over the warp
    const int k = e / d, col = e % d, blocks = cdiv(sh.n, SUM_ROWS);
    float v = 0.f;
    for (int b = lane; b < blocks; b += 32) v += sc.part[((size_t)b * NSUMS + k) * d + col];
    v = warp_sum(v);
    float* outs[NSUMS] = {gr.bo, gr.bq, gr.bk, gr.bv, gr.ln_b, gr.ln_w, gr.pos_b};
    if (lane == 0) outs[k][col] = v;
    return;
  }
  const size_t dd = (size_t)d * d;
  const size_t e = (size_t)(blockIdx.x - sum_blocks) * THREADS + threadIdx.x;
  if (e >= NW * dd) return;
  const int which = (int)(e / dd);
  float v = 0.f;
  for (int s = 0; s < sc.splits; ++s) v += sc.part_w[(size_t)s * NW * dd + e];
  float* outs[NW] = {gr.wq, gr.wk, gr.wv, gr.pos_w, gr.wo};
  outs[which][e % dd] = v;
}

// ---- host side

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

// Row splits of the weight-gradient products: enough blocks for about four
// per SM, at least 8 reduction chunks per split.
int weight_splits16(const Shape& sh) {
  const int dt = cdiv(sh.d, BT), tiles = 4 * dt * dt + sh.heads * cdiv(sh.dh, BT) * dt;
  const int by_card = cdiv(528, tiles), by_depth = sh.n / (8 * MMA_BK);
  const int s = by_card < by_depth ? by_card : by_depth;
  return s < 1 ? 1 : s;
}

// The forward's attention stage on the tensor cores (`att_fwd16_kernel`)
// takes up to ATT_MAX_KT key tiles and heads up to 128 wide; longer
// sequences take relpos16 and the mma.sync attention stage.
bool att_fwd_wgmma(const Shape& sh) {
  return cdiv(sh.t, 64) <= ATT_MAX_KT && sh.dh <= 128 && att_fwd_smem(sh.d, sh.dh) <= MAX_SMEM;
}

// Carves `base` (nullptr: only sizes) into the bf16 path's scratch; returns
// its size in bytes.
size_t carve16(char* base, const Shape& sh, bool backward, Scratch16* sc) {
  *sc = Scratch16{};
  sc->ldd = round8(sh.d);
  sc->ldh = round8(sh.dh);
  sc->ldt = round8(sh.t);
  const size_t n = sh.n, d = sh.d, bht = (size_t)sh.b * sh.heads * sh.t;
  const size_t ldd = sc->ldd, ldh = sc->ldh, ldt = sc->ldt;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  auto tb = [&](size_t elems) { return reinterpret_cast<bf16*>(take(elems * 2)); };
  auto tf = [&](size_t elems) { return reinterpret_cast<float*>(take(elems * 4)); };
  sc->mean = tf(n);
  sc->rstd = tf(n);
  sc->w = tb(NW * d * ldd);
  sc->tab = tb((size_t)sh.t * ldd);
  sc->h = tb(n * ldd);
  sc->merged = tb(n * ldd);
  sc->q = tb(bht * ldh);
  sc->k = tb(bht * ldh);
  sc->v = tb(bht * ldh);
  if (backward || !att_fwd_wgmma(sh)) sc->a12 = tb(bht * ldd);
  if (backward) {
    sc->gm = tb(n * ldd);
    sc->dacc = tf(bht * ldh);
    sc->att = tf(bht * ldt);
    sc->ds = tf(bht * ldt);
    sc->du = tf(bht * ldd);
    sc->rs = tf(bht);
    sc->dq = tf(n * ldd);
    sc->dk = tf(n * ldd);
    sc->dv = tf(n * ldd);
    sc->dh = tf(n * d);
    sc->part = tf((size_t)cdiv(sh.n, SUM_ROWS) * NSUMS * d);
    sc->splits = weight_splits16(sh);
    if (sc->splits > 1) sc->part_w = tf((size_t)sc->splits * NW * d * d);
  }
  return at;
}

// The tensor-core stages take bf16 inputs whose (64, t) score tile fits in
// one block's shared memory (t <= 736) and whose heads are at most 128 wide;
// the rest run the FMA stages.
bool use_mma(const Shape& sh, int is_bf16) {
  return is_bf16 && sh.dh <= 2 * BT && att_smem(sh.t, true).total <= MAX_SMEM;
}

cudaError_t launch_att16(bool bwd, const int* lengths, const Params& p, const Scratch16& sc,
                         const Shape& sh, float scale, cudaStream_t st) {
  const AttSmem L = att_smem(sh.t, bwd);
  auto kern = bwd ? att16_kernel<true> : att16_kernel<false>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (rc != cudaSuccess) return rc;
  kern<<<dim3(cdiv(sh.t, QT), 1, sh.b * sh.heads), THREADS, L.total, st>>>(lengths, p, sc, sh,
                                                                           scale);
  return cudaGetLastError();
}

// The stages both directions share: the casts, LayerNorm (and round(g mask)),
// the q/k/v projections on the tensor cores; in the backward dacc, the
// rel-pos projections and the mma.sync attention stage, in the forward the
// tensor-core attention stage (or, past ATT_MAX_KT key tiles, the backward's
// two stages in their forward form). `wmap` is the map over the bf16 weights
// (the caller's, so the forward's out-projection reuses it).
cudaError_t run_core16(const bf16* x, const bf16* g, const bf16* tab, const int* lengths,
                       const Params& p, const Scratch16& sc, const Shape& sh, float eps,
                       float scale, Drop dr, const CUtensorMap& wmap, cudaStream_t st) {
  using hopper::tensor_map_2d;
  using hopper::tensor_map_3d;
  const int nt = cdiv(sh.n, BT), dt = cdiv(sh.d, BT), bwd = g != nullptr;
  const int bh = sh.b * sh.heads;
  ProjMaps pm;
  pm.w = wmap;
  if (!tensor_map_2d(&pm.a, sc.h, sh.n, sh.d, sc.ldd, 64)) return cudaErrorInvalidValue;
  AVEC_LAUNCH(prep16_kernel, dim3(cast_blocks(sh) + cdiv(sh.n, THREADS / 32)), x, g, tab, p, sc,
              sh, eps, dr);
  cudaError_t rc = cudaFuncSetAttribute(proj16_kernel<PROJ_QKV>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)proj_smem(PROJ_QKV));
  if (rc != cudaSuccess) return rc;
  proj16_kernel<PROJ_QKV><<<dim3(nt, dt), WG, proj_smem(PROJ_QKV), st>>>(pm, p, sc, sh, nullptr,
                                                                          nullptr, 0, dr);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  if (bwd) AVEC_LAUNCH(dacc16_kernel, dim3(nt, dt), sc, sh);
  if (bwd || !att_fwd_wgmma(sh)) {
    AVEC_LAUNCH(relpos16_kernel, dim3(cdiv(sh.t, BT), dt, bh), sc, sh);
    return launch_att16(bwd, lengths, p, sc, sh, scale, st);
  }
  AttMaps am;
  const long long slab = (long long)sh.t * sc.ldh;
  if (!tensor_map_3d(&am.q, sc.q, sh.dh, sh.t, bh, sc.ldh, slab, 64) ||
      !tensor_map_3d(&am.k, sc.k, sh.dh, sh.t, bh, sc.ldh, slab, 64) ||
      !tensor_map_3d(&am.v, sc.v, sh.dh, sh.t, bh, sc.ldh, slab, 64) ||
      !tensor_map_3d(&am.pos, weight16(sc, W_P, 0, sh.d), sh.d, sh.dh, sh.heads, sc.ldd,
                     (long long)sh.dh * sc.ldd, 64) ||
      !tensor_map_2d(&am.tab, sc.tab, sh.t, sh.d, sc.ldd, 64))
    return cudaErrorInvalidValue;
  const int nkt = cdiv(sh.t, 64);
  const size_t smem = att_fwd_smem(sh.d, sh.dh);
  auto kern = nkt == 1 ? att_fwd16_kernel<1>
                       : nkt == 2 ? att_fwd16_kernel<2>
                                  : nkt == 3 ? att_fwd16_kernel<3> : att_fwd16_kernel<4>;
  rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return rc;
  kern<<<dim3(nkt, 1, bh), WG + 32, smem, st>>>(am, lengths, p, sc, sh, scale);
  return cudaGetLastError();
}

cudaError_t run_fwd16(const void* x, const void* tab, const int* lengths, const Params& p,
                      void* y, void* scratch, const Shape& sh, float eps, float scale,
                      int residual, Drop dr, cudaStream_t st) {
  Scratch16 sc;
  carve16(static_cast<char*>(scratch), sh, false, &sc);
  const bf16* xt = static_cast<const bf16*>(x);
  ProjMaps pm;
  if (!hopper::tensor_map_2d(&pm.a, sc.merged, sh.n, sh.d, sc.ldd, 64) ||
      !hopper::tensor_map_2d(&pm.w, sc.w, NW * sh.d, sh.d, sc.ldd, 64))
    return cudaErrorInvalidValue;
  cudaError_t rc = run_core16(xt, nullptr, static_cast<const bf16*>(tab), lengths, p, sc, sh,
                              eps, scale, dr, pm.w, st);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(proj16_kernel<PROJ_OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)proj_smem(PROJ_OUT));
  if (rc != cudaSuccess) return rc;
  proj16_kernel<PROJ_OUT><<<dim3(cdiv(sh.n, 64), cdiv(sh.d, 64)), WG, proj_smem(PROJ_OUT), st>>>(
      pm, p, sc, sh, xt, static_cast<bf16*>(y), residual, dr);
  return cudaGetLastError();
}

cudaError_t run_bwd16(const void* x, const void* g, const void* tab, const int* lengths,
                      const Params& p, void* dx, const Grads& gr, void* scratch, const Shape& sh,
                      float eps, float scale, int residual, Drop dr, cudaStream_t st) {
  Scratch16 sc;
  carve16(static_cast<char*>(scratch), sh, true, &sc);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* gt = static_cast<const bf16*>(g);
  CUtensorMap wmap;
  if (!hopper::tensor_map_2d(&wmap, sc.w, NW * sh.d, sh.d, sc.ldd, 64))
    return cudaErrorInvalidValue;
  const cudaError_t rc = run_core16(xt, gt, static_cast<const bf16*>(tab), lengths, p, sc, sh,
                                    eps, scale, dr, wmap, st);
  if (rc != cudaSuccess) return rc;
  const int nt = cdiv(sh.n, BT), dt = cdiv(sh.d, BT), ht = cdiv(sh.dh, BT), sq = dt * dt;
  AVEC_LAUNCH(kv16_kernel, dim3(cdiv(sh.t, BT), ht, sh.b * sh.heads * 2), sc, sh);
  AVEC_LAUNCH(weights16_kernel, dim3(4 * sq + sh.heads * ht * dt + nt * dt, sc.splits), gr, sc,
              sh);
  AVEC_LAUNCH(ln_bwd16_kernel, dim3(cdiv(sh.n, SUM_ROWS)), xt, gt, static_cast<bf16*>(dx), p, sc,
              sh, residual, dr);
  const int sum_blocks = cdiv(NSUMS * sh.d, THREADS / 32);
  const int w_blocks = sc.splits > 1 ? cdiv(NW * sh.d * sh.d, THREADS) : 0;
  AVEC_LAUNCH(reduce16_kernel, dim3(sum_blocks + w_blocks), gr, sc, sh, sum_blocks);
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
extern "C" long long avec_att_scratch_floats(int b, int t, int d, int heads, int backward,
                                             int is_bf16) {
  Shape sh;
  if (!make_shape(sh, b, t, d, heads)) return 0;
  if (use_mma(sh, is_bf16)) {
    Scratch16 sc;
    return (long long)((carve16(nullptr, sh, backward != 0, &sc) + 3) / 4);
  }
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
  if (use_mma(sh, is_bf16))
    return run_fwd16(x, tab, len, p, y, sc, sh, eps, scale, residual, dr, st);
  if (is_bf16) return run_fwd<bf16>(x, tab, len, p, y, sc, sh, eps, scale, residual, dr, st);
  return run_fwd<float>(x, tab, len, p, y, sc, sh, eps, scale, residual, dr, st);
}

// g, dx: (b, t, d) in x's dtype; grads: twelve fp32 buffers in the order of
// `Params` that the call writes whole: the tensor-core stages write each
// element once; for the FMA stages, which add into them with atomics, the
// call first zeroes them on the stream.
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
  if (use_mma(sh, is_bf16))
    return run_bwd16(x, g, tab, len, p, dx, gr, sc, sh, eps, scale, residual, dr, st);
  for (int i = 0; i < 12; ++i) {  // the weights sit at the even places from 2 on
    const size_t count = i >= 2 && i % 2 == 0 ? (size_t)d * d : (size_t)d;
    const cudaError_t rc = cudaMemsetAsync(grads[i], 0, count * sizeof(float), st);
    if (rc != cudaSuccess) return rc;
  }
  if (is_bf16)
    return run_bwd<bf16>(x, g, tab, len, p, dx, gr, sc, sh, eps, scale, residual, dr, st);
  return run_bwd<float>(x, g, tab, len, p, dx, gr, sc, sh, eps, scale, residual, dr, st);
}
