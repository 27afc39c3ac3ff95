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
// of fp32 scratch between 16 stages; atomics for the weight gradients): every
// product runs on mma.sync with fp32 accumulation from bf16 operands staged in
// 16-byte pieces (tile.cuh `mma_tile`); the weights are cast to bf16 once per
// call and every value the TPU kernel rounds to x's type lives in bf16
// scratch laid out so that rows start 16-byte aligned, while the values its
// backward multiplies unrounded (dO, the softmax, ds, du) stay fp32 and enter
// their products as three bf16 parts that sum to them exactly (tile.cuh
// `mma_tile_f32`), so those products are fp32's; scores, softmax, att v,
// dO V^T, the softmax backward, the rel-pos backward and dq share one stage
// per (sequence, head, 64 query rows), holding the (64, T) fp32 score tile in
// shared memory; and every parameter gradient has one owner per element (row
// splits summed in a fixed order), so the gradients are the same bits on
// every run. Forward: 6 stages; backward: 9 (the bf16 section below).

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

// ---- bf16 stages on the tensor cores
//
// Every product runs on `mma_tile` and its fp32 forms (tile.cuh: mma.sync with
// fp32 accumulation on bf16 operands staged in 16-byte pieces). A first stage
// casts the five weights and the angle table to bf16 once per call, and the
// stages hand bf16 values to each other in layouts whose rows start at
// multiples of 8 elements: (n, d) activations with rows padded to ldd, q, k, v
// and the merged heads' cotangent per head (b, H, t, ldh), the softmax and ds
// as (b, H, t, ldt). Values the TPU kernel rounds to x's type are held in
// bf16. The values its backward keeps in fp32 (dO = g Wo, the softmax where
// it is not rounded, ds and the rel-pos cotangent du) stay fp32, in the
// scratch and in shared memory, and every product that takes one of them
// takes it at fp32 precision (`mma_tile_f32`, `mma_tile_saf<3>`); dq, dk and
// dv are fp32 and rounded where the TPU kernel rounds them. One stage per
// (sequence, head, 64 query rows) computes the scores, the fp32 softmax and
// att v, and in the backward dO V^T, the softmax backward, the rel-pos
// backward and dq, holding its (64, t) fp32 score tile in shared memory.
// Every parameter gradient has one owner per element and every sum a fixed
// order: no atomics, the same bits on every run. Forward: 6 stages;
// backward: 9.

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

__device__ __forceinline__ const bf16* weight16(const Scratch16& sc, int which, int row, int d) {
  return sc.w + ((size_t)which * d + row) * sc.ldd;
}

// Row (b, h, t) of a per-head (b, H, t, ld) array, for token row r = b t + t'.
__device__ __forceinline__ size_t head_row(int r, int h, const Shape& sh) {
  return ((size_t)(r / sh.t) * sh.heads + h) * sh.t + r % sh.t;
}

// blockIdx.x < 5 d: row blockIdx.x % d of weight blockIdx.x / d (Wq, Wk, Wv,
// P, Wo) to bf16; then the angle table's rows.
__global__ void __launch_bounds__(THREADS)
cast16_kernel(Params p, const bf16* __restrict__ tab, Scratch16 sc, Shape sh) {
  const int d = sh.d, row = blockIdx.x;
  if (row < NW * d) {
    const float* ws[NW] = {p.wq, p.wk, p.wv, p.pos_w, p.wo};
    const float* src = ws[row / d] + (size_t)(row % d) * d;
    bf16* dst = sc.w + (size_t)row * sc.ldd;
    for (int c = threadIdx.x; c < d; c += THREADS) dst[c] = from_f<bf16>(src[c]);
  } else {
    const int u = row - NW * d;
    for (int c = threadIdx.x; c < d; c += THREADS)
      sc.tab[(size_t)u * sc.ldd + c] = tab[(size_t)u * d + c];
  }
}

// One warp per token row: mean and 1 / sqrt(var + eps) in fp32, h rounded as
// the TPU kernel rounds it, and in the backward round(g * mask).
__global__ void __launch_bounds__(THREADS)
ln_h16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, Params p, Scratch16 sc,
              Shape sh, float eps, Drop dr) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = sh.d;
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

// blockIdx.z 0..2: q, k, v = round(round(h W^T) + round(b)), per head;
// 3 (backward): dacc = round(g * mask) Wo, the merged heads' cotangent, per
// head, in fp32 as the TPU kernel keeps it.
__global__ void __launch_bounds__(THREADS)
qkv16_kernel(Params p, Scratch16 sc, Shape sh) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, z = blockIdx.z, n = sh.n, d = sh.d;
  float acc[4][4] = {};
  const bf16* a_base = z == 3 ? sc.gm : sc.h;
  auto a = rows_of<bf16>([&](int r) {
    const int row = row0 + r;
    return row < n ? a_base + (size_t)row * sc.ldd : nullptr;
  });
  if (z == 3) {
    auto b = cols_of<bf16>([&](int k) { return weight16(sc, W_O, k, d) + col0; }, d - col0);
    mma_tile(acc, a, b, 0, d, sm);
  } else {
    auto b = rows_of<bf16>([&](int j) {
      const int col = col0 + j;
      return col < d ? weight16(sc, z, col, d) : nullptr;
    });
    mma_tile(acc, a, b, 0, d, sm);
  }
  const float* bias = z == 0 ? p.bq : (z == 1 ? p.bk : p.bv);
  bf16* out = z == 0 ? sc.q : (z == 1 ? sc.k : sc.v);
  AVEC_FOR_ACC(nt, e) {
    int i, j;
    mma_tile_at(nt, e, i, j);
    const int row = row0 + i, col = col0 + j;
    if (row < n && col < d) {
      const size_t at = head_row(row, col / sh.dh, sh) * sc.ldh + col % sh.dh;
      if (z == 3)
        sc.dacc[at] = acc[nt][e];
      else
        out[at] = from_f<bf16>(rnd<bf16>(acc[nt][e]) + rnd<bf16>(bias[col]));
    }
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

// y = round(round(round(merged Wo^T) + bo) * mask) [+ x].
__global__ void __launch_bounds__(THREADS)
out_proj16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, Params p, Scratch16 sc,
                  Shape sh, int residual, Drop dr) {
  __shared__ __align__(16) bf16 sm[MMA_STAGE];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT, n = sh.n, d = sh.d;
  float acc[4][4] = {};
  auto a = rows_of<bf16>([&](int r) {
    const int row = row0 + r;
    return row < n ? sc.merged + (size_t)row * sc.ldd : nullptr;
  });
  auto b = rows_of<bf16>([&](int j) {
    const int col = col0 + j;
    return col < d ? weight16(sc, W_O, col, d) : nullptr;
  });
  mma_tile(acc, a, b, 0, d, sm);
  AVEC_FOR_ACC(nt, e) {
    int i, j;
    mma_tile_at(nt, e, i, j);
    const int row = row0 + i, col = col0 + j;
    if (row < n && col < d) {
      float val = rnd<bf16>(rnd<bf16>(acc[nt][e]) + rnd<bf16>(p.bo[col]));
      val = rnd<bf16>(val * drop_mult(dr, row / sh.t, row % sh.t, col, d));
      if (residual) val = rnd<bf16>(val + to_f(x[(size_t)row * d + col]));
      y[(size_t)row * d + col] = from_f<bf16>(val);
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
  sc->a12 = tb(bht * ldd);
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
  cudaError_t rc =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (rc != cudaSuccess) return rc;
  kern<<<dim3(cdiv(sh.t, QT), 1, sh.b * sh.heads), THREADS, L.total, st>>>(lengths, p, sc, sh,
                                                                           scale);
  return cudaGetLastError();
}

// The stages both directions share: the casts, LayerNorm (and round(g mask)),
// the projections (and dacc), the rel-pos projections, the attention stage.
cudaError_t run_core16(const bf16* x, const bf16* g, const bf16* tab, const int* lengths,
                       const Params& p, const Scratch16& sc, const Shape& sh, float eps,
                       float scale, Drop dr, cudaStream_t st) {
  const int nt = cdiv(sh.n, BT), dt = cdiv(sh.d, BT), bwd = g != nullptr;
  AVEC_LAUNCH(cast16_kernel, dim3(NW * sh.d + sh.t), p, tab, sc, sh);
  AVEC_LAUNCH(ln_h16_kernel, dim3(cdiv(sh.n, THREADS / 32)), x, g, p, sc, sh, eps, dr);
  AVEC_LAUNCH(qkv16_kernel, dim3(nt, dt, bwd ? 4 : 3), p, sc, sh);
  AVEC_LAUNCH(relpos16_kernel, dim3(cdiv(sh.t, BT), dt, sh.b * sh.heads), sc, sh);
  return launch_att16(bwd, lengths, p, sc, sh, scale, st);
}

cudaError_t run_fwd16(const void* x, const void* tab, const int* lengths, const Params& p,
                      void* y, void* scratch, const Shape& sh, float eps, float scale,
                      int residual, Drop dr, cudaStream_t st) {
  Scratch16 sc;
  carve16(static_cast<char*>(scratch), sh, false, &sc);
  const bf16* xt = static_cast<const bf16*>(x);
  const cudaError_t rc = run_core16(xt, nullptr, static_cast<const bf16*>(tab), lengths, p, sc,
                                    sh, eps, scale, dr, st);
  if (rc != cudaSuccess) return rc;
  AVEC_LAUNCH(out_proj16_kernel, dim3(cdiv(sh.n, BT), cdiv(sh.d, BT)), xt, static_cast<bf16*>(y),
              p, sc, sh, residual, dr);
  return cudaSuccess;
}

cudaError_t run_bwd16(const void* x, const void* g, const void* tab, const int* lengths,
                      const Params& p, void* dx, const Grads& gr, void* scratch, const Shape& sh,
                      float eps, float scale, int residual, Drop dr, cudaStream_t st) {
  Scratch16 sc;
  carve16(static_cast<char*>(scratch), sh, true, &sc);
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* gt = static_cast<const bf16*>(g);
  const cudaError_t rc = run_core16(xt, gt, static_cast<const bf16*>(tab), lengths, p, sc, sh,
                                    eps, scale, dr, st);
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
