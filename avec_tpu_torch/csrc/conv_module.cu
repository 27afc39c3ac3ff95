// Fused conformer convolution module, training mode, for Hopper (sm_90a).
//
// Replaces: avec_tpu/ops/pallas_conv_module.py `_stats_kernel` (:120,
// pallas_call at :342), `_fwd_kernel` (:145, at :358), `_bwd1_kernel` (:160,
// at :393) and `_bwd2_kernel` (:198, at :421), reached through
// `fused_conv_module_3d` (:479) from ConvolutionModule in training mode.
//
// Computes, for x (B, T, d) and the module's fp32 parameters (LayerNorm w, b;
// pw1 W1 (2E, d) with bias (2E,), whose rows [:E] and [E:] are the GLU halves
// a and b; depthwise taps w (E, k) and bias (E,); BN scale and bias (E,); pw2
// W2 (E', E) with bias (E',), all in the port's Conv (out, in) layout):
//     h = LN(x);  a = h W1a^T + b1a;  bg = h W1b^T + b1b;  z = a sigmoid(bg)
//     c = sum_j z[t + j - pad_lo] w[j] + b_dw     (zero outside [0, T))
//     stats:  s1 = sum_rows c,  s2 = sum_rows c^2          (all B T rows)
//     fwd:    cn = (c - mean) rstd bn_w + bn_b;  y = dropout(swish(cn) W2^T + b2)
//     bwd1:   gm = g mask;  dW2 = gm^T s;  db2 = sum gm;  gbn = (gm W2) swish'(cn)
//             r1 = sum gbn,  r2 = sum gbn chat
//     bwd2:   dc = bn_w rstd (gbn - r1/n - chat r2/n);  dz, dw (the transposed
//             stencil and the tap gradient);  GLU, pw1 and LayerNorm backward
//             down to dx, dln_w, dln_b, dW1, db1
// with the rounding points of the TPU kernel (ops/conv_module.py lists them).
// The batch statistics between stats and fwd, and r1 / n, r2 / n between bwd1
// and bwd2, are computed by the caller: those are the two global barriers of
// each direction, so each of the four passes is one C entry point here.
//
// What bounds it on the H100: operations. At (B, T, d = E = E', k) =
// (16, 151, 256, 256, 15) the forward is 4 n d E + 2 n E k + 2 n E E' = 0.97
// GFLOP (about 1 us at the bf16 tensor-core peak) on 2.5 MB of x and y; the
// backward about twice that. This first version runs every product as fp32
// FMAs on values rounded where the TPU kernel rounds them, for fp32 and bf16
// inputs alike, and is bound by the fp32 rate and by its tile staging.
//
// Design. The TPU kernel keeps one whole (T, d) sequence and all weights in
// VMEM; a Hopper block cannot (the two pw1 halves alone are 262 KB at d = 256
// in bf16), and a (B,) grid would leave 116 of 132 SMs idle. So each pass is
// a chain of stage kernels over (row tile x channel tile) grids that hand the
// LayerNorm statistics, z, c, swish(cn), dc and the rounded GLU cotangents to
// each other through one fp32 scratch buffer that the caller allocates and
// frees after the call. Every matrix product goes through `gemm_tile`
// (tile.cuh) with operand functors, so LayerNorm, rounding and the dropout
// mask fuse into the operand loads, and the biases, GLU, BN, swish and the
// BN backward into the epilogues; a pw1 block forms the "a" and "b" columns of
// the same 64 channels, so the GLU pairs meet in registers. The depthwise
// stages give a thread one channel and a run of rows; its taps read z (or dc)
// of the same sequence only, so the halo is zeros outside [0, T) and never
// the neighbouring sequence of the flat (B T) layout. Per-channel sums (s1,
// s2, r1, r2, db2, db1, dln_w, dln_b, the (E, k) tap gradient) and the weight
// gradients (dW2, dW1, split over 256-row chunks) are added with atomicAdd
// into fp32 buffers that the caller zeroed, so their last bits vary from run
// to run; y and dx have one owner per element and are deterministic. Stage
// kernels per pass: stats 3, fwd 4, bwd1 5, bwd2 8.

#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BT = GEMM_EDGE;           // output tile edge of the products
constexpr int THREADS = GEMM_THREADS;   // every stage: 256 threads
constexpr int SPLIT_ROWS = 256;         // token rows per block of a weight gradient
constexpr int DW_CH = 64;               // channels per block of a depthwise stage
constexpr int DW_LANES = THREADS / DW_CH;
constexpr int DW_ROWS = 64;             // token rows per block of a depthwise stage
constexpr int LN_ROWS = 32;             // token rows per block of the LayerNorm backward
constexpr int MAX_DIM = 384;
constexpr int KMAX = 31;
constexpr uint32_t SEED_STRIDE = 1103515245u;
constexpr uint32_t DRAW = 0x9E3779B9u;

enum Stage { STATS = 0, FWD = 1, BWD1 = 2, BWD2 = 3 };

struct Drop {
  uint32_t seed, thr;
  float inv_keep;
  int on;
};

struct Shape {
  int b, t, d, e, eo, k, pad_lo, n;  // n = b * t token rows
};

struct Params {
  const float *ln_w, *ln_b, *w1, *b1, *dw, *dwb, *bn_w, *bn_b, *w2, *b2;
};

struct Scratch {
  float *mean, *rstd;  // LayerNorm statistics (n)
  float *z;            // GLU output, rounded (n, E)
  float *a, *gate;     // GLU half a (rounded) and sigmoid(bg) (n, E): bwd2
  float *c;            // depthwise output + bias, rounded (n, E): bwd1, bwd2
  float *s;            // swish(cn), rounded (n, E): fwd, bwd1
  float *dc;           // BN input cotangent (n, E): bwd2
  float *dab;          // rounded da | dbg (n, 2E): bwd2
  float *dh;           // LayerNorm output cotangent (n, d): bwd2
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Multiplier (0 or 1/keep) of element (row, col) of the (n, E') output: one
// hash tile per sequence, as pallas_conv_module.py:72-87.
__device__ __forceinline__ float drop_mult(const Drop& dr, int row, int col, const Shape& sh) {
  if (!dr.on) return 1.f;
  const int b = row / sh.t, t = row - b * sh.t;
  const uint32_t base = dr.seed + (uint32_t)b * SEED_STRIDE;
  const uint32_t flat = (uint32_t)t * (uint32_t)sh.eo + (uint32_t)col;
  const uint32_t bits = mix32(flat ^ mix32(base + DRAW));
  return bits < dr.thr ? dr.inv_keep : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// LayerNorm output h[row][col], rounded as the TPU kernel rounds it.
template <typename T>
__device__ __forceinline__ float ln_h(const T* __restrict__ x, const Scratch& sc,
                                      const Params& p, int row, int col, int d) {
  const float xhat = rnd<T>((to_f(x[(size_t)row * d + col]) - sc.mean[row]) * sc.rstd[row]);
  return rnd<T>(rnd<T>(xhat * rnd<T>(p.ln_w[col])) + rnd<T>(p.ln_b[col]));
}

// g * dropout mask, in fp32.
template <typename T>
__device__ __forceinline__ float masked_g(const T* __restrict__ g, const Drop& dr, int row,
                                          int col, const Shape& sh) {
  return to_f(g[(size_t)row * sh.eo + col]) * drop_mult(dr, row, col, sh);
}

// BN apply with the batch statistics and the rounded result (cn).
template <typename T>
__device__ __forceinline__ float bn_cn(float chat, const Params& p, int ch) {
  return rnd<T>(chat * p.bn_w[ch] + p.bn_b[ch]);
}

// ---- the recomputed forward, shared by all four passes

// One warp per token row: mean and 1 / sqrt(var + eps) in fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_ln_stats_kernel(const T* __restrict__ x, Scratch sc, int n, int d, float eps) {
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
    sc.mean[row] = m;
    sc.rstd[row] = rsqrtf(var + eps);
  }
}

// z = round(round(h W1a^T + b1a) * sigmoid(round(h W1b^T + b1b))) for 64 rows
// and the same 64 channels of both halves; bwd2 also keeps a and the gate.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_pw1_kernel(const T* __restrict__ x, Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, d = sh.d, e = sh.e;
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? ln_h<T>(x, sc, p, row, k, d) : 0.f;
  };
  auto fwa = [&](int k, int j) {
    const int col = col0 + j;
    return col < e ? rnd<T>(p.w1[(size_t)col * d + k]) : 0.f;
  };
  auto fwb = [&](int k, int j) {
    const int col = col0 + j;
    return col < e ? rnd<T>(p.w1[(size_t)(e + col) * d + k]) : 0.f;
  };
  float acc_a[4][4] = {}, acc_b[4][4] = {};
  gemm_tile<true, true>(acc_a, fa, fwa, 0, d, sm);
  gemm_tile<true, true>(acc_b, fa, fwb, 0, d, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row >= n || col >= e) continue;
      const float a = rnd<T>(acc_a[i][j] + p.b1[col]);
      const float gate = sigmoid(rnd<T>(acc_b[i][j] + p.b1[e + col]));
      const size_t o = (size_t)row * e + col;
      sc.z[o] = rnd<T>(a * gate);
      if (sc.a != nullptr) {
        sc.a[o] = a;
        sc.gate[o] = gate;
      }
    }
}

// The depthwise conv, one thread per channel and a run of rows of one block:
// c = round(round(sum_j z[t + j - pad_lo] w[j]) + round(b_dw)). STATS adds the
// per-channel sums of c and c^2; FWD stores swish(cn); BWD1 stores c and
// swish(cn); BWD2 stores c.
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS)
conv_depthwise_kernel(Params p, Scratch sc, Shape sh, const float* __restrict__ mean,
               const float* __restrict__ rstd, float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float red[2][DW_LANES][DW_CH];
  const int cl = threadIdx.x % DW_CH, lane = threadIdx.x / DW_CH;
  const int ch = blockIdx.y * DW_CH + cl, row0 = blockIdx.x * DW_ROWS;
  const int e = sh.e, k = sh.k, t = sh.t;
  float sum = 0.f, sq = 0.f;
  if (ch < e) {
    const float* w = p.dw + (size_t)ch * k;
    const float bias = rnd<T>(p.dwb[ch]);
    for (int r = lane; r < DW_ROWS; r += DW_LANES) {
      const int row = row0 + r;
      if (row >= sh.n) break;
      const int tt = row % t;
      const float* zs = sc.z + (size_t)(row - tt) * e + ch;  // this sequence's z
      float c = 0.f;
      for (int j = 0; j < k; ++j) {
        const int ts = tt + j - sh.pad_lo;
        if (ts >= 0 && ts < t) c = fmaf(zs[(size_t)ts * e], w[j], c);
      }
      c = rnd<T>(rnd<T>(c) + bias);
      const size_t o = (size_t)row * e + ch;
      if (STAGE == STATS) {
        sum += c;
        sq += c * c;
      } else {
        if (STAGE != FWD) sc.c[o] = c;
        if (STAGE != BWD2) {
          const float cn = bn_cn<T>((c - mean[ch]) * rstd[ch], p, ch);
          sc.s[o] = rnd<T>(cn * sigmoid(cn));
        }
      }
    }
  }
  if (STAGE == STATS) {
    red[0][lane][cl] = sum;
    red[1][lane][cl] = sq;
    __syncthreads();
    if (lane == 0 && ch < e) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int l = 0; l < DW_LANES; ++l) {
        a += red[0][l][cl];
        b += red[1][l][cl];
      }
      atomicAdd(s1 + ch, a);
      atomicAdd(s2 + ch, b);
    }
  }
}

// y = round((s W2^T + b2) * mask) for 64 rows x 64 output channels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_pw2_kernel(Params p, Scratch sc, Shape sh, Drop dr, T* __restrict__ y) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, e = sh.e, eo = sh.eo;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? sc.s[(size_t)row * e + k] : 0.f;
  };
  auto fb = [&](int k, int j) {
    const int col = col0 + j;
    return col < eo ? rnd<T>(p.w2[(size_t)col * e + k]) : 0.f;
  };
  gemm_tile<true, true>(acc, fa, fb, 0, e, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < eo)
        y[(size_t)row * eo + col] =
            from_f<T>((acc[i][j] + p.b2[col]) * drop_mult(dr, row, col, sh));
    }
}

// ---- backward stages

// dW2[o][c] += sum over a 256-row chunk of round(g m)[row][o] s[row][c]; the
// blocks of the first channel tile also add db2[o] += sum g m.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_grad_w2_kernel(const T* __restrict__ g, Scratch sc, Shape sh, Drop dr,
                    float* __restrict__ dw2, float* __restrict__ db2) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int o0 = blockIdx.x * BT, c0 = blockIdx.y * BT;
  const int r0 = blockIdx.z * SPLIT_ROWS, r1 = min(sh.n, r0 + SPLIT_ROWS);
  const int e = sh.e, eo = sh.eo;
  float acc[4][4] = {};
  auto fa = [&](int i, int row) {
    const int o = o0 + i;
    return o < eo ? rnd<T>(masked_g(g, dr, row, o, sh)) : 0.f;
  };
  auto fb = [&](int row, int j) {
    const int c = c0 + j;
    return c < e ? sc.s[(size_t)row * e + c] : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, r0, r1, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (o < eo && c < e) atomicAdd(dw2 + (size_t)o * e + c, acc[i][j]);
    }
  if (blockIdx.y == 0 && threadIdx.x < BT && o0 + threadIdx.x < eo) {
    float sum = 0.f;
    for (int row = r0; row < r1; ++row) sum += masked_g(g, dr, row, o0 + threadIdx.x, sh);
    atomicAdd(db2 + o0 + threadIdx.x, sum);
  }
}

// gbn = (round(g m) round(W2)) swish'(cn) for 64 rows x 64 channels. BWD1 adds
// r1 = sum gbn and r2 = sum gbn chat; BWD2 stores dc = bn_w rstd (gbn - rn1 -
// chat rn2).
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS)
conv_grad_bn_kernel(const T* __restrict__ g, Params p, Scratch sc, Shape sh, Drop dr,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               const float* __restrict__ rn1, const float* __restrict__ rn2,
               float* __restrict__ r1, float* __restrict__ r2) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  __shared__ float red[2][16][BT];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, e = sh.e, eo = sh.eo;
  float acc[4][4] = {};
  auto fa = [&](int i, int o) {
    const int row = row0 + i;
    return row < n ? rnd<T>(masked_g(g, dr, row, o, sh)) : 0.f;
  };
  auto fb = [&](int o, int j) {
    const int col = col0 + j;
    return col < e ? rnd<T>(p.w2[(size_t)o * e + col]) : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, eo, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float p1[4] = {}, p2[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row >= n || col >= e) continue;
      const size_t o = (size_t)row * e + col;
      const float rs = rstd[col];
      const float chat = (sc.c[o] - mean[col]) * rs;
      const float cn = bn_cn<T>(chat, p, col);
      const float sig = sigmoid(cn);
      const float gbn = acc[i][j] * (sig + cn * sig * (1.f - sig));
      if (STAGE == BWD1) {
        p1[j] += gbn;
        p2[j] += gbn * chat;
      } else {
        sc.dc[o] = p.bn_w[col] * rs * (gbn - rn1[col] - chat * rn2[col]);
      }
    }
  if (STAGE == BWD1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = p1[j];
      red[1][ty][tx * 4 + j] = p2[j];
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c < BT && col0 + c < e) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) {
        a += red[0][y][c];
        b += red[1][y][c];
      }
      atomicAdd(r1 + col0 + c, a);
      atomicAdd(r2 + col0 + c, b);
    }
  }
}

// The depthwise backward, one thread per channel and a run of rows:
// dz[t] = sum_j w[j] dc[t + pad_lo - j] (the transposed stencil, zero outside
// the sequence), da = dz gate, dbg = dz a gate (1 - gate), stored rounded for
// the pw1 products; db1 = sums of da and dbg; the tap gradient
// dw[j] += sum_rows z[t + j - pad_lo] dc[t].
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_depthwise_bwd_kernel(Params p, Scratch sc, Shape sh, float* __restrict__ db1,
                   float* __restrict__ ddw) {
  __shared__ float red[2][DW_LANES][DW_CH];
  const int cl = threadIdx.x % DW_CH, lane = threadIdx.x / DW_CH;
  const int ch = blockIdx.y * DW_CH + cl, row0 = blockIdx.x * DW_ROWS;
  const int e = sh.e, k = sh.k, t = sh.t;
  float tap[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) tap[j] = 0.f;
  float sum_a = 0.f, sum_b = 0.f;
  if (ch < e) {
    const float* w = p.dw + (size_t)ch * k;
    for (int r = lane; r < DW_ROWS; r += DW_LANES) {
      const int row = row0 + r;
      if (row >= sh.n) break;
      const int tt = row % t;
      const size_t seq = (size_t)(row - tt) * e + ch;  // this sequence's (0, ch)
      const size_t o = (size_t)row * e + ch;
      const float dcv = sc.dc[o];
      float dz = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j >= k) break;
        const int tz = tt + j - sh.pad_lo;   // z feeding output row tt through tap j
        if (tz >= 0 && tz < t) tap[j] = fmaf(sc.z[seq + (size_t)tz * e], dcv, tap[j]);
        const int tc = tt + sh.pad_lo - j;   // output row that z[tt] feeds through tap j
        if (tc >= 0 && tc < t) dz = fmaf(sc.dc[seq + (size_t)tc * e], w[j], dz);
      }
      const float gate = sc.gate[o];
      const float da = dz * gate;
      const float dbg = dz * sc.a[o] * gate * (1.f - gate);
      sum_a += da;
      sum_b += dbg;
      const size_t o2 = (size_t)row * 2 * e + ch;
      sc.dab[o2] = rnd<T>(da);
      sc.dab[o2 + e] = rnd<T>(dbg);
    }
  }
  red[0][lane][cl] = sum_a;
  red[1][lane][cl] = sum_b;
  __syncthreads();
  if (lane == 0 && ch < e) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int l = 0; l < DW_LANES; ++l) {
      a += red[0][l][cl];
      b += red[1][l][cl];
    }
    atomicAdd(db1 + ch, a);
    atomicAdd(db1 + e + ch, b);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= k) break;  // uniform over the block
    __syncthreads();
    red[0][lane][cl] = tap[j];
    __syncthreads();
    if (lane == 0 && ch < e) {
      float a = 0.f;
#pragma unroll
      for (int l = 0; l < DW_LANES; ++l) a += red[0][l][cl];
      atomicAdd(ddw + (size_t)ch * k + j, a);
    }
  }
}

// dW1[f][c] += sum over a 256-row chunk of dab[row][f] h[row][c] (f < 2E).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_grad_w1_kernel(const T* __restrict__ x, Params p, Scratch sc, Shape sh,
                float* __restrict__ dw1) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int f0 = blockIdx.x * BT, c0 = blockIdx.y * BT;
  const int r0 = blockIdx.z * SPLIT_ROWS, r1 = min(sh.n, r0 + SPLIT_ROWS);
  const int d = sh.d, e2 = 2 * sh.e;
  float acc[4][4] = {};
  auto fa = [&](int i, int row) {
    const int f = f0 + i;
    return f < e2 ? sc.dab[(size_t)row * e2 + f] : 0.f;
  };
  auto fb = [&](int row, int j) {
    const int c = c0 + j;
    return c < d ? ln_h<T>(x, sc, p, row, c, d) : 0.f;
  };
  gemm_tile<false, false>(acc, fa, fb, r0, r1, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + ty * 4 + i, c = c0 + tx * 4 + j;
      if (f < e2 && c < d) atomicAdd(dw1 + (size_t)f * d + c, acc[i][j]);
    }
}

// dh = dab round(W1) for 64 rows x 64 input channels (reduction over 2E).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_grad_h_kernel(Params p, Scratch sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, d = sh.d, e2 = 2 * sh.e;
  float acc[4][4] = {};
  auto fa = [&](int i, int f) {
    const int row = row0 + i;
    return row < n ? sc.dab[(size_t)row * e2 + f] : 0.f;
  };
  auto fb = [&](int f, int j) {
    const int col = col0 + j;
    return col < d ? rnd<T>(p.w1[(size_t)f * d + col]) : 0.f;
  };
  gemm_tile<true, false>(acc, fa, fb, 0, e2, sm);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + ty * 4 + i, col = col0 + tx * 4 + j;
      if (row < n && col < d) sc.dh[(size_t)row * d + col] = acc[i][j];
    }
}

// LayerNorm backward (pallas_conv_module.py:275-280) with the unrounded xhat
// and the fp32 ln_w, one warp per row; dln_w and dln_b are summed per block in
// shared memory first.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_ln_bwd_kernel(const T* __restrict__ x, Params p, Scratch sc, Shape sh, T* __restrict__ dx,
                   float* __restrict__ dln_w, float* __restrict__ dln_b) {
  __shared__ float sw[MAX_DIM], sb[MAX_DIM];
  const int d = sh.d, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < d; c += THREADS) sw[c] = sb[c] = 0.f;
  __syncthreads();
  for (int r = warp; r < LN_ROWS; r += THREADS / 32) {
    const int row = blockIdx.x * LN_ROWS + r;
    if (row >= sh.n) break;  // uniform over the warp
    const float mean = sc.mean[row], rstd = sc.rstd[row];
    const T* xr = x + (size_t)row * d;
    const float* dh = sc.dh + (size_t)row * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      const float dxh = dh[c] * p.ln_w[c];
      s1 += dxh;
      s2 += dxh * xhat;
      atomicAdd(sw + c, dh[c] * xhat);
      atomicAdd(sb + c, dh[c]);
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      const float dxh = dh[c] * p.ln_w[c];
      dx[(size_t)row * d + c] = from_f<T>(rstd * (dxh - m1 - xhat * m2));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    atomicAdd(dln_w + c, sw[c]);
    atomicAdd(dln_b + c, sb[c]);
  }
}

// ---- host side

int cdiv(int a, int b) { return (a + b - 1) / b; }

long long scratch_floats(long long n, long long d, long long e, int stage) {
  const long long ne = n * e;
  long long total = 2 * n + ne;             // mean, rstd, z
  if (stage == FWD) total += ne;            // s
  if (stage == BWD1) total += 2 * ne;       // c, s
  if (stage == BWD2) total += 6 * ne + n * d;  // a, gate, c, dc, dab (2), dh
  return total;
}

Scratch carve(float* base, const Shape& sh, int stage) {
  const size_t n = sh.n, ne = n * sh.e;
  Scratch sc{};
  float* p = base;
  auto take = [&](size_t count) {
    float* q = p;
    p += count;
    return q;
  };
  sc.mean = take(n);
  sc.rstd = take(n);
  sc.z = take(ne);
  if (stage == BWD2) {
    sc.a = take(ne);
    sc.gate = take(ne);
    sc.dc = take(ne);
    sc.dab = take(2 * ne);
    sc.dh = take(n * sh.d);
  }
  if (stage == BWD1 || stage == BWD2) sc.c = take(ne);
  if (stage == FWD || stage == BWD1) sc.s = take(ne);
  return sc;
}

#define LAUNCH_CHECK()                          \
  do {                                          \
    const cudaError_t rc_ = cudaGetLastError(); \
    if (rc_ != cudaSuccess) return rc_;         \
  } while (0)

template <typename T>
cudaError_t pre_bn(const T* x, const Params& p, const Scratch& sc, const Shape& sh, float eps,
                   cudaStream_t st) {
  conv_ln_stats_kernel<T><<<cdiv(sh.n, THREADS / 32), THREADS, 0, st>>>(x, sc, sh.n, sh.d, eps);
  LAUNCH_CHECK();
  conv_pw1_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.e, BT)), THREADS, 0, st>>>(x, p, sc, sh);
  LAUNCH_CHECK();
  return cudaSuccess;
}

dim3 dw_grid(const Shape& sh) { return dim3(cdiv(sh.n, DW_ROWS), cdiv(sh.e, DW_CH)); }

template <typename T>
cudaError_t run_stats(const T* x, const Params& p, float* s1, float* s2, const Scratch& sc,
                      const Shape& sh, float eps, cudaStream_t st) {
  cudaError_t rc = pre_bn<T>(x, p, sc, sh, eps, st);
  if (rc != cudaSuccess) return rc;
  conv_depthwise_kernel<T, STATS><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, nullptr,
                                                                    nullptr, s1, s2);
  LAUNCH_CHECK();
  return cudaSuccess;
}

template <typename T>
cudaError_t run_fwd(const T* x, const Params& p, const float* mean, const float* rstd, T* y,
                    const Scratch& sc, const Shape& sh, float eps, Drop dr, cudaStream_t st) {
  cudaError_t rc = pre_bn<T>(x, p, sc, sh, eps, st);
  if (rc != cudaSuccess) return rc;
  conv_depthwise_kernel<T, FWD><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, mean, rstd,
                                                                  nullptr, nullptr);
  LAUNCH_CHECK();
  conv_pw2_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.eo, BT)), THREADS, 0, st>>>(p, sc, sh, dr, y);
  LAUNCH_CHECK();
  return cudaSuccess;
}

template <typename T>
cudaError_t run_bwd1(const T* x, const T* g, const Params& p, const float* mean,
                     const float* rstd, float* dw2, float* db2, float* r1, float* r2,
                     const Scratch& sc, const Shape& sh, float eps, Drop dr, cudaStream_t st) {
  cudaError_t rc = pre_bn<T>(x, p, sc, sh, eps, st);
  if (rc != cudaSuccess) return rc;
  conv_depthwise_kernel<T, BWD1><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, mean, rstd,
                                                                   nullptr, nullptr);
  LAUNCH_CHECK();
  const dim3 w2_grid(cdiv(sh.eo, BT), cdiv(sh.e, BT), cdiv(sh.n, SPLIT_ROWS));
  conv_grad_w2_kernel<T><<<w2_grid, THREADS, 0, st>>>(g, sc, sh, dr, dw2, db2);
  LAUNCH_CHECK();
  conv_grad_bn_kernel<T, BWD1><<<dim3(cdiv(sh.n, BT), cdiv(sh.e, BT)), THREADS, 0, st>>>(
      g, p, sc, sh, dr, mean, rstd, nullptr, nullptr, r1, r2);
  LAUNCH_CHECK();
  return cudaSuccess;
}

struct Grads {
  float *ln_w, *ln_b, *w1, *b1, *dw;
};

template <typename T>
cudaError_t run_bwd2(const T* x, const T* g, const Params& p, const float* mean,
                     const float* rstd, const float* rn1, const float* rn2, T* dx,
                     const Grads& gr, const Scratch& sc, const Shape& sh, float eps, Drop dr,
                     cudaStream_t st) {
  cudaError_t rc = pre_bn<T>(x, p, sc, sh, eps, st);
  if (rc != cudaSuccess) return rc;
  conv_depthwise_kernel<T, BWD2><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, mean, rstd,
                                                                   nullptr, nullptr);
  LAUNCH_CHECK();
  conv_grad_bn_kernel<T, BWD2><<<dim3(cdiv(sh.n, BT), cdiv(sh.e, BT)), THREADS, 0, st>>>(
      g, p, sc, sh, dr, mean, rstd, rn1, rn2, nullptr, nullptr);
  LAUNCH_CHECK();
  conv_depthwise_bwd_kernel<T><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, gr.b1, gr.dw);
  LAUNCH_CHECK();
  const dim3 w1_grid(cdiv(2 * sh.e, BT), cdiv(sh.d, BT), cdiv(sh.n, SPLIT_ROWS));
  conv_grad_w1_kernel<T><<<w1_grid, THREADS, 0, st>>>(x, p, sc, sh, gr.w1);
  LAUNCH_CHECK();
  conv_grad_h_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.d, BT)), THREADS, 0, st>>>(p, sc, sh);
  LAUNCH_CHECK();
  conv_ln_bwd_kernel<T><<<cdiv(sh.n, LN_ROWS), THREADS, 0, st>>>(x, p, sc, sh, dx, gr.ln_w,
                                                                  gr.ln_b);
  LAUNCH_CHECK();
  return cudaSuccess;
}

bool shape_ok(int b, int t, int d, int e, int eo, int k, int pad_lo) {
  return b > 0 && t > 0 && d > 0 && e > 0 && eo > 0 && d <= MAX_DIM && e <= MAX_DIM &&
         eo <= MAX_DIM && k > 0 && k <= KMAX && pad_lo >= 0 && pad_lo < k &&
         (long long)b * t < (1LL << 24);
}

Params unpack(const void* const* ptrs) {
  auto f = [&](int i) { return static_cast<const float*>(ptrs[i]); };
  return Params{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9)};
}

}  // namespace

// Number of fp32 scratch elements pass `stage` (0 stats, 1 fwd, 2 bwd1,
// 3 bwd2) needs at these widths.
extern "C" long long avec_conv_scratch_floats(int b, int t, int d, int e, int eo, int stage) {
  (void)eo;
  return scratch_floats((long long)b * t, d, e, stage);
}

// Every entry point takes x (B, T, d) in fp32 or bf16 (is_bf16), the ten fp32
// parameters as an array of pointers in the order ln_w, ln_b, pw1 (2E, d),
// pw1_b, depthwise (E, k), its bias, bn_w, bn_b, pw2 (E', E), pw2_b, an fp32
// scratch buffer of avec_conv_scratch_floats(...) elements, the shape, the
// LayerNorm eps, the dropout arguments (on when use_drop != 0: keep iff the
// hash bits < thr, multiplier inv_keep) and the stream; it returns the
// launches' cudaError_t. Output sums are fp32 buffers that the caller zeroed
// on the same stream (the kernels add into them).
#define CONV_TAIL                                                                        \
  int b, int t, int d, int e, int eo, int k, int pad_lo, float eps, int use_drop,        \
      unsigned seed, unsigned thr, float inv_keep, int is_bf16, void* stream

#define CONV_SETUP(stage)                                                    \
  if (!shape_ok(b, t, d, e, eo, k, pad_lo)) return cudaErrorInvalidValue;    \
  const Shape sh{b, t, d, e, eo, k, pad_lo, b * t};                          \
  const Params p = unpack(params);                                           \
  const Scratch sc = carve(static_cast<float*>(scratch), sh, stage);         \
  const Drop dr{seed, thr, inv_keep, use_drop};                              \
  (void)dr;                                                                  \
  cudaStream_t st = static_cast<cudaStream_t>(stream);

// K3-stats: s1, s2 (E,) += per-channel sums of c and c^2 over all B T rows.
extern "C" int avec_conv_stats(const void* x, const void* const* params, void* s1, void* s2,
                               void* scratch, CONV_TAIL) {
  CONV_SETUP(STATS)
  float *a = static_cast<float*>(s1), *q = static_cast<float*>(s2);
  if (is_bf16) return run_stats<bf16>(static_cast<const bf16*>(x), p, a, q, sc, sh, eps, st);
  return run_stats<float>(static_cast<const float*>(x), p, a, q, sc, sh, eps, st);
}

// K3-fwd: y (B, T, E') in x's dtype from the batch mean and rstd (E,).
extern "C" int avec_conv_fwd(const void* x, const void* const* params, const void* mean,
                             const void* rstd, void* y, void* scratch, CONV_TAIL) {
  CONV_SETUP(FWD)
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  if (is_bf16)
    return run_fwd<bf16>(static_cast<const bf16*>(x), p, m, r, static_cast<bf16*>(y), sc, sh, eps,
                         dr, st);
  return run_fwd<float>(static_cast<const float*>(x), p, m, r, static_cast<float*>(y), sc, sh,
                        eps, dr, st);
}

// K3b-1: dW2 (E', E), db2 (E'), r1, r2 (E) += from the cotangent g (B, T, E').
extern "C" int avec_conv_bwd1(const void* x, const void* g, const void* const* params,
                              const void* mean, const void* rstd, void* dw2, void* db2, void* r1,
                              void* r2, void* scratch, CONV_TAIL) {
  CONV_SETUP(BWD1)
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  auto f = [](void* v) { return static_cast<float*>(v); };
  if (is_bf16)
    return run_bwd1<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(g), p, m, r,
                          f(dw2), f(db2), f(r1), f(r2), sc, sh, eps, dr, st);
  return run_bwd1<float>(static_cast<const float*>(x), static_cast<const float*>(g), p, m, r,
                         f(dw2), f(db2), f(r1), f(r2), sc, sh, eps, dr, st);
}

// K3b-2: dx (B, T, d) in x's dtype, and += the gradients of ln_w, ln_b,
// pw1 (2E, d), pw1_b (2E) and the depthwise taps (E, k), given as an array of
// five pointers in that order, from rn1 = r1 / n and rn2 = r2 / n.
extern "C" int avec_conv_bwd2(const void* x, const void* g, const void* const* params,
                              const void* mean, const void* rstd, const void* rn1,
                              const void* rn2, void* dx, void* const* grads, void* scratch,
                              CONV_TAIL) {
  CONV_SETUP(BWD2)
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  const float *q1 = static_cast<const float*>(rn1), *q2 = static_cast<const float*>(rn2);
  auto f = [&](int i) { return static_cast<float*>(grads[i]); };
  const Grads gr{f(0), f(1), f(2), f(3), f(4)};
  if (is_bf16)
    return run_bwd2<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(g), p, m, r, q1,
                          q2, static_cast<bf16*>(dx), gr, sc, sh, eps, dr, st);
  return run_bwd2<float>(static_cast<const float*>(x), static_cast<const float*>(g), p, m, r, q1,
                         q2, static_cast<float*>(dx), gr, sc, sh, eps, dr, st);
}
