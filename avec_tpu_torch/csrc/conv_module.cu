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
// second backward pass about twice that (dW1 and dh over both GLU halves,
// plus the recomputed pw1), on x, g, dx and the parameters (a few MB).
//
// Design. The TPU kernel keeps one whole (T, d) sequence and all weights in
// VMEM; a Hopper block cannot (the two pw1 halves alone are 262 KB at d = 256
// in bf16), and a (B,) grid would leave 116 of 132 SMs idle. So each pass is
// a chain of stage kernels over (row tile x channel tile) grids that hand
// each other the LayerNorm statistics and the module's intermediates through
// one scratch buffer that the caller allocates and frees after the call. The
// intermediates the TPU kernel rounds to x's dtype (h, z, a, bg, c, s, the
// GLU cotangents dab) are stored in that dtype, which loses nothing; dc and dh
// stay fp32. The depthwise stages give a thread one channel and a run of rows;
// their taps read z (or dc) of the same sequence only, so the halo is zeros
// outside [0, T) and never the neighbouring sequence of the flat (B T)
// layout, whatever sequences a row tile straddles.
//
// bf16 (the training path): the matrix products of the shared recompute
// (pw1, both GLU halves) and of the second backward pass (ds = bf16(g m) W2,
// dW1 = dab^T h, dh = dab W1) run on the tensor cores as `wgmma` on 64-row
// warpgroup tiles, fed by TMA from K-major bf16 copies (hopper.cuh): the
// weights are cast to bf16 once per call (rows padded to 8 elements so that
// TMA addresses d = 180), and the stages write h, dab and their transposes
// (the products over the token rows read h^T and dab^T) in bf16. Those
// stages read their rounding points in the epilogues (bias, GLU, BN and its
// backward, in the accumulator's fragment layout). The second backward pass
// uses no atomics: dW1 is one-owner 64 x 64 tiles over row splits, and db1,
// the (E, k) tap gradient and the LayerNorm gradients are per-block partial
// sums that a last stage adds in a fixed order, once, into the caller's
// zeroed buffers, so two calls give the same bits. Stage kernels: stats 4,
// fwd 5, bwd1 6 (cast, LayerNorm, tensor-core pw1, then their fp32-FMA
// stages: the depthwise conv, pw2, the BN reductions and dW2 with atomics),
// bwd2 9 (cast, LayerNorm with g m, pw1, depthwise, ds with dc, depthwise
// backward with the GLU backward, dW1 and dh in one launch, LayerNorm
// backward, reduce).
//
// What still bounds it in bf16: the stage chain and the two depthwise
// stages, not the products. At (16, 151, 256, 256, 15) the second backward
// pass takes about 124 us of device time on the H100 (`chip_smoke.py`),
// of which the depthwise stencil and its transpose 25 and 31 us, each of the
// three product stages 11-13 us (1-2 us of tensor-core work), the rest
// LayerNorm, cast, LayerNorm backward and reduce at 5-10 us: about 100x the
// bytes of its inputs and outputs at the card's memory rate.
//
// fp32 inputs (the verification path) keep the first design: every product
// as fp32 FMAs through `gemm_tile` (tile.cuh) with operand functors, so
// LayerNorm, rounding and the dropout mask fuse into the operand loads, and
// per-channel sums and weight gradients added with atomicAdd into zeroed
// fp32 buffers, so their last bits vary from run to run; y and dx have one
// owner per element. Stage kernels: stats 3, fwd 4, bwd1 5, bwd2 8.

#include "hopper.cuh"
#include "tile.cuh"

#include <type_traits>

namespace {

using namespace avec;

constexpr int BT = GEMM_EDGE;           // output tile edge of the products
constexpr int THREADS = GEMM_THREADS;   // every FMA and elementwise stage: 256 threads
constexpr int SPLIT_ROWS = 256;         // token rows per block of an fp32 weight gradient
constexpr int DW_CH = 64;               // channels per block of a depthwise stage
constexpr int DW_LANES = THREADS / DW_CH;
constexpr int DW_ROWS = 64;             // token rows per block of a depthwise stage
constexpr int DWB_ROWS = 16;            // the same for the bf16 depthwise backward
constexpr int LN_ROWS = 32;             // token rows per block of the fp32 LayerNorm backward
constexpr int LNB_ROWS = 16;            // token rows per block of the bf16 LayerNorm backward
constexpr int PREP_ROWS = 8;            // token rows per block of the bf16 LayerNorm stage
constexpr int WG = 128;                 // one warpgroup
constexpr int PW_RING = 3;              // ring stages of the pw1 product ({h, W1a, W1b})
constexpr int DS_RING = 4;              // ring stages of the ds product ({g m, W2^T})
constexpr int WAVE_BLOCKS = 264;        // two blocks on each of the 132 SMs
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

// One pass's scratch. T is x's dtype: every intermediate the TPU kernel
// rounds to it is stored in it (exactly).
template <typename T>
struct Scratch {
  float *mean, *rstd;         // LayerNorm statistics (n)
  T* z;                       // GLU output (n, E)
  T *a, *bg;                  // GLU half a and the gate's input bg (n, E): bwd2
  T* c;                       // depthwise output + bias (n, E): bwd1, bwd2
  T* s;                       // swish(cn) (n, E): fwd, bwd1
  float* dc;                  // BN input cotangent (n, E): bwd2
  T* dab;                     // da | dbg (n, ld_dab): bwd2
  float* dh;                  // LayerNorm output cotangent (n, d): bwd2
  // bf16 only: tensor-core operands and partial sums
  bf16 *w1b, *h;              // pw1 (2E, ldd), LayerNorm output (n, ldd)
  bf16 *w1t, *w2t;            // pw1^T (d, ld2e), pw2^T (E, ldeo): bwd2
  bf16 *ht, *gm, *dabt;       // h^T (d, ldn), bf16(g m) (n, ldeo), dab^T (2E, ldn): bwd2
  float *part_db1, *part_tap; // (rt_dw, 2E), (rt_dw, E k): bwd2
  float *part_lnb, *part_lnw; // (rt_ln, d) each: bwd2
  float* part_w1;             // (splits, 2E, d): bwd2
  int ld_dab, ldd, ld2e, ldeo, ldn, rt_dw, rt_ln, splits;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

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

// LayerNorm output h[row][col] from the row's statistics, rounded as the TPU
// kernel rounds it.
template <typename T>
__device__ __forceinline__ float ln_h_of(float xv, float mean, float rstd, const Params& p,
                                         int col) {
  const float xhat = rnd<T>((xv - mean) * rstd);
  return rnd<T>(rnd<T>(xhat * rnd<T>(p.ln_w[col])) + rnd<T>(p.ln_b[col]));
}

template <typename T>
__device__ __forceinline__ float ln_h(const T* __restrict__ x, const Scratch<T>& sc,
                                      const Params& p, int row, int col, int d) {
  return ln_h_of<T>(to_f(x[(size_t)row * d + col]), sc.mean[row], sc.rstd[row], p, col);
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

// Row statistics of LayerNorm in fp32, one warp: the lanes stride over the
// row, then a fixed shuffle tree.
template <typename T>
__device__ __forceinline__ void ln_stats_warp(const T* __restrict__ xr, int d, float eps,
                                              float* mean, float* rstd) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
  const float m = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float dv = to_f(xr[c]) - m;
    sq += dv * dv;
  }
  *mean = m;
  *rstd = rsqrtf(warp_sum(sq) / d + eps);
}

// ---- the recomputed forward, shared by all four passes

// fp32: one warp per token row, mean and 1 / sqrt(var + eps).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_ln_stats_kernel(const T* __restrict__ x, Scratch<T> sc, int n, int d, float eps) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= n) return;  // uniform over the warp
  float m, r;
  ln_stats_warp(x + (size_t)row * d, d, eps, &m, &r);
  if (threadIdx.x % 32 == 0) {
    sc.mean[row] = m;
    sc.rstd[row] = r;
  }
}

// fp32: z = round(round(h W1a^T + b1a) * sigmoid(round(h W1b^T + b1b))) for
// 64 rows and the same 64 channels of both halves as FMAs; bwd2 also keeps a
// and bg.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_pw1_kernel(const T* __restrict__ x, Params p, Scratch<T> sc, Shape sh) {
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
      const float bg = rnd<T>(acc_b[i][j] + p.b1[e + col]);
      const size_t o = (size_t)row * e + col;
      sc.z[o] = from_f<T>(a * sigmoid(bg));
      if (sc.a != nullptr) {
        sc.a[o] = from_f<T>(a);
        sc.bg[o] = from_f<T>(bg);
      }
    }
}

// The depthwise conv, one thread per channel and a run of rows of one block:
// c = round(round(sum_j z[t + j - pad_lo] w[j]) + round(b_dw)). STATS adds the
// per-channel sums of c and c^2; FWD stores swish(cn); BWD1 stores c and
// swish(cn); BWD2 stores c.
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS)
conv_depthwise_kernel(Params p, Scratch<T> sc, Shape sh, const float* __restrict__ mean,
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
      const T* zs = sc.z + (size_t)(row - tt) * e + ch;  // this sequence's z
      float c = 0.f;
      for (int j = 0; j < k; ++j) {
        const int ts = tt + j - sh.pad_lo;
        if (ts >= 0 && ts < t) c = fmaf(to_f(zs[(size_t)ts * e]), w[j], c);
      }
      c = rnd<T>(rnd<T>(c) + bias);
      const size_t o = (size_t)row * e + ch;
      if (STAGE == STATS) {
        sum += c;
        sq += c * c;
      } else {
        if (STAGE != FWD) sc.c[o] = from_f<T>(c);
        if (STAGE != BWD2) {
          const float cn = bn_cn<T>((c - mean[ch]) * rstd[ch], p, ch);
          sc.s[o] = from_f<T>(cn * sigmoid(cn));
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
conv_pw2_kernel(Params p, Scratch<T> sc, Shape sh, Drop dr, T* __restrict__ y) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, e = sh.e, eo = sh.eo;
  float acc[4][4] = {};
  auto fa = [&](int i, int k) {
    const int row = row0 + i;
    return row < n ? to_f(sc.s[(size_t)row * e + k]) : 0.f;
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
conv_grad_w2_kernel(const T* __restrict__ g, Scratch<T> sc, Shape sh, Drop dr,
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
    return c < e ? to_f(sc.s[(size_t)row * e + c]) : 0.f;
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

// gbn = (round(g m) round(W2)) swish'(cn) for 64 rows x 64 channels as FMAs.
// BWD1 adds r1 = sum gbn and r2 = sum gbn chat; BWD2 (fp32) stores dc =
// bn_w rstd (gbn - rn1 - chat rn2).
template <typename T, int STAGE>
__global__ void __launch_bounds__(THREADS)
conv_grad_bn_kernel(const T* __restrict__ g, Params p, Scratch<T> sc, Shape sh, Drop dr,
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
      const float chat = (to_f(sc.c[o]) - mean[col]) * rs;
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

// fp32: the depthwise backward, one thread per channel and a run of rows:
// dz[t] = sum_j w[j] dc[t + pad_lo - j] (the transposed stencil, zero outside
// the sequence), da = dz gate, dbg = dz a gate (1 - gate) with gate =
// sigmoid(bg), stored for the pw1 products; db1 = sums of da and dbg; the tap
// gradient dw[j] += sum_rows z[t + j - pad_lo] dc[t], added with atomics.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_depthwise_bwd_kernel(Params p, Scratch<T> sc, Shape sh, float* __restrict__ db1,
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
        if (tz >= 0 && tz < t) tap[j] = fmaf(to_f(sc.z[seq + (size_t)tz * e]), dcv, tap[j]);
        const int tc = tt + sh.pad_lo - j;   // output row that z[tt] feeds through tap j
        if (tc >= 0 && tc < t) dz = fmaf(sc.dc[seq + (size_t)tc * e], w[j], dz);
      }
      const float gate = sigmoid(to_f(sc.bg[o]));
      const float da = dz * gate;
      const float dbg = dz * to_f(sc.a[o]) * gate * (1.f - gate);
      sum_a += da;
      sum_b += dbg;
      const size_t o2 = (size_t)row * sc.ld_dab + ch;
      sc.dab[o2] = from_f<T>(da);
      sc.dab[o2 + e] = from_f<T>(dbg);
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

// fp32: dW1[f][c] += sum over a 256-row chunk of dab[row][f] h[row][c]
// (f < 2E).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_grad_w1_kernel(const T* __restrict__ x, Params p, Scratch<T> sc, Shape sh,
                float* __restrict__ dw1) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int f0 = blockIdx.x * BT, c0 = blockIdx.y * BT;
  const int r0 = blockIdx.z * SPLIT_ROWS, r1 = min(sh.n, r0 + SPLIT_ROWS);
  const int d = sh.d, e2 = 2 * sh.e;
  float acc[4][4] = {};
  auto fa = [&](int i, int row) {
    const int f = f0 + i;
    return f < e2 ? to_f(sc.dab[(size_t)row * sc.ld_dab + f]) : 0.f;
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

// fp32: dh = dab round(W1) for 64 rows x 64 input channels (reduction over
// 2E).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_grad_h_kernel(Params p, Scratch<T> sc, Shape sh) {
  __shared__ __align__(16) float sm[2 * GEMM_BK * TS];
  const int row0 = blockIdx.x * BT, col0 = blockIdx.y * BT;
  const int n = sh.n, d = sh.d, e2 = 2 * sh.e;
  float acc[4][4] = {};
  auto fa = [&](int i, int f) {
    const int row = row0 + i;
    return row < n ? to_f(sc.dab[(size_t)row * sc.ld_dab + f]) : 0.f;
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

// fp32: LayerNorm backward (pallas_conv_module.py:275-280) with the
// unrounded xhat and the fp32 ln_w, one warp per row; dln_w and dln_b are
// summed per block in shared memory first.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_ln_bwd_kernel(const T* __restrict__ x, Params p, Scratch<T> sc, Shape sh, T* __restrict__ dx,
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

// ---- bf16 stages (tensor cores, no atomics in the backward)

// Up to three fp32 -> bf16 copies in one launch (blockIdx.z: the job), each
// dst[r * ld + c] = src[r * cols + c], or with `transpose` dst[c * ld + r];
// 32 x 32 tiles through shared memory.
struct CastJob {
  const float* src;
  bf16* dst;
  int rows, cols, ld, transpose;
};
struct CastJobs {
  CastJob job[3];
};

__global__ void __launch_bounds__(256) conv_cast_kernel(CastJobs jobs) {
  __shared__ float tile[32][33];
  const CastJob& jb = jobs.job[blockIdx.z];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  if (r0 >= jb.rows || c0 >= jb.cols) return;  // uniform over the block
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int row = r0 + r, col = c0 + tx;
    tile[r][tx] = (row < jb.rows && col < jb.cols) ? jb.src[(size_t)row * jb.cols + col] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    if (jb.transpose) {  // uniform over the block
      const int col = c0 + r, row = r0 + tx;
      if (row < jb.rows && col < jb.cols)
        jb.dst[(size_t)col * jb.ld + row] = __float2bfloat16(tile[tx][r]);
    } else {
      const int row = r0 + r, col = c0 + tx;
      if (row < jb.rows && col < jb.cols)
        jb.dst[(size_t)row * jb.ld + col] = __float2bfloat16(tile[r][tx]);
    }
  }
}

// LayerNorm of PREP_ROWS token rows: the rows come into shared memory in one
// pass of loads all in flight; then the statistics (one warp per row), h
// (n, ldd) and, for bwd2, its transpose h^T (d, ldn) through a PREP_ROWS x 64
// shared tile, and bf16(g m) (n, ldeo).
__global__ void __launch_bounds__(THREADS)
conv_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, Params p,
                 Scratch<bf16> sc, Shape sh, Drop dr, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [rows][d]
  __shared__ float mean_s[PREP_ROWS], rstd_s[PREP_ROWS];
  __shared__ bf16 tile[PREP_ROWS][64 + 2];
  const int row0 = blockIdx.x * PREP_ROWS, tid = threadIdx.x, warp = tid / 32;
  const int rows = min(PREP_ROWS, sh.n - row0), d = sh.d;
  {
    const bf16* xb = x + (size_t)row0 * d;
    const int nel = rows * d;
    if (d % 2 == 0) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(xb);
      uint32_t* dst = reinterpret_cast<uint32_t*>(xs);
#pragma unroll 8
      for (int i = tid; i < nel / 2; i += THREADS) dst[i] = src[i];
    } else {
#pragma unroll 8
      for (int i = tid; i < nel; i += THREADS) xs[i] = xb[i];
    }
  }
  __syncthreads();
  for (int r = warp; r < rows; r += THREADS / 32) {
    float m, rs;
    ln_stats_warp(xs + r * d, d, eps, &m, &rs);
    if (tid % 32 == 0) {
      mean_s[r] = m;
      rstd_s[r] = rs;
      sc.mean[row0 + r] = m;
      sc.rstd[row0 + r] = rs;
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < d; c0 += 64) {
    for (int i = tid; i < PREP_ROWS * 64; i += THREADS) {
      const int r = i / 64, c = i % 64, col = c0 + c;
      if (r < rows && col < d) {
        const float h = ln_h_of<bf16>(to_f(xs[r * d + col]), mean_s[r], rstd_s[r], p, col);
        tile[r][c] = __float2bfloat16(h);
        sc.h[(size_t)(row0 + r) * sc.ldd + col] = tile[r][c];
      }
    }
    if (sc.ht != nullptr) {
      __syncthreads();
      for (int i = tid; i < PREP_ROWS * 64; i += THREADS) {
        const int c = i / PREP_ROWS, r = i % PREP_ROWS, col = c0 + c;
        if (r < rows && col < d) sc.ht[(size_t)col * sc.ldn + row0 + r] = tile[r][c];
      }
    }
    __syncthreads();
  }
  if (sc.gm != nullptr)
    for (int i = tid; i < rows * sh.eo; i += THREADS) {
      const int r = i / sh.eo, o = i % sh.eo;
      sc.gm[(size_t)(row0 + r) * sc.ldeo + o] =
          __float2bfloat16(masked_g(g, dr, row0 + r, o, sh));
    }
}

// bf16: the depthwise backward of the fp32 kernel above for DWB_ROWS rows x
// 64 channels, with the block's window of z and dc (its rows and k - 1 more
// on each side, zeros outside [0, n)) staged in shared memory first; a tap
// still reads only rows of its own sequence. dab is written row-major and
// transposed (through shared memory), and db1 and the tap gradient go to the
// block's partial sums: no atomics.
__global__ void __launch_bounds__(THREADS)
conv_depthwise_bwd_bf16_kernel(Params p, Scratch<bf16> sc, Shape sh) {
  constexpr int WIN = DWB_ROWS + 2 * (KMAX - 1);
  __shared__ float win[2][WIN][DW_CH];  // z, dc; then the tap sums
  float (*zs)[DW_CH] = win[0];
  float (*dcs)[DW_CH] = win[1];
  __shared__ float red[2][DW_LANES][DW_CH];
  __shared__ bf16 tr[2][DW_CH][DWB_ROWS + 2];  // da, dbg of the block, transposed
  const int cl = threadIdx.x % DW_CH, lane = threadIdx.x / DW_CH;
  const int ch0 = blockIdx.y * DW_CH, ch = ch0 + cl, row0 = blockIdx.x * DWB_ROWS;
  const int e = sh.e, k = sh.k, t = sh.t, halo = k - 1;
  for (int i = threadIdx.x; i < (DWB_ROWS + 2 * halo) * DW_CH; i += THREADS) {
    const int wr = i / DW_CH, c = i % DW_CH, row = row0 - halo + wr;
    const bool in = row >= 0 && row < sh.n && ch0 + c < e;
    zs[wr][c] = in ? to_f(sc.z[(size_t)row * e + ch0 + c]) : 0.f;
    dcs[wr][c] = in ? sc.dc[(size_t)row * e + ch0 + c] : 0.f;
  }
  float tap[KMAX], w[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tap[j] = 0.f;
    w[j] = ch < e && j < k ? p.dw[(size_t)ch * k + j] : 0.f;
  }
  __syncthreads();
  float sum_a = 0.f, sum_b = 0.f;
  if (ch < e) {
    for (int r = lane; r < DWB_ROWS; r += DW_LANES) {
      const int row = row0 + r;
      if (row >= sh.n) break;
      const int tt = row % t, wr = r + halo;
      const float dcv = dcs[wr][cl];
      float dz = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j >= k) break;
        const int tz = tt + j - sh.pad_lo;   // z feeding output row tt through tap j
        if (tz >= 0 && tz < t) tap[j] = fmaf(zs[wr + j - sh.pad_lo][cl], dcv, tap[j]);
        const int tc = tt + sh.pad_lo - j;   // output row that z[tt] feeds through tap j
        if (tc >= 0 && tc < t) dz = fmaf(dcs[wr + sh.pad_lo - j][cl], w[j], dz);
      }
      const size_t o = (size_t)row * e + ch;
      const float gate = sigmoid(to_f(sc.bg[o]));
      const float da = dz * gate;
      const float dbg = dz * to_f(sc.a[o]) * gate * (1.f - gate);
      sum_a += da;
      sum_b += dbg;
      const size_t o2 = (size_t)row * sc.ld_dab + ch;
      sc.dab[o2] = __float2bfloat16(da);
      sc.dab[o2 + e] = __float2bfloat16(dbg);
      tr[0][cl][r] = __float2bfloat16(da);
      tr[1][cl][r] = __float2bfloat16(dbg);
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
    sc.part_db1[(size_t)blockIdx.x * 2 * e + ch] = a;
    sc.part_db1[(size_t)blockIdx.x * 2 * e + e + ch] = b;
  }
  const int rows = min(DWB_ROWS, sh.n - row0);
  for (int i = threadIdx.x; i < 2 * DW_CH * DWB_ROWS; i += THREADS) {
    const int r = i % DWB_ROWS, c = (i / DWB_ROWS) % DW_CH, half = i / (DWB_ROWS * DW_CH);
    if (r < rows && ch0 + c < e)
      sc.dabt[(size_t)(half * e + ch0 + c) * sc.ldn + row0 + r] = tr[half][c][r];
  }
  // The tap sums of the DW_LANES row groups, all taps at once, through the
  // window's shared memory (read by no one any more).
  float* red_tap = &win[0][0][0];  // [k][DW_LANES][DW_CH], k * 1 KB <= 2 WIN KB
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) red_tap[(j * DW_LANES + lane) * DW_CH + cl] = tap[j];
  __syncthreads();
  for (int i = threadIdx.x; i < k * DW_CH; i += THREADS) {
    const int j = i / DW_CH, c = i % DW_CH;
    if (ch0 + c >= e) continue;
    float a = 0.f;
#pragma unroll
    for (int l = 0; l < DW_LANES; ++l) a += red_tap[(j * DW_LANES + l) * DW_CH + c];
    sc.part_tap[(size_t)blockIdx.x * e * k + (size_t)(ch0 + c) * k + j] = a;
  }
}

struct Pw1Maps {
  CUtensorMap h, w1;  // h (n, d), W1b (2E, d): boxes of 64 x 64
};

// pw1 on the tensor cores: one warpgroup per (64 rows, 64 channels of both
// GLU halves): a = round(h W1a^T + b1a), bg = round(h W1b^T + b1b),
// z = round(a sigmoid(bg)); bwd2 also keeps a and bg.
__global__ void __launch_bounds__(WG)
conv_pw1_wgmma_kernel(const __grid_constant__ Pw1Maps maps, Params p, Scratch<bf16> sc,
                      Shape sh) {
  using namespace hopper;
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + PW_RING * 3 * TILE_BYTES);
  const int row0 = blockIdx.x * 64, ch0 = blockIdx.y * 64, e = sh.e;
  const CUtensorMap* const mb[2] = {&maps.w1, &maps.w1};
  const int b_row[2] = {ch0, e + ch0};
  float bias[2][16];  // b1 of this thread's 16 columns, both halves, read first
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = ch0 + (i / 2) * 8 + 2 * q + (i & 1);
    bias[0][i] = col < e ? p.b1[col] : 0.f;
    bias[1][i] = col < e ? p.b1[e + col] : 0.f;
  }
  float acc[2][32];
  wg_mainloop<2, PW_RING>(acc, ring, bars, &maps.h, row0, mb, b_row, 0, cdiv(sh.d, 64));
  // z, a, bg of the tile through the (now idle) ring, then whole-row stores.
  constexpr int LDO = 64 + 8;
  bf16* out = ring;  // [3][64][LDO]
  const bool keep = sc.a != nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int rl = w * 16 + g + (v >> 1) * 8, cl = i * 8 + 2 * q + (v & 1);
      const float a = rnd<bf16>(acc[0][4 * i + v] + bias[0][2 * i + (v & 1)]);
      const float bg = rnd<bf16>(acc[1][4 * i + v] + bias[1][2 * i + (v & 1)]);
      out[rl * LDO + cl] = __float2bfloat16(a * sigmoid(bg));
      if (keep) {
        out[(64 + rl) * LDO + cl] = __float2bfloat16(a);
        out[(128 + rl) * LDO + cl] = __float2bfloat16(bg);
      }
    }
  __syncthreads();
  bf16* dst[3] = {sc.z, sc.a, sc.bg};
  const int rows = min(64, sh.n - row0), cols = min(64, e - ch0);
  for (int m = 0; m < (keep ? 3 : 1); ++m)
    for (int i = threadIdx.x; i < rows * 64; i += WG) {
      const int r = i / 64, c = i % 64;
      if (c < cols) dst[m][(size_t)(row0 + r) * e + ch0 + c] = out[(m * 64 + r) * LDO + c];
    }
}

struct DsMaps {
  CUtensorMap gm, w2t;  // bf16(g m) (n, E'), W2^T (E, E'): boxes of 64 x 64
};

// ds = bf16(g m) W2 on the tensor cores, one warpgroup per (64 rows, 64
// channels), and the BN backward in the epilogue: dc (fp32).
__global__ void __launch_bounds__(WG)
conv_grad_bn_wgmma_kernel(const __grid_constant__ DsMaps maps, Params p, Scratch<bf16> sc,
                          Shape sh, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const float* __restrict__ rn1,
                          const float* __restrict__ rn2) {
  using namespace hopper;
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + DS_RING * 2 * TILE_BYTES);
  const int row0 = blockIdx.x * 64, ch0 = blockIdx.y * 64, e = sh.e;
  const CUtensorMap* const mb[1] = {&maps.w2t};
  const int b_row[1] = {ch0};
  __shared__ float cp[6][64];  // per column: mean, rstd, bn_w, bn_b, rn1, rn2
  if (threadIdx.x < 64) {
    const int col = ch0 + threadIdx.x;
    const bool in = col < e;
    cp[0][threadIdx.x] = in ? mean[col] : 0.f;
    cp[1][threadIdx.x] = in ? rstd[col] : 0.f;
    cp[2][threadIdx.x] = in ? p.bn_w[col] : 0.f;
    cp[3][threadIdx.x] = in ? p.bn_b[col] : 0.f;
    cp[4][threadIdx.x] = in ? rn1[col] : 0.f;
    cp[5][threadIdx.x] = in ? rn2[col] : 0.f;
  }
  float acc[1][32];
  wg_mainloop<1, DS_RING>(acc, ring, bars, &maps.gm, row0, mb, b_row, 0, cdiv(sh.eo, 64));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  float cv[32];  // c at this thread's elements, all loads in flight first
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int row = row0 + w * 16 + g + (v >> 1) * 8, col = ch0 + i * 8 + 2 * q + (v & 1);
      cv[4 * i + v] = row < sh.n && col < e ? to_f(sc.c[(size_t)row * e + col]) : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int cl = i * 8 + 2 * q + (v & 1);
      const int row = row0 + w * 16 + g + (v >> 1) * 8, col = ch0 + cl;
      if (row >= sh.n || col >= e) continue;
      const float rs = cp[1][cl];
      const float chat = (cv[4 * i + v] - cp[0][cl]) * rs;
      const float cn = rnd<bf16>(chat * cp[2][cl] + cp[3][cl]);
      const float sig = sigmoid(cn);
      const float gbn = acc[0][4 * i + v] * (sig + cn * sig * (1.f - sig));
      sc.dc[(size_t)row * e + col] = cp[2][cl] * rs * (gbn - cp[4][cl] - chat * cp[5][cl]);
    }
}

// bf16: the LayerNorm backward per LNB_ROWS rows: dx, and the rows' partial
// sums of dh and dh xhat (xhat unrounded) per column.
__global__ void __launch_bounds__(THREADS)
conv_ln_bwd_rows_kernel(const bf16* __restrict__ x, Params p, Scratch<bf16> sc, Shape sh,
                        bf16* __restrict__ dx) {
  const int row0 = blockIdx.x * LNB_ROWS, tid = threadIdx.x, d = sh.d;
  const int rows = min(LNB_ROWS, sh.n - row0);
  for (int c = tid; c < d; c += THREADS) {
    float dhv[LNB_ROWS], xv[LNB_ROWS];  // all loads in flight before the first use
#pragma unroll
    for (int r = 0; r < LNB_ROWS; ++r) {
      const size_t at = (size_t)(row0 + r) * d + c;
      dhv[r] = r < rows ? sc.dh[at] : 0.f;
      xv[r] = r < rows ? to_f(x[at]) : 0.f;
    }
    float sb = 0.f, sw = 0.f;
#pragma unroll
    for (int r = 0; r < LNB_ROWS; ++r) {
      if (r < rows) {
        const float xhat = (xv[r] - sc.mean[row0 + r]) * sc.rstd[row0 + r];
        sb += dhv[r];
        sw += dhv[r] * xhat;
      }
    }
    sc.part_lnb[(size_t)blockIdx.x * d + c] = sb;
    sc.part_lnw[(size_t)blockIdx.x * d + c] = sw;
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
      dx[(size_t)row * d + c] = __float2bfloat16(rstd * (dxh - m1 - xhat * m2));
    }
  }
}

struct Grads {
  float *ln_w, *ln_b, *w1, *b1, *dw;
};

// bf16: the partial sums of the second backward pass added in a fixed order
// and then, once, into the caller's buffers: one warp per element of db1,
// the tap gradient, dln_b and dln_w over the row blocks (lanes striding, then
// a fixed shuffle tree; blockIdx.x < sum_blocks), then one thread per element
// of dW1 over the row splits.
__global__ void __launch_bounds__(256)
conv_bwd2_reduce_kernel(Scratch<bf16> sc, Shape sh, Grads gr, int sum_blocks) {
  const int e = sh.e, d = sh.d, ek = sh.e * sh.k;
  if ((int)blockIdx.x < sum_blocks) {
    const int i = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (i >= 2 * e + ek + 2 * d) return;  // uniform over the warp
    const float* part;
    float* out;
    int at, stride, count;
    if (i < 2 * e) {
      part = sc.part_db1, out = gr.b1, at = i, stride = 2 * e, count = sc.rt_dw;
    } else if (i < 2 * e + ek) {
      part = sc.part_tap, out = gr.dw, at = i - 2 * e, stride = ek, count = sc.rt_dw;
    } else if (i < 2 * e + ek + d) {
      part = sc.part_lnb, out = gr.ln_b, at = i - 2 * e - ek, stride = d, count = sc.rt_ln;
    } else {
      part = sc.part_lnw, out = gr.ln_w, at = i - 2 * e - ek - d, stride = d, count = sc.rt_ln;
    }
    float v = 0.f;
    for (int r = lane; r < count; r += 32) v += part[(size_t)r * stride + at];
    v = warp_sum(v);
    if (lane == 0) out[at] += v;
    return;
  }
  const size_t ed = (size_t)2 * e * d;
  const size_t i = (size_t)(blockIdx.x - sum_blocks) * 256 + threadIdx.x;
  if (i >= ed) return;
  float v = 0.f;
  for (int s = 0; s < sc.splits; ++s) v += sc.part_w1[s * ed + i];
  gr.w1[i] += v;
}

// ---- host side

// Rows of dW1 = dab^T h are split into this many partial sums.
int weight_splits(int n, int d, int e) {
  const int tiles = cdiv(2 * e, 64) * cdiv(d, 64);
  const int by_card = cdiv(WAVE_BLOCKS, tiles);
  const int by_depth = cdiv(n, 64) / 8;  // keep at least 8 k-tiles per split
  const int s = by_card < by_depth ? by_card : by_depth;
  return s < 1 ? 1 : s;
}

// Carves `base` (nullptr: only sizes) into the scratch of one pass; returns
// its size in bytes.
template <typename T>
size_t carve(char* base, const Shape& sh, int stage, Scratch<T>* sc) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  const size_t n = sh.n, e = sh.e, d = sh.d, ne = n * e;
  *sc = Scratch<T>{};
  sc->ldd = round8(sh.d);
  sc->ld2e = round8(2 * sh.e);
  sc->ldeo = round8(sh.eo);
  sc->ldn = round8(sh.n);
  sc->ld_dab = BF16 ? sc->ld2e : 2 * sh.e;
  sc->rt_dw = cdiv(sh.n, DWB_ROWS);
  sc->rt_ln = cdiv(sh.n, LNB_ROWS);
  sc->splits = weight_splits(sh.n, sh.d, sh.e);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* q = base == nullptr ? nullptr : base + at;
    at += (bytes + 1023) / 1024 * 1024;
    return q;
  };
  auto tt = [&](size_t elems) { return reinterpret_cast<T*>(take(elems * sizeof(T))); };
  auto tb = [&](size_t elems) { return reinterpret_cast<bf16*>(take(elems * 2)); };
  auto tf = [&](size_t elems) { return reinterpret_cast<float*>(take(elems * 4)); };
  sc->mean = tf(n);
  sc->rstd = tf(n);
  sc->z = tt(ne);
  if (stage == BWD2) {
    sc->a = tt(ne);
    sc->bg = tt(ne);
    sc->dc = tf(ne);
    sc->dab = tt(n * sc->ld_dab);
    sc->dh = tf(n * d);
  }
  if (stage == BWD1 || stage == BWD2) sc->c = tt(ne);
  if (stage == FWD || stage == BWD1) sc->s = tt(ne);
  if (BF16) {
    sc->w1b = tb(2 * e * sc->ldd);
    sc->h = tb(n * sc->ldd);
    if (stage == BWD2) {
      sc->w1t = tb(d * sc->ld2e);
      sc->w2t = tb(e * sc->ldeo);
      sc->ht = tb(d * sc->ldn);
      sc->gm = tb(n * sc->ldeo);
      sc->dabt = tb(2 * e * sc->ldn);
      sc->part_db1 = tf((size_t)sc->rt_dw * 2 * e);
      sc->part_tap = tf((size_t)sc->rt_dw * e * sh.k);
      sc->part_lnb = tf((size_t)sc->rt_ln * d);
      sc->part_lnw = tf((size_t)sc->rt_ln * d);
      sc->part_w1 = tf((size_t)sc->splits * 2 * e * d);
    }
  }
  return at;
}

#define LAUNCH_CHECK()                          \
  do {                                          \
    const cudaError_t rc_ = cudaGetLastError(); \
    if (rc_ != cudaSuccess) return rc_;         \
  } while (0)

#define AVEC_CHECK(call)                        \
  do {                                          \
    const cudaError_t rc_ = (call);             \
    if (rc_ != cudaSuccess) return rc_;         \
  } while (0)

constexpr size_t pw1_smem() { return 1024 + PW_RING * 3 * hopper::TILE_BYTES + PW_RING * 8; }
constexpr size_t ds_smem() { return 1024 + DS_RING * 2 * hopper::TILE_BYTES + DS_RING * 8; }

// The shared recompute up to z (and a, bg for bwd2). fp32: LayerNorm
// statistics, then pw1 as FMAs. bf16: the weights cast once (bwd2 also
// W1^T and W2^T), LayerNorm into h (bwd2 also h^T and bf16(g m)), then pw1
// on the tensor cores.
template <typename T>
cudaError_t pre_bn(const T* x, const T* g, const Params& p, const Scratch<T>& sc,
                   const Shape& sh, float eps, Drop dr, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    conv_ln_stats_kernel<T><<<cdiv(sh.n, THREADS / 32), THREADS, 0, st>>>(x, sc, sh.n, sh.d,
                                                                        eps);
    LAUNCH_CHECK();
    conv_pw1_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.e, BT)), THREADS, 0, st>>>(x, p, sc, sh);
    LAUNCH_CHECK();
  } else {
    const bool bwd2 = sc.w1t != nullptr;
    Pw1Maps maps;
    if (!hopper::tensor_map_2d(&maps.h, sc.h, sh.n, sh.d, sc.ldd, 64) ||
        !hopper::tensor_map_2d(&maps.w1, sc.w1b, 2 * sh.e, sh.d, sc.ldd, 64))
      return cudaErrorInvalidValue;
    CastJobs jobs{};
    jobs.job[0] = {p.w1, sc.w1b, 2 * sh.e, sh.d, sc.ldd, 0};
    jobs.job[1] = {p.w1, sc.w1t, 2 * sh.e, sh.d, sc.ld2e, 1};
    jobs.job[2] = {p.w2, sc.w2t, sh.eo, sh.e, sc.ldeo, 1};
    const int big = 2 * sh.e > sh.eo ? 2 * sh.e : sh.eo, wide = sh.d > sh.e ? sh.d : sh.e;
    conv_cast_kernel<<<dim3(cdiv(wide, 32), cdiv(big, 32), bwd2 ? 3 : 1), 256, 0, st>>>(jobs);
    LAUNCH_CHECK();
    const int xs_bytes = PREP_ROWS * sh.d * (int)sizeof(bf16);
    AVEC_CHECK(cudaFuncSetAttribute(conv_prep_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, xs_bytes));
    conv_prep_kernel<<<cdiv(sh.n, PREP_ROWS), THREADS, xs_bytes, st>>>(x, g, p, sc, sh, dr,
                                                                       eps);
    LAUNCH_CHECK();
    AVEC_CHECK(cudaFuncSetAttribute(conv_pw1_wgmma_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)pw1_smem()));
    conv_pw1_wgmma_kernel<<<dim3(cdiv(sh.n, 64), cdiv(sh.e, 64)), WG, pw1_smem(), st>>>(
        maps, p, sc, sh);
    LAUNCH_CHECK();
  }
  return cudaSuccess;
}

dim3 dw_grid(const Shape& sh) { return dim3(cdiv(sh.n, DW_ROWS), cdiv(sh.e, DW_CH)); }

template <typename T>
cudaError_t run_stats(const T* x, const Params& p, float* s1, float* s2, const Scratch<T>& sc,
                      const Shape& sh, float eps, cudaStream_t st) {
  AVEC_CHECK(pre_bn<T>(x, nullptr, p, sc, sh, eps, Drop{}, st));
  conv_depthwise_kernel<T, STATS><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, nullptr, nullptr,
                                                                    s1, s2);
  LAUNCH_CHECK();
  return cudaSuccess;
}

template <typename T>
cudaError_t run_fwd(const T* x, const Params& p, const float* mean, const float* rstd, T* y,
                    const Scratch<T>& sc, const Shape& sh, float eps, Drop dr, cudaStream_t st) {
  AVEC_CHECK(pre_bn<T>(x, nullptr, p, sc, sh, eps, dr, st));
  conv_depthwise_kernel<T, FWD><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, mean, rstd,
                                                                  nullptr, nullptr);
  LAUNCH_CHECK();
  conv_pw2_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.eo, BT)), THREADS, 0, st>>>(p, sc, sh, dr,
                                                                                y);
  LAUNCH_CHECK();
  return cudaSuccess;
}

template <typename T>
cudaError_t run_bwd1(const T* x, const T* g, const Params& p, const float* mean,
                     const float* rstd, float* dw2, float* db2, float* r1, float* r2,
                     const Scratch<T>& sc, const Shape& sh, float eps, Drop dr, cudaStream_t st) {
  AVEC_CHECK(pre_bn<T>(x, nullptr, p, sc, sh, eps, dr, st));
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

template <typename T>
cudaError_t run_bwd2(const T* x, const T* g, const Params& p, const float* mean,
                     const float* rstd, const float* rn1, const float* rn2, T* dx,
                     const Grads& gr, const Scratch<T>& sc, const Shape& sh, float eps, Drop dr,
                     cudaStream_t st) {
  AVEC_CHECK(pre_bn<T>(x, g, p, sc, sh, eps, dr, st));
  conv_depthwise_kernel<T, BWD2><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, mean, rstd,
                                                                   nullptr, nullptr);
  LAUNCH_CHECK();
  if constexpr (std::is_same<T, float>::value) {
    conv_grad_bn_kernel<T, BWD2><<<dim3(cdiv(sh.n, BT), cdiv(sh.e, BT)), THREADS, 0, st>>>(
        g, p, sc, sh, dr, mean, rstd, rn1, rn2, nullptr, nullptr);
    LAUNCH_CHECK();
    conv_depthwise_bwd_kernel<T><<<dw_grid(sh), THREADS, 0, st>>>(p, sc, sh, gr.b1, gr.dw);
    LAUNCH_CHECK();
    const dim3 w1_grid(cdiv(2 * sh.e, BT), cdiv(sh.d, BT), cdiv(sh.n, SPLIT_ROWS));
    conv_grad_w1_kernel<T><<<w1_grid, THREADS, 0, st>>>(x, p, sc, sh, gr.w1);
    LAUNCH_CHECK();
    conv_grad_h_kernel<T><<<dim3(cdiv(sh.n, BT), cdiv(sh.d, BT)), THREADS, 0, st>>>(p, sc,
                                                                                    sh);
    LAUNCH_CHECK();
    conv_ln_bwd_kernel<T><<<cdiv(sh.n, LN_ROWS), THREADS, 0, st>>>(x, p, sc, sh, dx, gr.ln_w,
                                                                    gr.ln_b);
    LAUNCH_CHECK();
  } else {
    using hopper::tensor_map_2d;
    DsMaps dm;
    hopper::ProductMaps<2> pm;
    const bool maps_ok =
        tensor_map_2d(&dm.gm, sc.gm, sh.n, sh.eo, sc.ldeo, 64) &&
        tensor_map_2d(&dm.w2t, sc.w2t, sh.e, sh.eo, sc.ldeo, 64) &&
        tensor_map_2d(&pm.a[0], sc.dabt, 2 * sh.e, sh.n, sc.ldn, 64) &&
        tensor_map_2d(&pm.b[0], sc.ht, sh.d, sh.n, sc.ldn, 64) &&
        tensor_map_2d(&pm.a[1], sc.dab, sh.n, 2 * sh.e, sc.ld2e, 64) &&
        tensor_map_2d(&pm.b[1], sc.w1t, sh.d, 2 * sh.e, sc.ld2e, 64);
    if (!maps_ok) return cudaErrorInvalidValue;
    AVEC_CHECK(cudaFuncSetAttribute(conv_grad_bn_wgmma_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)ds_smem()));
    conv_grad_bn_wgmma_kernel<<<dim3(cdiv(sh.n, 64), cdiv(sh.e, 64)), WG, ds_smem(), st>>>(
        dm, p, sc, sh, mean, rstd, rn1, rn2);
    LAUNCH_CHECK();
    const dim3 grid(cdiv(sh.n, DWB_ROWS), cdiv(sh.e, DW_CH));
    conv_depthwise_bwd_bf16_kernel<<<grid, THREADS, 0, st>>>(p, sc, sh);
    LAUNCH_CHECK();
    hopper::ProductJobs<2> jobs;
    jobs.job[0] = {2 * sh.e, sh.d, sh.n, sc.splits, cdiv(sh.d, 64), 0, sc.part_w1, sh.d};
    jobs.job[1] = {sh.n, sh.d, 2 * sh.e, 1, cdiv(sh.d, 64), 0, sc.dh, sh.d};
    const int blocks = hopper::product_blocks(&jobs);
    AVEC_CHECK(cudaFuncSetAttribute(hopper::wgmma_products_kernel<2>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)hopper::PRODUCT_SMEM));
    hopper::wgmma_products_kernel<2><<<blocks, WG, hopper::PRODUCT_SMEM, st>>>(pm, jobs);
    LAUNCH_CHECK();
    conv_ln_bwd_rows_kernel<<<sc.rt_ln, THREADS, 0, st>>>(x, p, sc, sh, dx);
    LAUNCH_CHECK();
    const int sum_blocks = cdiv(2 * sh.e + sh.e * sh.k + 2 * sh.d, 8);
    const int w_blocks = cdiv(2 * sh.e * sh.d, 256);
    conv_bwd2_reduce_kernel<<<sum_blocks + w_blocks, 256, 0, st>>>(sc, sh, gr, sum_blocks);
    LAUNCH_CHECK();
  }
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

// Runs `fn` with x's dtype T and that pass's scratch carved from `scratch`.
template <class Fn>
int with_type(int is_bf16, void* scratch, const Shape& sh, int stage, Fn fn) {
  if (is_bf16) {
    Scratch<bf16> sc;
    carve<bf16>(static_cast<char*>(scratch), sh, stage, &sc);
    return fn(sc);
  }
  Scratch<float> sc;
  carve<float>(static_cast<char*>(scratch), sh, stage, &sc);
  return fn(sc);
}

}  // namespace

// Bytes of scratch pass `stage` (0 stats, 1 fwd, 2 bwd1, 3 bwd2) needs at
// these widths, for fp32 or bf16 inputs.
extern "C" long long avec_conv_scratch_bytes(int b, int t, int d, int e, int eo, int k,
                                             int stage, int is_bf16) {
  if (!shape_ok(b, t, d, e, eo, k, 0)) return 0;
  const Shape sh{b, t, d, e, eo, k, 0, b * t};
  if (is_bf16) {
    Scratch<bf16> sc;
    return (long long)carve<bf16>(nullptr, sh, stage, &sc);
  }
  Scratch<float> sc;
  return (long long)carve<float>(nullptr, sh, stage, &sc);
}

// Every entry point takes x (B, T, d) in fp32 or bf16 (is_bf16), the ten fp32
// parameters as an array of pointers in the order ln_w, ln_b, pw1 (2E, d),
// pw1_b, depthwise (E, k), its bias, bn_w, bn_b, pw2 (E', E), pw2_b, a
// scratch buffer of avec_conv_scratch_bytes(...) bytes (256-byte aligned),
// the shape, the LayerNorm eps, the dropout arguments (on when use_drop != 0:
// keep iff the hash bits < thr, multiplier inv_keep) and the stream; it
// returns the launches' cudaError_t. Output sums are fp32 buffers that the
// caller zeroed on the same stream (the kernels add into them).
#define CONV_TAIL                                                                        \
  int b, int t, int d, int e, int eo, int k, int pad_lo, float eps, int use_drop,        \
      unsigned seed, unsigned thr, float inv_keep, int is_bf16, void* stream

#define CONV_SETUP                                                           \
  if (!shape_ok(b, t, d, e, eo, k, pad_lo)) return cudaErrorInvalidValue;    \
  const Shape sh{b, t, d, e, eo, k, pad_lo, b * t};                          \
  const Params p = unpack(params);                                           \
  const Drop dr{seed, thr, inv_keep, use_drop};                              \
  (void)dr;                                                                  \
  cudaStream_t st = static_cast<cudaStream_t>(stream);

// K3-stats: s1, s2 (E,) += per-channel sums of c and c^2 over all B T rows.
extern "C" int avec_conv_stats(const void* x, const void* const* params, void* s1, void* s2,
                               void* scratch, CONV_TAIL) {
  CONV_SETUP
  float *a = static_cast<float*>(s1), *q = static_cast<float*>(s2);
  return with_type(is_bf16, scratch, sh, STATS, [&](auto sc) {
    using T = std::remove_pointer_t<decltype(sc.z)>;
    return (int)run_stats<T>(static_cast<const T*>(x), p, a, q, sc, sh, eps, st);
  });
}

// K3-fwd: y (B, T, E') in x's dtype from the batch mean and rstd (E,).
extern "C" int avec_conv_fwd(const void* x, const void* const* params, const void* mean,
                             const void* rstd, void* y, void* scratch, CONV_TAIL) {
  CONV_SETUP
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  return with_type(is_bf16, scratch, sh, FWD, [&](auto sc) {
    using T = std::remove_pointer_t<decltype(sc.z)>;
    return (int)run_fwd<T>(static_cast<const T*>(x), p, m, r, static_cast<T*>(y), sc, sh, eps,
                           dr, st);
  });
}

// K3b-1: dW2 (E', E), db2 (E'), r1, r2 (E) += from the cotangent g (B, T, E').
extern "C" int avec_conv_bwd1(const void* x, const void* g, const void* const* params,
                              const void* mean, const void* rstd, void* dw2, void* db2, void* r1,
                              void* r2, void* scratch, CONV_TAIL) {
  CONV_SETUP
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  auto f = [](void* v) { return static_cast<float*>(v); };
  return with_type(is_bf16, scratch, sh, BWD1, [&](auto sc) {
    using T = std::remove_pointer_t<decltype(sc.z)>;
    return (int)run_bwd1<T>(static_cast<const T*>(x), static_cast<const T*>(g), p, m, r, f(dw2),
                            f(db2), f(r1), f(r2), sc, sh, eps, dr, st);
  });
}

// K3b-2: dx (B, T, d) in x's dtype, and += the gradients of ln_w, ln_b,
// pw1 (2E, d), pw1_b (2E) and the depthwise taps (E, k), given as an array of
// five pointers in that order, from rn1 = r1 / n and rn2 = r2 / n. In bf16
// every one of those sums has a fixed order (no atomics): two calls add the
// same bits.
extern "C" int avec_conv_bwd2(const void* x, const void* g, const void* const* params,
                              const void* mean, const void* rstd, const void* rn1,
                              const void* rn2, void* dx, void* const* grads, void* scratch,
                              CONV_TAIL) {
  CONV_SETUP
  const float *m = static_cast<const float*>(mean), *r = static_cast<const float*>(rstd);
  const float *q1 = static_cast<const float*>(rn1), *q2 = static_cast<const float*>(rn2);
  auto f = [&](int i) { return static_cast<float*>(grads[i]); };
  const Grads gr{f(0), f(1), f(2), f(3), f(4)};
  return with_type(is_bf16, scratch, sh, BWD2, [&](auto sc) {
    using T = std::remove_pointer_t<decltype(sc.z)>;
    return (int)run_bwd2<T>(static_cast<const T*>(x), static_cast<const T*>(g), p, m, r, q1, q2,
                            static_cast<T*>(dx), gr, sc, sh, eps, dr, st);
  });
}
