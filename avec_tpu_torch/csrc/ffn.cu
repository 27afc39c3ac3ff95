// Fused conformer feed-forward module, forward and backward, for Hopper
// (sm_90a).
//
// Replaces: avec_tpu/ops/pallas_ffn.py `_ffn_fwd_kernel` (:121, pallas_call at
// :253) and `_ffn_bwd_kernel` (:142, pallas_call at :279), reached through
// `fused_ffn_3d` (:351) from FeedForwardModule in training mode.
//
// Computes, for token rows x (N, d) and the module's fp32 parameters
// (LayerNorm w, b (d,); W1 (F, d), b1 (F,); W2 (d, F), b2 (d,) in the
// Linear (out, in) layout):
//     h = cast(LN(x)) * cast(w) + cast(b)          LN statistics in fp32
//     u = h W1^T + b1                              operands in x's type,
//     s = swish(u) * m_inner                       fp32 accumulation,
//     y = (cast(s) W2^T + b2) * m_outer            biases added in fp32
// and, in the backward, dx and the fp32 gradients of the six parameters,
// recomputing h, u and the masks from x: nothing but x, the parameters and
// the seed is kept between the two passes. The dropout masks are a pure
// function of (seed, row, column, draw), the murmur3-finaliser counter hash
// of pallas_ffn.py:76-108 written per global row, so the forward, the
// backward and the plain PyTorch version all regenerate the same masks.
//
// What bounds it on the H100: operations. The backward does five products of
// N d F multiply-adds each (u again, ds, dW1, dW2, dh): 6.3 GFLOP at every
// width of the train step (N d F is about 6.3e8 at (4816, 180, 720),
// (2416, 256, 1024) and (1216, 360, 1440)), 6.4 us at the bf16 tensor-core
// peak; its bytes (x, g, dx and the fp32 parameters and gradients) take about
// 3 us. The forward does two of the products.
//
// Forward design, bf16 (the training path), for Hopper's tensor cores. Its
// first version (one block per 32 rows, 38 blocks at d = 360; every block
// re-reading and re-casting all of W1 and W2 from fp32; 16-row mma.sync tiles
// with a barrier between staging and compute) ran at 78x its bound. Now a
// first stage casts the weights to bf16 once per call into K-major scratch
// (rows padded to 8 elements, so that TMA addresses d = 180) and computes
// h = LN(x) once per row; a block of the main stage owns 64 token rows and a
// range of the hidden dimension, chosen so that the grid fills the 132 SMs at
// every width ((1216, 360, 1440): 19 x 12 = 228 blocks). It loads its h tiles
// by TMA into 128-byte-swizzled shared memory, the layout `wgmma` reads; two
// consumer warpgroups take one 64-column hidden chunk each for u = h W1^T,
// apply bias, swish and the inner dropout hash in the accumulator's fragment
// layout and write s back to swizzled shared memory (so both warpgroups read
// both chunks of s as the A operand of the second product; s from registers
// would give each warpgroup only its own chunk), then each adds s W2^T into
// the output tiles of its half of d: at most 3 x 32 accumulator registers a
// thread at d = 360. Weight tiles come by TMA through an 8-stage ring, and
// each phase waits for its products once. The partial outputs of the hidden
// ranges go to fp32 scratch (L2-resident at the step's shapes), which a last
// stage sums in a fixed order before b2, the outer mask and the cast: y has
// one owner per element and the same bits on every run. A cluster along F
// reducing through distributed shared memory would save that round trip but
// needs the (64, d) fp32 partial of every block in shared memory beside the
// ring. The (rows, F) hidden activation never reaches device memory. What
// bounds it now is latency, not the tensor cores: one block of 256 threads
// fits on an SM (197 KB of shared memory, up to 212 registers), and its
// swish epilogue and the store of its fp32 partial take about as long as its
// two products; the partials (7-21 MB) cross L2 twice.
//
// Backward, bf16 (the training path), redesigned for Hopper's tensor cores
// against the four things that held the first version back (a grid of N / 32
// blocks, 38 at d = 360; every block re-reading and re-casting all of W1 and
// W2 from fp32; weight gradients added with tens of millions of fp32 atomics;
// 16-row mma.sync tiles): the weights are cast to bf16 once per call; every
// product runs as `wgmma` on 64-row warpgroup tiles fed by TMA loads into a
// ring of shared-memory stages (hopper.cuh); the hidden dimension is split
// across blocks as well as the rows, so (1216, 360, 1440) runs 437 blocks;
// and du, s m_inner and their transposes go through bf16 scratch (7-14 MB at
// the step's shapes, within the L2's reach) so that dW1, dW2 and dh are
// products with one owner per output tile and every sum has a fixed order.
// The stages are listed where the bf16 backward's kernels begin.
//
// fp32 inputs (the verification path) run every product as fp32 FMAs on a
// 4 x 4 register tile per thread (`ffn_fwd_kernel`, `ffn_bwd_kernel`) with the
// forward's row-block design; that backward accumulates the weight gradients
// across row blocks with atomicAdd into zeroed fp32 buffers, so their last
// bits vary from run to run there; its forward walks F in chunks of 64
// columns per block of 32 rows. Operands are rounded to bf16 exactly where
// the TPU kernel casts them.

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BM = 32;        // token rows per block
constexpr int FC = 64;        // hidden columns per chunk
constexpr int THREADS = 128;  // FMA path: 8 x 16 threads
constexpr uint32_t SEED_STRIDE = 1103515245u;
constexpr uint32_t DRAW_INNER = 0x9E3779B9u;  // draw 1: mask on swish(u)
constexpr uint32_t DRAW_OUTER = 0x3C6EF372u;  // draw 2: 2 * 0x9E3779B9 mod 2^32

struct Drop {
  uint32_t seed, thr;
  float inv_keep;
  int on;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Multiplier (0 or 1/keep) of element (row, col) of an (N, ncols) tensor.
__device__ __forceinline__ float drop_mult(const Drop& dr, int row, int col, int ncols,
                                           uint32_t draw) {
  if (!dr.on) return 1.f;
  const uint32_t base = dr.seed + (uint32_t)(row >> 8) * SEED_STRIDE;
  const uint32_t flat = (uint32_t)(row & 255) * (uint32_t)ncols + (uint32_t)col;
  const uint32_t bits = mix32(flat ^ mix32(base + draw));
  return bits < dr.thr ? dr.inv_keep : 0.f;
}

// drop_mult with the row's tile key mix32(seed + (row >> 8) SEED_STRIDE +
// draw) already computed.
__device__ __forceinline__ float drop_bits(const Drop& dr, uint32_t key, int row, int col,
                                           int ncols) {
  if (!dr.on) return 1.f;
  const uint32_t flat = (uint32_t)(row & 255) * (uint32_t)ncols + (uint32_t)col;
  return mix32(flat ^ key) < dr.thr ? dr.inv_keep : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LayerNorm of the block's rows into hs (fp32 values already rounded to T);
// columns d .. ldh-1 are zeroed. Rows past n are treated as zeros.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* __restrict__ x, const float* __restrict__ ln_w,
                                        const float* __restrict__ ln_b, float* hs, int ldh,
                                        int row0, int n, int d, float eps, float* mean_s,
                                        float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    const T* xr = x + (size_t)row * d;
    float sum = 0.f;
    if (row < n)
      for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
    if (row < n)
      for (int c = lane; c < d; c += 32) {
        const float dv = to_f(xr[c]) - mean;
        sq += dv * dv;
      }
    const float var = warp_sum(sq) / d;
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < ldh; c += 32) {
      float h = 0.f;
      if (c < d) {
        const float xv = row < n ? to_f(xr[c]) : 0.f;
        const float xhat = rnd<T>((xv - mean) * rstd);
        h = rnd<T>(rnd<T>(xhat * rnd<T>(ln_w[c])) + rnd<T>(ln_b[c]));
      }
      hs[r * ldh + c] = h;
    }
    if (lane == 0 && mean_s != nullptr) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

// u[i][j] = sum_k hs[row][k] * W1[c0 + col][k] for this thread's tile.
template <typename T>
__device__ __forceinline__ void hidden_chunk(float (&u)[4][4], const float* hs, int ldh,
                                             const float* __restrict__ w1, float* bs, int c0,
                                             int d, int f) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < d; k0 += 64) {
    stage_transposed<T, FC, 64>(bs, w1, d, c0, f, k0, d);
    __syncthreads();
    mma_rk(u, hs + ty * 4 * ldh + k0, ldh, bs + tx * 4, TS, 64);
    __syncthreads();
  }
}

template <typename T, int NCB>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y, int n, int d, int f, float eps,
               Drop dr) {
  constexpr int ldh = NCB * 64 + 4;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;            // [BM][ldh] normalised input
  float* ss = hs + BM * ldh;   // [BM][TS]  swish chunk
  float* bs = ss + BM * TS;    // [64][TS]  staged weight tile
  const int row0 = blockIdx.x * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  ln_rows<T>(x, ln_w, ln_b, hs, ldh, row0, n, d, eps, nullptr, nullptr);
  __syncthreads();

  float acc[NCB][4][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[cb][i][j] = 0.f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    float u[4][4] = {};
    hidden_chunk<T>(u, hs, ldh, w1, bs, c0, d, f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j, row = row0 + ty * 4 + i;
        float s = 0.f;
        if (col < f) {
          const float uu = u[i][j] + b1[col];
          s = uu / (1.f + expf(-uu));
          s = rnd<T>(s * drop_mult(dr, row, col, f, DRAW_INNER));
        }
        ss[(ty * 4 + i) * TS + tx * 4 + j] = s;
      }
    __syncthreads();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      stage_transposed<T, 64, FC>(bs, w2, f, cb * 64, d, c0, f);
      __syncthreads();
      mma_rk(acc[cb], ss + ty * 4 * TS, TS, bs + tx * 4, TS, FC);
      __syncthreads();
    }
  }

#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cb * 64 + tx * 4 + j, row = row0 + ty * 4 + i;
        if (row < n && col < d) {
          const float v = (acc[cb][i][j] + b2[col]) * drop_mult(dr, row, col, d, DRAW_OUTER);
          y[(size_t)row * d + col] = from_f<T>(v);
        }
      }
}

template <typename T, int NCB>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ln_w,
               const float* __restrict__ ln_b, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2, T* __restrict__ dx,
               float* __restrict__ dln_w, float* __restrict__ dln_b, float* __restrict__ dw1,
               float* __restrict__ db1, float* __restrict__ dw2, float* __restrict__ db2, int n,
               int d, int f, float eps, Drop dr) {
  constexpr int ldh = NCB * 64 + 4;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;             // [BM][ldh] normalised input; dh at the end
  float* gs = hs + BM * ldh;    // [BM][ldh] g * m_outer
  float* sds = gs + BM * ldh;   // [BM][TS]  swish(u) * m_inner chunk
  float* dus = sds + BM * TS;   // [BM][TS]  du chunk
  float* bs = dus + BM * TS;    // [64][TS]  staged weight tile
  float* mean_s = bs + 64 * TS; // [BM]
  float* rstd_s = mean_s + BM;  // [BM]
  float* db1s = rstd_s + BM;    // [FC] this chunk's column sums of du
  const int row0 = blockIdx.x * BM;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  ln_rows<T>(x, ln_w, ln_b, hs, ldh, row0, n, d, eps, mean_s, rstd_s);
  for (int e = tid; e < BM * ldh; e += THREADS) {
    const int r = e / ldh, c = e % ldh, row = row0 + r;
    float v = 0.f;
    if (row < n && c < d)
      v = to_f(g[(size_t)row * d + c]) * drop_mult(dr, row, c, d, DRAW_OUTER);
    gs[e] = v;
  }
  __syncthreads();
  for (int c = tid; c < d; c += THREADS) {
    float sum = 0.f;
    for (int r = 0; r < BM; ++r) sum += gs[r * ldh + c];
    atomicAdd(db2 + c, sum);
  }
  __syncthreads();
  for (int e = tid; e < BM * ldh; e += THREADS) gs[e] = rnd<T>(gs[e]);
  __syncthreads();

  float dh[NCB][4][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dh[cb][i][j] = 0.f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    if (tid < FC) db1s[tid] = 0.f;
    float coef[4][4];
    {
      float u[4][4] = {};
      hidden_chunk<T>(u, hs, ldh, w1, bs, c0, d, f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx * 4 + j, row = row0 + ty * 4 + i;
          float sd = 0.f, cf = 0.f;
          if (col < f) {
            const float uu = u[i][j] + b1[col];
            const float sig = 1.f / (1.f + expf(-uu));
            const float m = drop_mult(dr, row, col, f, DRAW_INNER);
            sd = rnd<T>(uu * sig * m);
            cf = m * (sig + uu * sig * (1.f - sig));
          }
          sds[(ty * 4 + i) * TS + tx * 4 + j] = sd;
          coef[i][j] = cf;
        }
    }
    // ds = (g m_outer) W2[:, chunk]; du = ds * m_inner * swish'(u)
    {
      float ds[4][4] = {};
      for (int k0 = 0; k0 < d; k0 += 64) {
        stage_direct<T, 64, FC>(bs, w2, f, k0, d, c0, f);
        __syncthreads();
        mma_rk(ds, gs + ty * 4 * ldh + k0, ldh, bs + tx * 4, TS, 64);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float colsum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float du = ds[i][j] * coef[i][j];
          colsum += du;
          dus[(ty * 4 + i) * TS + tx * 4 + j] = rnd<T>(du);
        }
        atomicAdd(db1s + tx * 4 + j, colsum);
      }
    }
    __syncthreads();
    if (tid < FC && c0 + tid < f) atomicAdd(db1 + c0 + tid, db1s[tid]);

    // dW2[j][chunk] += sum_r g[r][j] * sd[r][chunk]
    for (int j0 = 0; j0 < d; j0 += BM) {
      float a[4][4] = {};
      mma_kk(a, gs + j0 + ty * 4, ldh, sds + tx * 4, TS, BM);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jr = j0 + ty * 4 + i, col = c0 + tx * 4 + j;
          if (jr < d && col < f) atomicAdd(dw2 + (size_t)jr * f + col, a[i][j]);
        }
    }
    // dW1[chunk][k] += sum_r du[r][chunk] * h[r][k]
    for (int f0 = 0; f0 < FC; f0 += BM) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        float a[4][4] = {};
        mma_kk(a, dus + f0 + ty * 4, TS, hs + cb * 64 + tx * 4, ldh, BM);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int fr = c0 + f0 + ty * 4 + i, col = cb * 64 + tx * 4 + j;
            if (fr < f && col < d) atomicAdd(dw1 + (size_t)fr * d + col, a[i][j]);
          }
      }
    }
    // dh += du W1[chunk, :]
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      stage_direct<T, FC, 64>(bs, w1, d, c0, f, cb * 64, d);
      __syncthreads();
      mma_rk(dh[cb], dus + ty * 4 * TS, TS, bs + tx * 4, TS, FC);
      __syncthreads();
    }
  }

  // LayerNorm backward (pallas_ffn.py:199-204); dh goes through hs.
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hs[(ty * 4 + i) * ldh + cb * 64 + tx * 4 + j] = dh[cb][i][j];
  __syncthreads();
  for (int c = tid; c < d; c += THREADS) {
    float sb = 0.f, sw = 0.f;
    for (int r = 0; r < BM && row0 + r < n; ++r) {
      const float dhv = hs[r * ldh + c];
      const float xhat = (to_f(x[(size_t)(row0 + r) * d + c]) - mean_s[r]) * rstd_s[r];
      sb += dhv;
      sw += dhv * xhat;
    }
    atomicAdd(dln_b + c, sb);
    atomicAdd(dln_w + c, sw);
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    if (row >= n) continue;  // uniform over the warp
    const float mean = mean_s[r], rstd = rstd_s[r];
    const T* xr = x + (size_t)row * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = hs[r * ldh + c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      s1 += dxh;
      s2 += dxh * xhat;
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float dxh = hs[r * ldh + c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      dx[(size_t)row * d + c] = from_f<T>(rstd * (dxh - m1 - xhat * m2));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on Hopper: TMA-fed `wgmma` products (hopper.cuh) in six
// stages on the caller's stream, handing bf16 operands to each other through
// scratch that the wrapper allocates (`avec_ffn_bwd_scratch_bytes`):
//   1 cast     W1 -> W1b (F, d), W1t (d, F); W2 -> W2t (F, d), bf16, once;
//   2 prep     per (64 rows, 64 columns): LN statistics, h and g * m_outer as
//              bf16, row-major (N, d) and transposed (d, N), and the rows'
//              partial sums of g * m_outer (db2);
//   3 hidden   per (64 rows, 64 hidden columns): u = h W1b^T and
//              ds = (g m_outer) W2, both over d; then s m_inner and
//              du = ds m_inner swish'(u) as bf16, du (N, F) and its transpose
//              (F, N), s m_inner transposed (F, N), and the tile's partial
//              column sums of du (db1);
//   4 products three jobs of 64 x 64 output tiles in one launch, each tile
//              with one owner: dW1 = du^T h and dW2 = (g m_outer)^T (s m_inner)
//              over the token rows (split over the rows into a few partial
//              buffers where the tiles alone do not fill the card), and
//              dh = du W1b over F;
//   5 ln       per 16 rows: the LayerNorm backward into dx and the rows'
//              partial sums of dh and dh * xhat;
//   6 reduce   every partial sum added in a fixed order: db1, db2, the LN
//              gradients and, where split, dW1 and dW2.
// No atomics: every output element has one owner and every sum a fixed
// order, so the gradients are the same bits from run to run.

constexpr int WT = 64;                 // edge of a wgmma output tile and of a TMA box
constexpr int WG = 128;                // one warpgroup
constexpr int RING_H = 2;              // stages of the hidden product's ring (4 tiles each)
constexpr int LDE = WT + 8;            // row stride of an epilogue tile
constexpr int LN_ROWS = 16;            // token rows per block of stage 5
constexpr int PREP_THREADS = 256;
constexpr int WAVE_BLOCKS = 264;       // two blocks on each of the 132 SMs

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct BwdScratch {
  bf16 *w1b, *w2t, *w1t;        // weights: (F, ldd), (F, ldd), (d, ldf)
  bf16 *hb, *gb;                // (N, ldd) h and g * m_outer
  bf16 *ht, *gt;                // (d, ldn) their transposes
  bf16 *du, *dut, *sdt;         // (N, ldf) du; (F, ldn) du^T and (s m_inner)^T
  float *mean, *rstd, *dh;      // (N,), (N,), (N, d)
  float *part_db1, *part_db2;   // (rt, F), (rt, d): per 64 rows
  float *part_lnb, *part_lnw;   // (rt_ln, d) x 2: per LN_ROWS rows
  float* part_w;                // (splits, F d) of dW1, then (splits, d F) of dW2
  int ldd, ldf, ldn, rt, rt_ln, splits;
};

// Rows of the weight-gradient products are split into this many partial sums.
int weight_splits(int n, int d, int f) {
  const int tiles = 2 * cdiv(f, WT) * cdiv(d, WT);
  const int by_card = cdiv(WAVE_BLOCKS, tiles);
  const int by_depth = cdiv(n, WT) / 8;  // keep at least 8 k-tiles per split
  const int s = by_card < by_depth ? by_card : by_depth;
  return s < 1 ? 1 : s;
}

// Carves `base` (nullptr: only sizes) into the scratch of one call; returns
// its size in bytes.
size_t carve_bwd(char* base, int n, int d, int f, BwdScratch* s) {
  s->ldd = round8(d);
  s->ldf = round8(f);
  s->ldn = round8(n);
  s->rt = cdiv(n, WT);
  s->rt_ln = cdiv(n, LN_ROWS);
  s->splits = weight_splits(n, d, f);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (bytes + 1023) / 1024 * 1024;
    return p;
  };
  auto tb = [&](size_t elems) { return reinterpret_cast<bf16*>(take(elems * 2)); };
  auto tf = [&](size_t elems) { return reinterpret_cast<float*>(take(elems * 4)); };
  const size_t N = n, D = d, F = f;
  s->w1b = tb(F * s->ldd);
  s->w2t = tb(F * s->ldd);
  s->w1t = tb(D * s->ldf);
  s->hb = tb(N * s->ldd);
  s->gb = tb(N * s->ldd);
  s->ht = tb(D * s->ldn);
  s->gt = tb(D * s->ldn);
  s->du = tb(N * s->ldf);
  s->dut = tb(F * s->ldn);
  s->sdt = tb(F * s->ldn);
  s->mean = tf(N);
  s->rstd = tf(N);
  s->dh = tf(N * D);
  s->part_db1 = tf((size_t)s->rt * F);
  s->part_db2 = tf((size_t)s->rt * D);
  s->part_lnb = tf((size_t)s->rt_ln * D);
  s->part_lnw = tf((size_t)s->rt_ln * D);
  s->part_w = s->splits > 1 ? tf(2 * (size_t)s->splits * F * D) : nullptr;
  return at;
}

// Stage 1. blockIdx.z: 0 -> W1b = bf16(W1), 1 -> W1t = bf16(W1)^T,
// 2 -> W2t = bf16(W2)^T; 32 x 32 tiles through shared memory.
__global__ void __launch_bounds__(256)
ffn_bwd_cast_kernel(const float* __restrict__ w1, const float* __restrict__ w2, BwdScratch s,
                    int d, int f) {
  __shared__ float tile[32][33];
  const int job = blockIdx.z;
  const float* src = job < 2 ? w1 : w2;
  const int rows = job < 2 ? f : d, cols = job < 2 ? d : f;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  if (r0 >= rows || c0 >= cols) return;  // uniform over the block
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int row = r0 + r, col = c0 + tx;
    tile[r][tx] = (row < rows && col < cols) ? src[(size_t)row * cols + col] : 0.f;
  }
  __syncthreads();
  if (job == 0) {
    for (int r = ty; r < 32; r += 8) {
      const int row = r0 + r, col = c0 + tx;
      if (row < rows && col < cols)
        s.w1b[(size_t)row * s.ldd + col] = __float2bfloat16(tile[r][tx]);
    }
    return;
  }
  bf16* dst = job == 1 ? s.w1t : s.w2t;
  const int ld = job == 1 ? s.ldf : s.ldd;
  for (int c = ty; c < 32; c += 8) {
    const int col = c0 + c, row = r0 + tx;
    if (row < rows && col < cols) dst[(size_t)col * ld + row] = __float2bfloat16(tile[tx][c]);
  }
}

// Stage 2: one block per (64 token rows, 64 columns). The block's x rows are
// brought into shared memory in one pass of 16-byte loads for the LN
// statistics (warp w: rows w * 8 .. + 7); then its 4 x 64 threads own a
// column and 16 of the rows each.
__global__ void __launch_bounds__(PREP_THREADS)
ffn_bwd_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b, BwdScratch s,
                    int n, int d, float eps, Drop dr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [rows][d] the block's x rows
  __shared__ float mean_s[WT], rstd_s[WT], red[4][WT];
  __shared__ __align__(16) bf16 hs[WT][LDE], gs[WT][LDE];
  const int row0 = blockIdx.x * WT, c0 = blockIdx.y * WT, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rows = min(WT, n - row0), cols = min(WT, d - c0);

  {
    const bf16* xb = x + (size_t)row0 * d;
    const int nel = rows * d;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
      const int nvec = nel / 8;
      for (int e = tid; e < nvec; e += PREP_THREADS)
        reinterpret_cast<uint4*>(xs)[e] = reinterpret_cast<const uint4*>(xb)[e];
      done = nvec * 8;
    }
    for (int e = done + tid; e < nel; e += PREP_THREADS) xs[e] = xb[e];
  }
  __syncthreads();
  for (int r = warp; r < WT; r += PREP_THREADS / 32) {
    float mean = 0.f, rstd = 0.f;
    if (r < rows) {  // uniform over the warp
      const bf16* xr = xs + r * d;
      float sum = 0.f;
      for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
      mean = warp_sum(sum) / d;
      float sq = 0.f;
      for (int c = lane; c < d; c += 32) {
        const float dv = to_f(xr[c]) - mean;
        sq += dv * dv;
      }
      rstd = rsqrtf(warp_sum(sq) / d + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
      if (r < rows && blockIdx.y == 0) {
        s.mean[row0 + r] = mean;
        s.rstd[row0 + r] = rstd;
      }
    }
  }
  __syncthreads();
  {
    const int cl = tid % WT, rg = tid / WT, c = c0 + cl;
    float gsum = 0.f;
    if (cl < cols) {
      const float w = rnd<bf16>(ln_w[c]), b = rnd<bf16>(ln_b[c]);
      float gv[16];  // all 16 loads in flight before the first use
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = rg * 16 + k;
        gv[k] = r < rows ? to_f(gout[(size_t)(row0 + r) * d + c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = rg * 16 + k, row = row0 + r;
        if (r < rows) {
          const float xhat = rnd<bf16>((to_f(xs[r * d + c]) - mean_s[r]) * rstd_s[r]);
          const float gm = gv[k] * drop_mult(dr, row, c, d, DRAW_OUTER);
          gsum += gm;
          hs[r][cl] = __float2bfloat16(rnd<bf16>(xhat * w) + b);
          gs[r][cl] = __float2bfloat16(gm);
        }
      }
    }
    red[rg][cl] = gsum;
  }
  __syncthreads();
  if (tid < cols)
    s.part_db2[(size_t)blockIdx.x * d + c0 + tid] =
        red[0][tid] + red[1][tid] + red[2][tid] + red[3][tid];
  for (int e = tid; e < WT * WT; e += PREP_THREADS) {
    const int r = e / WT, c = e % WT;
    if (r < rows && c < cols) {
      const size_t o = (size_t)(row0 + r) * s.ldd + c0 + c;
      s.hb[o] = hs[r][c];
      s.gb[o] = gs[r][c];
    }
  }
  for (int e = tid; e < WT * WT; e += PREP_THREADS) {
    const int c = e / WT, r = e % WT;
    if (r < rows && c < cols) {
      const size_t o = (size_t)(c0 + c) * s.ldn + row0 + r;
      s.ht[o] = hs[r][c];
      s.gt[o] = gs[r][c];
    }
  }
}

struct HiddenMaps {
  CUtensorMap h, g, w1, w2t;  // (N, d), (N, d), (F, d), (F, d): boxes of 64 x 64
};

// Stage 3: one warpgroup per (64 rows, 64 hidden columns); blockIdx.x is the
// row tile, blockIdx.y the column tile.
__global__ void __launch_bounds__(WG)
ffn_bwd_hidden_kernel(const __grid_constant__ HiddenMaps maps, const float* __restrict__ b1,
                      BwdScratch s, int n, int d, int f, Drop dr) {
  using namespace hopper;
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);  // RING_H x {h, g, W1b, W2t} tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RING_H * 4 * TILE_BYTES);
  float* red = reinterpret_cast<float*>(bars + RING_H);  // [4][64] column sums of du
  const int tid = threadIdx.x, row0 = blockIdx.x * WT, f0 = blockIdx.y * WT;
  const int kt_n = cdiv(d, WT);

  if (tid == 0) {
    for (int i = 0; i < RING_H; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_stage = [&](int kt) {
    const int st = kt % RING_H;
    bf16* t = ring + st * 4 * TILE_ELEMS;
    mbar_expect_tx(&bars[st], 4 * TILE_BYTES);
    tma_load_2d(t, &maps.h, &bars[st], kt * WT, row0);
    tma_load_2d(t + TILE_ELEMS, &maps.g, &bars[st], kt * WT, row0);
    tma_load_2d(t + 2 * TILE_ELEMS, &maps.w1, &bars[st], kt * WT, f0);
    tma_load_2d(t + 3 * TILE_ELEMS, &maps.w2t, &bars[st], kt * WT, f0);
  };
  if (tid == 0)
    for (int kt = 0; kt < RING_H && kt < kt_n; ++kt) load_stage(kt);

  float u[32], ds[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = ds[i] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % RING_H;
    mbar_wait(&bars[st], (kt / RING_H) & 1);
    const bf16* t = ring + st * 4 * TILE_ELEMS;
    acc_fence(u);
    acc_fence(ds);
    wgmma_fence();
    wgmma_tile_k64(u, t, t + 2 * TILE_ELEMS);                 // h . W1b^T
    wgmma_tile_k64(ds, t + TILE_ELEMS, t + 3 * TILE_ELEMS);  // (g m_outer) . W2t^T
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(u);
    acc_fence(ds);
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (tid == 0 && kt + RING_H < kt_n) load_stage(kt + RING_H);
  }

  // Epilogue; the ring is free, its first 18 KB hold the bf16 output tiles.
  bf16* tdu = ring;             // [64 rows][LDE]  du
  bf16* tsd = ring + WT * LDE;  // [64 cols][LDE]  s m_inner, transposed
  const int w = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
  float csum[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    csum[i][0] = csum[i][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = w * 16 + g + (e >> 1) * 8, cl = i * 8 + 2 * q + (e & 1);
      const int row = row0 + rl, col = f0 + cl;
      float sd = 0.f, du = 0.f;
      if (row < n && col < f) {
        const float uu = u[4 * i + e] + b1[col];
        const float sig = 1.f / (1.f + expf(-uu));
        const float m = drop_mult(dr, row, col, f, DRAW_INNER);
        sd = uu * sig * m;
        du = ds[4 * i + e] * (m * (sig + uu * sig * (1.f - sig)));
      }
      csum[i][e & 1] += du;
      tdu[rl * LDE + cl] = __float2bfloat16(du);
      tsd[cl * LDE + rl] = __float2bfloat16(sd);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float v = csum[i][p];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[w * WT + i * 8 + 2 * q + p] = v;
    }
  __syncthreads();
  if (tid < WT && f0 + tid < f)
    s.part_db1[(size_t)blockIdx.x * f + f0 + tid] =
        red[tid] + red[WT + tid] + red[2 * WT + tid] + red[3 * WT + tid];
  for (int e = tid; e < WT * 8; e += WG) {
    const int r = e >> 3, ch = e & 7, row = row0 + r, col = f0 + ch * 8;
    if (row < n && col < s.ldf)
      *reinterpret_cast<uint4*>(s.du + (size_t)row * s.ldf + col) =
          *reinterpret_cast<const uint4*>(tdu + r * LDE + ch * 8);
  }
  for (int e = tid; e < WT * 8; e += WG) {
    const int fr = e >> 3, ch = e & 7, col = f0 + fr, rr = row0 + ch * 8;
    if (col < f && rr < s.ldn) {
      *reinterpret_cast<uint4*>(s.sdt + (size_t)col * s.ldn + rr) =
          *reinterpret_cast<const uint4*>(tsd + fr * LDE + ch * 8);
      __align__(16) bf16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = tdu[(ch * 8 + j) * LDE + fr];
      *reinterpret_cast<uint4*>(s.dut + (size_t)col * s.ldn + rr) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Stage 5: LN_ROWS token rows per block.
__global__ void __launch_bounds__(PREP_THREADS)
ffn_bwd_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                  bf16* __restrict__ dx, BwdScratch s, int n, int d) {
  const int row0 = blockIdx.x * LN_ROWS, tid = threadIdx.x;
  const int rows = min(LN_ROWS, n - row0);
  for (int c = tid; c < d; c += PREP_THREADS) {
    float dhv[LN_ROWS], xv[LN_ROWS];  // all loads in flight before the first use
#pragma unroll
    for (int r = 0; r < LN_ROWS; ++r) {
      const size_t at = (size_t)(row0 + r) * d + c;
      dhv[r] = r < rows ? s.dh[at] : 0.f;
      xv[r] = r < rows ? to_f(x[at]) : 0.f;
    }
    float sb = 0.f, sw = 0.f;
#pragma unroll
    for (int r = 0; r < LN_ROWS; ++r) {
      if (r < rows) {
        const float xhat = (xv[r] - s.mean[row0 + r]) * s.rstd[row0 + r];
        sb += dhv[r];
        sw += dhv[r] * xhat;
      }
    }
    s.part_lnb[(size_t)blockIdx.x * d + c] = sb;
    s.part_lnw[(size_t)blockIdx.x * d + c] = sw;
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += PREP_THREADS / 32) {
    const int row = row0 + r;
    const float mean = s.mean[row], rstd = s.rstd[row];
    const bf16* xr = x + (size_t)row * d;
    const float* dhr = s.dh + (size_t)row * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dhr[c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      s1 += dxh;
      s2 += dxh * xhat;
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dhr[c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      dx[(size_t)row * d + c] = __float2bfloat16(rstd * (dxh - m1 - xhat * m2));
    }
  }
}

// Stage 6: the partial sums added in a fixed order: one warp per bias or LN
// gradient element over the row blocks (lanes striding, then a fixed shuffle
// tree; blockIdx.x < sum_blocks), and where the weight gradients were split,
// one thread per element over the splits.
__global__ void __launch_bounds__(256)
ffn_bwd_reduce_kernel(BwdScratch s, float* __restrict__ db1, float* __restrict__ db2,
                      float* __restrict__ dln_b, float* __restrict__ dln_w,
                      float* __restrict__ dw1, float* __restrict__ dw2, int d, int f,
                      int sum_blocks) {
  const int lane = threadIdx.x % 32;
  if ((int)blockIdx.x < sum_blocks) {
    const int e = blockIdx.x * 8 + threadIdx.x / 32;
    if (e >= f + 3 * d) return;  // uniform over the warp
    const float* part;
    float* out;
    int at, stride, count;
    if (e < f) {
      part = s.part_db1, out = db1, at = e, stride = f, count = s.rt;
    } else if (e < f + d) {
      part = s.part_db2, out = db2, at = e - f, stride = d, count = s.rt;
    } else if (e < f + 2 * d) {
      part = s.part_lnb, out = dln_b, at = e - f - d, stride = d, count = s.rt_ln;
    } else {
      part = s.part_lnw, out = dln_w, at = e - f - 2 * d, stride = d, count = s.rt_ln;
    }
    float v = 0.f;
    for (int k = lane; k < count; k += 32) v += part[(size_t)k * stride + at];
    v = warp_sum(v);
    if (lane == 0) out[at] = v;
    return;
  }
  const size_t fd = (size_t)f * d;
  const size_t i = (size_t)(blockIdx.x - sum_blocks) * 256 + threadIdx.x;
  if (i >= 2 * fd) return;
  const bool first = i < fd;
  const float* part = s.part_w + (first ? 0 : (size_t)s.splits * fd);
  const size_t at = first ? i : i - fd;
  float v = 0.f;
  for (int k = 0; k < s.splits; ++k) v += part[k * fd + at];
  (first ? dw1 : dw2)[at] = v;
}

// ---------------------------------------------------------------------------
// bf16 forward on Hopper, three stages on the caller's stream over scratch
// that the wrapper allocates (`avec_ffn_fwd_scratch_bytes`):
//   1 prep    W1 -> W1b (F, ldd) and W2 -> W2b (d, ldf), bf16, once per call,
//             both K-major for the products that read them; and h = LN(x)
//             (N, ldd) in bf16, once per row (one warp per row);
//   2 main    per (64 token rows, a range of 64-column hidden chunks): the
//             block's h tiles by TMA into swizzled shared memory, then per
//             pair of chunks u = h W1b^T (one chunk per consumer warpgroup,
//             `wgmma`),
//             s = bf16(swish(u + b1) m_inner) back into shared memory, and
//             y_part += s W2b^T, each warpgroup owning half of d's 64-column
//             tiles; the weight tiles come by TMA through a ring of stages.
//             The fp32 partial (rows, d) of the block's hidden range goes to
//             scratch;
//   3 reduce  y = bf16((sum of the partials in split order + b2) m_outer).
// The hidden dimension is split over the grid so that every width fills the
// card; no atomics, so y is the same bits on every run.

constexpr int FWD_THREADS = 256;        // two consumer warpgroups
constexpr int FWD_TARGET_BLOCKS = 132;  // one block on each SM

// Ring stages of two weight tiles each: one round's W2 slots (2 NDH <= 6)
// and a W1 phase (NDT <= 6) fit, so a phase never waits on its own refills.
constexpr int FWD_RING = 8;

struct FwdScratch {
  bf16 *w1b, *w2b, *h;  // (F, ldd), (d, ldf), (N, ldd)
  float* part;          // (splits, N, d)
  int ldd, ldf, splits, chunks;
};

// Splits of the hidden chunk pairs over the grid. A block costs about one
// fixed part (its first loads, the store of its partial) plus one part per
// pair of chunks, FWD_FIXED : FWD_PAIR (thousands of cycles, clock64()
// inside one block on the H100); with one block on each SM a launch takes
// its waves times the slowest block. Among the splits whose grid fills the
// SMs (where the rows allow it) the cheapest is taken.
constexpr int FWD_FIXED = 6, FWD_PAIR = 11;
constexpr int FWD_LN_ROWS = 8;  // token rows per block of the LayerNorm in stage 1

int fwd_splits(int n, int f) {
  const int rt = cdiv(n, 64), pairs = cdiv(cdiv(f, 64), 2);
  const bool can_fill = (long long)rt * pairs >= FWD_TARGET_BLOCKS;
  int best = 1;
  long long best_cost = -1;
  for (int sp = 1; sp <= pairs; ++sp) {
    const long long blocks = (long long)rt * sp;
    if (can_fill && blocks < FWD_TARGET_BLOCKS) continue;
    const long long cost = cdiv((int)blocks, FWD_TARGET_BLOCKS) *
                           (long long)(FWD_FIXED + cdiv(pairs, sp) * FWD_PAIR);
    if (best_cost < 0 || cost < best_cost) {
      best = sp;
      best_cost = cost;
    }
  }
  return best;
}

size_t carve_fwd(char* base, int n, int d, int f, FwdScratch* s) {
  s->ldd = round8(d);
  s->ldf = round8(f);
  s->chunks = cdiv(f, 64);
  s->splits = fwd_splits(n, f);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + at;
    at += (bytes + 1023) / 1024 * 1024;
    return p;
  };
  s->w1b = reinterpret_cast<bf16*>(take((size_t)f * s->ldd * 2));
  s->w2b = reinterpret_cast<bf16*>(take((size_t)d * s->ldf * 2));
  s->h = reinterpret_cast<bf16*>(take((size_t)n * s->ldd * 2));
  s->part = reinterpret_cast<float*>(take((size_t)s->splits * n * d * 4));
  return at;
}

// Stage 1. Blocks below cast_blocks: W1b, then W2b, element by element
// (rows padded to ld, the padding never read: the tensor maps carry the true
// widths). The rest: LayerNorm of FWD_LN_ROWS token rows, one warp per row,
// rounded as the TPU kernel rounds it (pallas_ffn.py:62-73): lane l sums the
// columns l + 32 k in order, then a fixed shuffle tree.
template <int NDT>
__global__ void __launch_bounds__(256)
ffn_fwd_prep_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, const float* __restrict__ w1,
                    const float* __restrict__ w2, FwdScratch s, int n, int d, int f, float eps,
                    int cast_blocks) {
  if ((int)blockIdx.x < cast_blocks) {
    const int fd = f * d;
    for (int i = blockIdx.x * 256 + threadIdx.x; i < 2 * fd; i += cast_blocks * 256) {
      if (i < fd)
        s.w1b[(i / d) * s.ldd + i % d] = __float2bfloat16(w1[i]);
      else
        s.w2b[((i - fd) / f) * s.ldf + (i - fd) % f] = __float2bfloat16(w2[i - fd]);
    }
    return;
  }
  constexpr int KC = 2 * NDT;
  const int lane = threadIdx.x % 32;
  const int row = (blockIdx.x - cast_blocks) * FWD_LN_ROWS + threadIdx.x / 32;
  if (row >= n) return;  // uniform over the warp
  const bf16* xr = x + (size_t)row * d;
  float xv[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    xv[k] = c < d ? to_f(xr[c]) : 0.f;
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k) sum += xv[k];
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (lane + 32 * k < d) sq += (xv[k] - mean) * (xv[k] - mean);
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int c = lane + 32 * k;
    if (c < d)
      s.h[(size_t)row * s.ldd + c] = __float2bfloat16(
          rnd<bf16>(rnd<bf16>((xv[k] - mean) * rstd) * rnd<bf16>(ln_w[c])) + rnd<bf16>(ln_b[c]));
  }
}

struct FwdMaps {
  CUtensorMap w1, w2, h;  // W1b (F, d), W2b (d, F), h (N, d): boxes of 64 x 64
};

template <int NDT> constexpr size_t fwd_wgmma_smem() {
  return 1024 + (size_t)(NDT + 2 + 2 * FWD_RING) * hopper::TILE_BYTES + (FWD_RING + 1) * 8;
}

// Stage 2. blockIdx.x: 64-row tile; blockIdx.y: split of the hidden chunks.
// NDT = cdiv(d, 64), NDH = cdiv(NDT, 2). Slots of the ring, two tiles each,
// per pair of chunks (ca, cb): NDT slots {W1b(ca, kt), W1b(cb, kt)}, then
// NDH slots {W2b(2j, ca), W2b(2j + 1, ca)} and, when cb exists, NDH slots
// {W2b(2j, cb), W2b(2j + 1, cb)}; warpgroup w reads tile w of each (its
// chunk, its d tile 2j + w). Only the block's last pair may lack cb.
template <int NDT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
ffn_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, const float* __restrict__ b1,
                     FwdScratch s, int n, int d, int f, Drop dr) {
  using namespace hopper;
  constexpr int NDH = (NDT + 1) / 2, PER = NDT + 2 * NDH, RING = FWD_RING;
  unsigned char* base = smem_base_1k();
  bf16* hs = reinterpret_cast<bf16*>(base);  // NDT tiles: h, swizzled
  bf16* ss = hs + NDT * TILE_ELEMS;           // 2 tiles: s of chunks ca, cb
  bf16* ring = ss + 2 * TILE_ELEMS;           // RING x 2 tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + RING * 2 * TILE_ELEMS);
  uint64_t* hbar = bars + RING;               // the h tiles
  const int tid = threadIdx.x, wg = tid / WG, wt = tid % WG;
  const int row0 = blockIdx.x * 64, split = blockIdx.y, rows = min(64, n - row0);
  const int pairs = cdiv(s.chunks, 2);
  const int c_begin = 2 * (split * pairs / s.splits);
  const int c_end = min(s.chunks, 2 * ((split + 1) * pairs / s.splits));
  const int rounds = cdiv(c_end - c_begin, 2);
  const int slots = rounds * PER - ((c_end - c_begin) % 2) * NDH;
  // 64 | 256: the block's rows share one hash tile, so one key (drop_mult)
  const uint32_t key = mix32(dr.seed + (uint32_t)(row0 >> 8) * SEED_STRIDE + DRAW_INNER);

  // Slot q's loads (thread 0 only).
  auto issue = [&](int q) {
    const int st = q % RING, sub = q % PER, ca = c_begin + 2 * (q / PER);
    bf16* t = ring + st * 2 * TILE_ELEMS;
    if (sub < NDT) {
      const bool has_b = ca + 1 < c_end;
      mbar_expect_tx(&bars[st], (has_b ? 2 : 1) * TILE_BYTES);
      tma_load_2d(t, &maps.w1, &bars[st], sub * 64, ca * 64);
      if (has_b) tma_load_2d(t + TILE_ELEMS, &maps.w1, &bars[st], sub * 64, (ca + 1) * 64);
    } else {
      const int chunk = ca + (sub - NDT) / NDH, j = (sub - NDT) % NDH;
      const bool has_hi = 2 * j + 1 < NDT;
      mbar_expect_tx(&bars[st], (has_hi ? 2 : 1) * TILE_BYTES);
      tma_load_2d(t, &maps.w2, &bars[st], chunk * 64, 2 * j * 64);
      if (has_hi) tma_load_2d(t + TILE_ELEMS, &maps.w2, &bars[st], chunk * 64, (2 * j + 1) * 64);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= RING; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(hbar, NDT * TILE_BYTES);
    for (int kt = 0; kt < NDT; ++kt)
      tma_load_2d(hs + kt * TILE_ELEMS, &maps.h, hbar, kt * 64, row0);
    for (int q = 0; q < RING && q < slots; ++q) issue(q);
  }
  __syncthreads();
  mbar_wait(hbar, 0);

  float y[NDH][32];
#pragma unroll
  for (int j = 0; j < NDH; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[j][i] = 0.f;
  const int w4 = wt / 32, g = (wt % 32) >> 2, qd = wt & 3;

  // Each phase (the NDT W1 slots of a round, then its W2 slots) issues all
  // its products as their tiles arrive and waits for them once; its slots
  // are refilled together after the block's barrier.
  for (int rd = 0; rd < rounds; ++rd) {
    const int ca = c_begin + 2 * rd, chunk = ca + wg;
    const bool has_b = ca + 1 < c_end, mine = wg == 0 || has_b;
    float u[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) u[i] = 0.f;
    const int q1 = rd * PER;
    acc_fence(u);
    for (int kt = 0; kt < NDT; ++kt) {
      const int q = q1 + kt, st = q % RING;
      mbar_wait(&bars[st], (q / RING) & 1);
      if (mine) {
        wgmma_fence();
        wgmma_tile_k64(u, hs + kt * TILE_ELEMS, ring + (st * 2 + wg) * TILE_ELEMS);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(u);
    __syncthreads();
    if (tid == 0)
      for (int q = q1; q < q1 + NDT; ++q)
        if (q + RING < slots) issue(q + RING);
    // s = bf16(swish(u + b1) m_inner) (pallas_ffn.py:130-135) into tile wg;
    // b1 and the hash key of the block's 256-row tile are read first.
    if (mine) {
      bf16* st_tile = ss + wg * TILE_ELEMS;
      float bias[16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int col = chunk * 64 + i * 8 + 2 * qd + p;
          bias[2 * i + p] = col < f ? b1[col] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int rl = w4 * 16 + g + hf * 8, cl = i * 8 + 2 * qd;
          float sv[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int col = chunk * 64 + cl + p;
            const float uu = u[4 * i + 2 * hf + p] + bias[2 * i + p];
            const float sw = uu / (1.f + expf(-uu));  // swish
            sv[p] = col < f ? sw * drop_bits(dr, key, row0 + rl, col, f) : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(st_tile + sw128_at(rl, cl)) =
              __floats2bfloat162_rn(sv[0], sv[1]);
        }
    }
    fence_proxy_async();
    __syncthreads();
    const int q2 = q1 + NDT, n2 = (1 + has_b) * NDH;
#pragma unroll
    for (int j = 0; j < NDH; ++j) acc_fence(y[j]);
    for (int half = 0; half < 1 + has_b; ++half)
#pragma unroll
      for (int j = 0; j < NDH; ++j) {
        const int q = q2 + half * NDH + j, st = q % RING;
        mbar_wait(&bars[st], (q / RING) & 1);
        if (2 * j + wg < NDT) {
          wgmma_fence();
          wgmma_tile_k64(y[j], ss + half * TILE_ELEMS, ring + (st * 2 + wg) * TILE_ELEMS);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NDH; ++j) acc_fence(y[j]);
    __syncthreads();
    if (tid == 0)
      for (int q = q2; q < q2 + n2; ++q)
        if (q + RING < slots) issue(q + RING);
  }

  // The fp32 partial goes through the (now idle) ring, so that its stores
  // to scratch are whole rows.
  constexpr int LDY = NDT * 64 + 4;
  float* ys = reinterpret_cast<float*>(ring);  // [64][LDY]
#pragma unroll
  for (int j = 0; j < NDH; ++j) {
    const int dt = 2 * j + wg;
    if (dt >= NDT) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(ys + (w4 * 16 + g + hf * 8) * LDY + dt * 64 + i * 8 + 2 * qd) =
            make_float2(y[j][4 * i + 2 * hf], y[j][4 * i + 2 * hf + 1]);
  }
  __syncthreads();
  float* part = s.part + ((size_t)split * n + row0) * d;
  if (d % 4 == 0) {
    const int d4 = d / 4;
    for (int i = tid; i < rows * d4; i += FWD_THREADS) {
      const int r = i / d4, c = 4 * (i - r * d4);
      *reinterpret_cast<float4*>(part + (size_t)r * d + c) =
          *reinterpret_cast<const float4*>(ys + r * LDY + c);
    }
  } else {
    for (int i = tid; i < rows * d; i += FWD_THREADS) {
      const int r = i / d, c = i - r * d;
      part[i] = ys[r * LDY + c];
    }
  }
}

// Stage 3: one thread per element of y, the splits summed in order.
__global__ void __launch_bounds__(256)
ffn_fwd_reduce_kernel(FwdScratch s, const float* __restrict__ b2, bf16* __restrict__ y, int n,
                      int d, Drop dr) {
  const size_t total = (size_t)n * d, stride = total;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (size_t)gridDim.x * 256) {
    float v = 0.f;
    for (int k = 0; k < s.splits; ++k) v += s.part[k * stride + i];
    const int row = (int)(i / d), col = (int)(i % d);
    y[i] = __float2bfloat16((v + b2[col]) * drop_mult(dr, row, col, d, DRAW_OUTER));
  }
}

constexpr size_t fwd_smem(int ncb) {
  return sizeof(float) * (size_t)(BM * (ncb * 64 + 4) + BM * TS + 64 * TS);
}
constexpr size_t bwd_smem(int ncb) {
  return sizeof(float) * (size_t)(2 * BM * (ncb * 64 + 4) + 2 * BM * TS + 64 * TS + 2 * BM + FC);
}
constexpr size_t hidden_smem() {
  return 1024 + RING_H * 4 * hopper::TILE_BYTES + RING_H * 8 + 4 * WT * 4;
}

struct FwdArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *w2, *b2;
  void* y;
};
struct BwdArgs {
  const void *x, *g, *ln_w, *ln_b, *w1, *b1, *w2;
  void *dx, *dln_w, *dln_b, *dw1, *db1, *dw2, *db2;
};

template <typename T, int NCB>
cudaError_t launch_fwd(const FwdArgs& a, int n, int d, int f, float eps, Drop dr,
                       cudaStream_t stream) {
  auto kern = ffn_fwd_kernel<T, NCB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)fwd_smem(NCB));
  if (rc != cudaSuccess) return rc;
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  kern<<<(n + BM - 1) / BM, THREADS, fwd_smem(NCB), stream>>>(
      static_cast<const T*>(a.x), fp(a.ln_w), fp(a.ln_b), fp(a.w1), fp(a.b1), fp(a.w2),
      fp(a.b2), static_cast<T*>(a.y), n, d, f, eps, dr);
  return cudaGetLastError();
}

template <typename T, int NCB>
cudaError_t launch_bwd(const BwdArgs& a, int n, int d, int f, float eps, Drop dr,
                       cudaStream_t stream) {
  auto kern = ffn_bwd_kernel<T, NCB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bwd_smem(NCB));
  if (rc != cudaSuccess) return rc;
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  kern<<<(n + BM - 1) / BM, THREADS, bwd_smem(NCB), stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g), fp(a.ln_w), fp(a.ln_b), fp(a.w1),
      fp(a.b1), fp(a.w2), static_cast<T*>(a.dx), fm(a.dln_w), fm(a.dln_b), fm(a.dw1),
      fm(a.db1), fm(a.dw2), fm(a.db2), n, d, f, eps, dr);
  return cudaGetLastError();
}

#define AVEC_CHECK(call)                        \
  do {                                          \
    const cudaError_t rc_ = (call);             \
    if (rc_ != cudaSuccess) return rc_;         \
  } while (0)

template <int NDT>
cudaError_t launch_fwd(const FwdMaps& maps, const FwdArgs& a, const FwdScratch& s, int n, int d,
                       int f, float eps, Drop dr, cudaStream_t st) {
  const int cast_blocks = cdiv(2 * f * d, 256 * 8);
  ffn_fwd_prep_kernel<NDT><<<cast_blocks + cdiv(n, FWD_LN_ROWS), 256, 0, st>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.ln_w),
      static_cast<const float*>(a.ln_b), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.w2), s, n, d, f, eps, cast_blocks);
  AVEC_CHECK(cudaGetLastError());
  auto kern = ffn_fwd_wgmma_kernel<NDT>;
  AVEC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)fwd_wgmma_smem<NDT>()));
  kern<<<dim3(cdiv(n, WT), s.splits), FWD_THREADS, fwd_wgmma_smem<NDT>(), st>>>(
      maps, static_cast<const float*>(a.b1), s, n, d, f, dr);
  AVEC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

// The three stages of the bf16 forward.
cudaError_t launch_fwd_wgmma(const FwdArgs& a, int n, int d, int f, float eps, Drop dr,
                             void* scratch, cudaStream_t st) {
  FwdScratch s;
  carve_fwd(static_cast<char*>(scratch), n, d, f, &s);
  FwdMaps maps;
  if (!hopper::tensor_map_2d(&maps.w1, s.w1b, f, d, s.ldd, WT) ||
      !hopper::tensor_map_2d(&maps.w2, s.w2b, d, f, s.ldf, WT) ||
      !hopper::tensor_map_2d(&maps.h, s.h, n, d, s.ldd, WT))
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaErrorInvalidValue;
  switch (cdiv(d, WT)) {
    case 1: rc = launch_fwd<1>(maps, a, s, n, d, f, eps, dr, st); break;
    case 2: rc = launch_fwd<2>(maps, a, s, n, d, f, eps, dr, st); break;
    case 3: rc = launch_fwd<3>(maps, a, s, n, d, f, eps, dr, st); break;
    case 4: rc = launch_fwd<4>(maps, a, s, n, d, f, eps, dr, st); break;
    case 5: rc = launch_fwd<5>(maps, a, s, n, d, f, eps, dr, st); break;
    case 6: rc = launch_fwd<6>(maps, a, s, n, d, f, eps, dr, st); break;
  }
  AVEC_CHECK(rc);
  const int blocks = (int)((((size_t)n * d + 255) / 256 + 3) / 4);
  ffn_fwd_reduce_kernel<<<blocks, 256, 0, st>>>(s, static_cast<const float*>(a.b2),
                                               static_cast<bf16*>(a.y), n, d, dr);
  return cudaGetLastError();
}

// The six stages of the bf16 backward.
cudaError_t launch_bwd_wgmma(const BwdArgs& a, int n, int d, int f, float eps, Drop dr,
                             void* scratch, cudaStream_t st) {
  using hopper::tensor_map_2d;
  BwdScratch s;
  carve_bwd(static_cast<char*>(scratch), n, d, f, &s);
  const bf16* x = static_cast<const bf16*>(a.x);
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };

  HiddenMaps hm;
  hopper::ProductMaps<3> pm;
  const bool maps_ok =
      tensor_map_2d(&hm.h, s.hb, n, d, s.ldd, WT) && tensor_map_2d(&hm.g, s.gb, n, d, s.ldd, WT) &&
      tensor_map_2d(&hm.w1, s.w1b, f, d, s.ldd, WT) &&
      tensor_map_2d(&hm.w2t, s.w2t, f, d, s.ldd, WT) &&
      tensor_map_2d(&pm.a[0], s.dut, f, n, s.ldn, WT) &&
      tensor_map_2d(&pm.b[0], s.ht, d, n, s.ldn, WT) &&
      tensor_map_2d(&pm.a[1], s.gt, d, n, s.ldn, WT) &&
      tensor_map_2d(&pm.b[1], s.sdt, f, n, s.ldn, WT) &&
      tensor_map_2d(&pm.a[2], s.du, n, f, s.ldf, WT) &&
      tensor_map_2d(&pm.b[2], s.w1t, d, f, s.ldf, WT);
  if (!maps_ok) return cudaErrorInvalidValue;

  const long long fd = (long long)f * d;
  hopper::ProductJobs<3> jobs;
  const int sp = s.splits;
  jobs.job[0] = {f, d, n, sp, cdiv(d, WT), 0, sp > 1 ? s.part_w : fm(a.dw1), d};
  jobs.job[1] = {d, f, n, sp, cdiv(f, WT), 0, sp > 1 ? s.part_w + sp * fd : fm(a.dw2), f};
  jobs.job[2] = {n, d, f, 1, cdiv(d, WT), 0, s.dh, d};
  const int blocks = hopper::product_blocks(&jobs);

  const int tiles32 = cdiv(d > f ? d : f, 32);
  ffn_bwd_cast_kernel<<<dim3(tiles32, tiles32, 3), 256, 0, st>>>(fp(a.w1), fp(a.w2), s, d, f);
  AVEC_CHECK(cudaGetLastError());

  const int prep_smem = WT * d * (int)sizeof(bf16);
  AVEC_CHECK(cudaFuncSetAttribute(ffn_bwd_prep_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, prep_smem));
  ffn_bwd_prep_kernel<<<dim3(s.rt, cdiv(d, WT)), PREP_THREADS, prep_smem, st>>>(
      x, static_cast<const bf16*>(a.g), fp(a.ln_w), fp(a.ln_b), s, n, d, eps, dr);
  AVEC_CHECK(cudaGetLastError());

  AVEC_CHECK(cudaFuncSetAttribute(ffn_bwd_hidden_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)hidden_smem()));
  ffn_bwd_hidden_kernel<<<dim3(cdiv(n, WT), cdiv(f, WT)), WG, hidden_smem(), st>>>(
      hm, fp(a.b1), s, n, d, f, dr);
  AVEC_CHECK(cudaGetLastError());

  AVEC_CHECK(cudaFuncSetAttribute(hopper::wgmma_products_kernel<3>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)hopper::PRODUCT_SMEM));
  hopper::wgmma_products_kernel<3><<<blocks, WG, hopper::PRODUCT_SMEM, st>>>(pm, jobs);
  AVEC_CHECK(cudaGetLastError());

  ffn_bwd_ln_kernel<<<s.rt_ln, PREP_THREADS, 0, st>>>(x, fp(a.ln_w), static_cast<bf16*>(a.dx),
                                                      s, n, d);
  AVEC_CHECK(cudaGetLastError());

  const int sum_blocks = cdiv(f + 3 * d, 8);
  const int w_blocks = sp > 1 ? (int)((2 * fd + 255) / 256) : 0;
  ffn_bwd_reduce_kernel<<<sum_blocks + w_blocks, 256, 0, st>>>(
      s, fm(a.db1), fm(a.db2), fm(a.dln_b), fm(a.dln_w), fm(a.dw1), fm(a.dw2), d, f, sum_blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const FwdArgs& a, int n, int d, int f, float eps, Drop dr,
                         cudaStream_t s) {
  if (d <= 192) return launch_fwd<T, 3>(a, n, d, f, eps, dr, s);
  if (d <= 256) return launch_fwd<T, 4>(a, n, d, f, eps, dr, s);
  if (d <= 384) return launch_fwd<T, 6>(a, n, d, f, eps, dr, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bwd(const BwdArgs& a, int n, int d, int f, float eps, Drop dr,
                         cudaStream_t s) {
  if (d <= 192) return launch_bwd<T, 3>(a, n, d, f, eps, dr, s);
  if (d <= 256) return launch_bwd<T, 4>(a, n, d, f, eps, dr, s);
  if (d <= 384) return launch_bwd<T, 6>(a, n, d, f, eps, dr, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (n, d) of one dtype (fp32 or bf16); parameters fp32, W1 (f, d),
// W2 (d, f). Dropout is on when use_drop != 0: keep iff hash bits < thr,
// multiplier inv_keep. bf16 uses `scratch`, a device buffer of
// avec_ffn_fwd_scratch_bytes (256-byte aligned); fp32 needs none. Returns
// the launches' cudaError_t.
extern "C" int avec_ffn_fwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y,
                            void* scratch, int n, int d, int f, float eps, int use_drop,
                            unsigned seed, unsigned thr, float inv_keep, int is_bf16,
                            void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  const FwdArgs a{x, ln_w, ln_b, w1, b1, w2, b2, y};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch_fwd<float>(a, n, d, f, eps, dr, s);
  if (d > 384 || scratch == nullptr) return cudaErrorInvalidValue;
  return launch_fwd_wgmma(a, n, d, f, eps, dr, scratch, s);
}

// Bytes of scratch one forward call needs (0: none, the fp32 path).
extern "C" long long avec_ffn_fwd_scratch_bytes(int n, int d, int f, int is_bf16) {
  if (!is_bf16 || n <= 0 || d <= 0 || f <= 0) return 0;
  FwdScratch s;
  return (long long)carve_fwd(nullptr, n, d, f, &s);
}

// Bytes of scratch one backward call needs (0: none, the fp32 path).
extern "C" long long avec_ffn_bwd_scratch_bytes(int n, int d, int f, int is_bf16) {
  if (!is_bf16 || n <= 0 || d <= 0 || f <= 0) return 0;
  BwdScratch s;
  return (long long)carve_bwd(nullptr, n, d, f, &s);
}

// g, dx: (n, d) in x's dtype; the six parameter gradients are fp32 buffers
// that the call writes whole. The fp32 path zeroes them on the stream and
// adds into them with atomics; the bf16 path writes each element once, using
// `scratch` (a device buffer of avec_ffn_bwd_scratch_bytes, 256-byte
// aligned).
extern "C" int avec_ffn_bwd(const void* x, const void* g, const void* ln_w, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, void* dx,
                            void* dln_w, void* dln_b, void* dw1, void* db1, void* dw2,
                            void* db2, void* scratch, int n, int d, int f, float eps,
                            int use_drop, unsigned seed, unsigned thr, float inv_keep,
                            int is_bf16, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  const BwdArgs a{x, g, ln_w, ln_b, w1, b1, w2, dx, dln_w, dln_b, dw1, db1, dw2, db2};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    void* grads[6] = {dln_w, dln_b, dw1, db1, dw2, db2};
    const size_t sizes[6] = {(size_t)d, (size_t)d, (size_t)f * d, (size_t)f, (size_t)d * f,
                             (size_t)d};
    for (int i = 0; i < 6; ++i) {
      const cudaError_t rc = cudaMemsetAsync(grads[i], 0, sizes[i] * sizeof(float), s);
      if (rc != cudaSuccess) return rc;
    }
    return dispatch_bwd<float>(a, n, d, f, eps, dr, s);
  }
  if (d > 384 || scratch == nullptr) return cudaErrorInvalidValue;
  return launch_bwd_wgmma(a, n, d, f, eps, dr, scratch, s);
}
