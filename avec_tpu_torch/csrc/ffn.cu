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
// Forward design: one block of 128 threads per 32 token rows. The (rows, F)
// hidden activation never exists: F is walked in chunks of 64 columns, each
// chunk's u is built in registers, turned into s in shared memory and folded
// into the output before the next chunk. d = 180 and an N that is no
// multiple of 32 are handled by zero-filled staging and masked stores, with no
// padded copy in device memory.
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
// bits vary from run to run there. bf16 forwards run on `mma.sync.m16n8k16`
// (`ffn_fwd_mma_kernel`). Operands are rounded to bf16 exactly where the TPU
// kernel casts them.

#include "hopper.cuh"
#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BM = 32;        // token rows per block
constexpr int FC = 64;        // hidden columns per chunk
constexpr int THREADS = 128;  // FMA path: 8 x 16 threads; tensor-core path: 4 warps
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
// bf16 forward on the tensor cores (mma.sync.m16n8k16, fp32 accumulation).
// One block of 128 threads (4 warps) per 32 token rows. Warp w owns rows
// (w % 2) * 16 .. +15; of a 64-column chunk tile it owns columns
// (w / 2) * 32 .. +31, of a d-wide tile the half (w / 2) * DP / 2. DP is d
// padded to a multiple of 16 (zero-filled), so every reduction runs in whole
// k-steps.

constexpr int LDC = FC + 8;   // row stride of a 64-wide bf16 tile

template <int DP> constexpr int wb_elems() {
  return 64 * (DP + 8) > DP * LDC ? 64 * (DP + 8) : DP * LDC;
}

// 16-byte loads of weight rows need d and F to be multiples of 4 and aligned
// bases; anything else is staged element by element.
__device__ __forceinline__ bool weights_vectorizable(const float* w1, const float* w2, int d,
                                                     int f) {
  return d % 4 == 0 && f % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15) == 0;
}

// LayerNorm of the block's rows into hs [BM][DP + 8] as bf16; columns
// d .. DP-1 are zero.
template <int DP>
__device__ __forceinline__ void ln_rows_bf16(const bf16* __restrict__ x,
                                             const float* __restrict__ ln_w,
                                             const float* __restrict__ ln_b, bf16* hs, int row0,
                                             int n, int d, float eps) {
  constexpr int ldh = DP + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    const bf16* xr = x + (size_t)row * d;
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
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    for (int c = lane; c < DP; c += 32) {
      float h = 0.f;
      if (c < d) {
        const float xv = row < n ? to_f(xr[c]) : 0.f;
        const float xhat = rnd<bf16>((xv - mean) * rstd);
        h = rnd<bf16>(xhat * rnd<bf16>(ln_w[c])) + rnd<bf16>(ln_b[c]);
      }
      hs[r * ldh + c] = __float2bfloat16(h);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                   const float* __restrict__ ln_b, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ y, int n, int d, int f,
                   float eps, Drop dr) {
  constexpr int ldh = DP + 8, NTW = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);  // [BM][ldh] normalised input
  bf16* ss = hs + BM * ldh;                      // [BM][LDC] swish chunk
  bf16* wb = ss + BM * LDC;                      // staged weight tile
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int rowb = (warp & 1) * 16, half = warp >> 1;
  const bool vec = weights_vectorizable(w1, w2, d, f);

  ln_rows_bf16<DP>(x, ln_w, ln_b, hs, row0, n, d, eps);
  __syncthreads();

  float acc[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    stage_bf16<FC, DP, false>(wb, ldh, w1, d, c0, f, 0, d, vec);  // W1[chunk][k]
    __syncthreads();
    float u[4][4] = {};
    warp_mma<4>(u, hs + rowb * ldh, ldh, wb + half * 32 * ldh, ldh, DP);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = rowb + g + (e >> 1) * 8, cl = half * 32 + nt * 8 + 2 * t + (e & 1);
        const int col = c0 + cl;
        float s = 0.f;
        if (col < f) {
          const float uu = u[nt][e] + b1[col];
          s = uu / (1.f + expf(-uu)) * drop_mult(dr, row0 + rl, col, f, DRAW_INNER);
        }
        ss[rl * LDC + cl] = __float2bfloat16(s);
      }
    __syncthreads();
    stage_bf16<DP, FC, false>(wb, LDC, w2, f, 0, d, c0, f, vec);  // W2[j][chunk]
    __syncthreads();
    warp_mma<NTW>(acc, ss + rowb * LDC, LDC, wb + half * (DP / 2) * LDC, LDC, FC);
    __syncthreads();
  }

#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + rowb + g + (e >> 1) * 8;
      const int col = half * (DP / 2) + nt * 8 + 2 * t + (e & 1);
      if (row < n && col < d) {
        const float v = (acc[nt][e] + b2[col]) * drop_mult(dr, row, col, d, DRAW_OUTER);
        y[(size_t)row * d + col] = __float2bfloat16(v);
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
constexpr int WTILE = WT * WT;         // elements of one 64 x 64 bf16 tile
constexpr int WTILE_BYTES = WTILE * 2;
constexpr int WG = 128;                // one warpgroup
constexpr int RING_H = 2;              // stages of the hidden product's ring (4 tiles each)
constexpr int RING_P = 4;              // stages of the weight-gradient ring (2 tiles each)
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

// The 1024-byte-aligned start of the dynamic shared memory.
__device__ __forceinline__ unsigned char* smem_base_1k() {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Stage 3: one warpgroup per (64 rows, 64 hidden columns); blockIdx.x is the
// row tile, blockIdx.y the column tile.
__global__ void __launch_bounds__(WG)
ffn_bwd_hidden_kernel(const __grid_constant__ HiddenMaps maps, const float* __restrict__ b1,
                      BwdScratch s, int n, int d, int f, Drop dr) {
  using namespace hopper;
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);  // RING_H x {h, g, W1b, W2t} tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RING_H * 4 * WTILE_BYTES);
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
    bf16* t = ring + st * 4 * WTILE;
    mbar_expect_tx(&bars[st], 4 * WTILE_BYTES);
    tma_load_2d(t, &maps.h, &bars[st], kt * WT, row0);
    tma_load_2d(t + WTILE, &maps.g, &bars[st], kt * WT, row0);
    tma_load_2d(t + 2 * WTILE, &maps.w1, &bars[st], kt * WT, f0);
    tma_load_2d(t + 3 * WTILE, &maps.w2t, &bars[st], kt * WT, f0);
  };
  if (tid == 0)
    for (int kt = 0; kt < RING_H && kt < kt_n; ++kt) load_stage(kt);

  float u[32], ds[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) u[i] = ds[i] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt % RING_H;
    mbar_wait(&bars[st], (kt / RING_H) & 1);
    const bf16* t = ring + st * 4 * WTILE;
    acc_fence(u);
    acc_fence(ds);
    wgmma_fence();
    wgmma_tile_k64(u, t, t + 2 * WTILE);           // h . W1b^T
    wgmma_tile_k64(ds, t + WTILE, t + 3 * WTILE);  // (g m_outer) . W2t^T
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

// One product of stage 4: out[split][i][j] (fp32, row stride ldo) =
// sum over the split's k of A[i][k] B[j][k], A (m, k) and B (nn, k) read
// through tensor maps.
struct ProductJob {
  int m, nn, k, splits, tiles_n, block0;
  float* out;
  int ldo;
};

struct ProductMaps {
  CUtensorMap a[3], b[3];
};

struct ProductJobs {
  ProductJob job[3];
};

// Stage 4: one warpgroup per 64 x 64 output tile (and row split).
__global__ void __launch_bounds__(WG)
ffn_bwd_products_kernel(const __grid_constant__ ProductMaps maps, ProductJobs jobs) {
  using namespace hopper;
  unsigned char* base = smem_base_1k();
  bf16* ring = reinterpret_cast<bf16*>(base);  // RING_P x {A, B} tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + RING_P * 2 * WTILE_BYTES);
  const int tid = threadIdx.x;
  int j = 0;
  while (j < 2 && (int)blockIdx.x >= jobs.job[j + 1].block0) ++j;
  const ProductJob& jb = jobs.job[j];
  const int local = blockIdx.x - jb.block0;
  const int split = local % jb.splits, tile = local / jb.splits;
  const int m0 = (tile / jb.tiles_n) * WT, n0 = (tile % jb.tiles_n) * WT;
  const int kt_all = cdiv(jb.k, WT), per = cdiv(kt_all, jb.splits);
  const int kt0 = split * per, kt1 = min(kt_all, kt0 + per);
  const CUtensorMap* ma = &maps.a[j];
  const CUtensorMap* mb = &maps.b[j];

  if (tid == 0) {
    for (int i = 0; i < RING_P; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load_stage = [&](int kt) {
    const int st = (kt - kt0) % RING_P;
    bf16* t = ring + st * 2 * WTILE;
    mbar_expect_tx(&bars[st], 2 * WTILE_BYTES);
    tma_load_2d(t, ma, &bars[st], kt * WT, m0);
    tma_load_2d(t + WTILE, mb, &bars[st], kt * WT, n0);
  };
  if (tid == 0)
    for (int kt = kt0; kt < kt1 && kt < kt0 + RING_P; ++kt) load_stage(kt);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % RING_P;
    mbar_wait(&bars[st], ((kt - kt0) / RING_P) & 1);
    const bf16* t = ring + st * 2 * WTILE;
    acc_fence(acc);
    wgmma_fence();
    wgmma_tile_k64(acc, t, t + WTILE);
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(acc);
    __syncthreads();
    if (tid == 0 && kt + RING_P < kt1) load_stage(kt + RING_P);
  }

  float* out = jb.out + (size_t)split * jb.m * jb.ldo;
  const int w = tid / 32, lane = tid % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + w * 16 + g + (e >> 1) * 8, c = n0 + i * 8 + 2 * q + (e & 1);
      if (r < jb.m && c < jb.nn) out[(size_t)r * jb.ldo + c] = acc[4 * i + e];
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

template <int DP> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (size_t)(BM * (DP + 8) + BM * LDC + wb_elems<DP>());
}

constexpr size_t fwd_smem(int ncb) {
  return sizeof(float) * (size_t)(BM * (ncb * 64 + 4) + BM * TS + 64 * TS);
}
constexpr size_t bwd_smem(int ncb) {
  return sizeof(float) * (size_t)(2 * BM * (ncb * 64 + 4) + 2 * BM * TS + 64 * TS + 2 * BM + FC);
}
constexpr size_t hidden_smem() {
  return 1024 + RING_H * 4 * WTILE_BYTES + RING_H * 8 + 4 * WT * 4;
}
constexpr size_t products_smem() { return 1024 + RING_P * 2 * WTILE_BYTES + RING_P * 8; }

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

template <int DP>
cudaError_t launch_fwd_mma(const FwdArgs& a, int n, int d, int f, float eps, Drop dr,
                           cudaStream_t stream) {
  auto kern = ffn_fwd_mma_kernel<DP>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)fwd_mma_smem<DP>());
  if (rc != cudaSuccess) return rc;
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  kern<<<(n + BM - 1) / BM, THREADS, fwd_mma_smem<DP>(), stream>>>(
      static_cast<const bf16*>(a.x), fp(a.ln_w), fp(a.ln_b), fp(a.w1), fp(a.b1), fp(a.w2),
      fp(a.b2), static_cast<bf16*>(a.y), n, d, f, eps, dr);
  return cudaGetLastError();
}

#define AVEC_CHECK(call)                        \
  do {                                          \
    const cudaError_t rc_ = (call);             \
    if (rc_ != cudaSuccess) return rc_;         \
  } while (0)

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
  ProductMaps pm;
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
  ProductJobs jobs;
  const int sp = s.splits;
  jobs.job[0] = {f, d, n, sp, cdiv(d, WT), 0, sp > 1 ? s.part_w : fm(a.dw1), d};
  jobs.job[1] = {d, f, n, sp, cdiv(f, WT), 0, sp > 1 ? s.part_w + sp * fd : fm(a.dw2), f};
  jobs.job[2] = {n, d, f, 1, cdiv(d, WT), 0, s.dh, d};
  int blocks = 0;
  for (int j = 0; j < 3; ++j) {
    jobs.job[j].block0 = blocks;
    blocks += cdiv(jobs.job[j].m, WT) * jobs.job[j].tiles_n * jobs.job[j].splits;
  }

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

  AVEC_CHECK(cudaFuncSetAttribute(ffn_bwd_products_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)products_smem()));
  ffn_bwd_products_kernel<<<blocks, WG, products_smem(), st>>>(pm, jobs);
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
// multiplier inv_keep. Returns the launch's cudaError_t.
extern "C" int avec_ffn_fwd(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* y, int n,
                            int d, int f, float eps, int use_drop, unsigned seed, unsigned thr,
                            float inv_keep, int is_bf16, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  const FwdArgs a{x, ln_w, ln_b, w1, b1, w2, b2, y};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch_fwd<float>(a, n, d, f, eps, dr, s);
  if (d <= 192) return launch_fwd_mma<192>(a, n, d, f, eps, dr, s);
  if (d <= 256) return launch_fwd_mma<256>(a, n, d, f, eps, dr, s);
  if (d <= 384) return launch_fwd_mma<384>(a, n, d, f, eps, dr, s);
  return cudaErrorInvalidValue;
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
