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
// What bounds it on the H100: operations. One forward at N=2416, d=256,
// F=1024 is 2.5 GFLOP on 2.5 MB of activations and 2.1 MB of weights (about
// 3 us at the bf16 tensor-core peak, 1.5 us by bytes); the backward is 2.5x
// that. In practice both passes are bound by how fast a block brings the
// weights from L2 into shared memory, since every block walks all of W1 and
// W2: `wgmma`, TMA and a pipelined weight ring are later work.
//
// Design: one block of 128 threads per 32 token rows. The (rows, F) hidden
// activation never exists: F is walked in chunks of 64 columns, each chunk's
// u is built in registers, turned into s in shared memory and folded into
// the output (forward) or into dh and the weight gradients (backward) before
// the next chunk. d = 180 and an N that is no multiple of 32 are handled by
// zero-filled staging and masked stores, with no padded copy in device
// memory. The TPU kernel accumulates the weight gradients across a
// sequential grid; here row blocks run concurrently, so each block adds its
// partial weight and bias gradients into zeroed fp32 buffers with atomicAdd.
// The order of those additions, and so the last bits of the parameter
// gradients, varies from run to run; dx is deterministic.
//
// Two sets of kernels share that design. fp32 inputs (the verification path)
// run every product as fp32 FMAs on a 4 x 4 register tile per thread
// (`ffn_fwd_kernel`, `ffn_bwd_kernel`). bf16 inputs (the training path) run
// them on the tensor cores with `mma.sync.m16n8k16` and fp32 accumulation
// (`ffn_fwd_mma_kernel`, `ffn_bwd_mma_kernel`): operands are rounded to bf16
// exactly where the TPU kernel casts them, and the weights are staged with
// unrolled 16-byte loads.

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
// bf16 inputs: the same two passes on the tensor cores (mma.sync.m16n8k16,
// fp32 accumulation). One block of 128 threads (4 warps) per 32 token rows.
// Warp w owns rows (w % 2) * 16 .. +15; of a 64-column chunk tile it owns
// columns (w / 2) * 32 .. +31, of a d-wide tile the half (w / 2) * DP / 2.
// DP is d padded to a multiple of 16 (zero-filled), so every reduction runs
// in whole k-steps. Operands that a product needs with the token row as its
// reduction index (the weight gradients) are kept transposed as well.

constexpr int LDC = FC + 8;   // row stride of a 64-wide bf16 tile
constexpr int LDT = BM + 8;   // row stride of a transposed (., 32 rows) tile

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

// grad[row][col] += v0 and grad[row][col + 1] += v1 (col even) for a row-major
// (rows, cols) fp32 gradient; one 8-byte atomic when the row length is even.
__device__ __forceinline__ void add_pair(float* grad, int row, int rows, int col, int cols,
                                         float v0, float v1, bool vec) {
  if (row >= rows) return;
  float* p = grad + (size_t)row * cols + col;
  if (vec && col + 1 < cols) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v0, v1));
  } else {
    if (col < cols) atomicAdd(p, v0);
    if (col + 1 < cols) atomicAdd(p + 1, v1);
  }
}

// LayerNorm of the block's rows into hs [BM][ldh] (and hst [DP][LDT] when
// given) as bf16; columns d .. DP-1 are zero.
template <int DP>
__device__ __forceinline__ void ln_rows_bf16(const bf16* __restrict__ x,
                                             const float* __restrict__ ln_w,
                                             const float* __restrict__ ln_b, bf16* hs,
                                             bf16* hst, int row0, int n, int d, float eps,
                                             float* mean_s, float* rstd_s) {
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
      const bf16 hb = __float2bfloat16(h);
      hs[r * ldh + c] = hb;
      if (hst != nullptr) hst[c * LDT + r] = hb;
    }
    if (lane == 0 && mean_s != nullptr) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
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

  ln_rows_bf16<DP>(x, ln_w, ln_b, hs, nullptr, row0, n, d, eps, nullptr, nullptr);
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

template <int DP>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gout,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, bf16* __restrict__ dx,
                   float* __restrict__ dln_w, float* __restrict__ dln_b,
                   float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2,
                   float* __restrict__ db2, int n, int d, int f, float eps, Drop dr) {
  constexpr int ldh = DP + 8, NTW = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* mean_s = reinterpret_cast<float*>(smem_raw);  // [BM]
  float* rstd_s = mean_s + BM;                         // [BM]
  float* db1s = rstd_s + BM;                           // [FC] column sums of du
  bf16* hs = reinterpret_cast<bf16*>(db1s + FC);       // [BM][ldh] normalised input
  bf16* hst = hs + BM * ldh;                           // [DP][LDT] its transpose
  bf16* gs = hst + DP * LDT;                           // [BM][ldh] g * m_outer
  bf16* gst = gs + BM * ldh;                           // [DP][LDT]
  bf16* sds = gst + DP * LDT;                          // [BM][LDC] swish(u) * m_inner
  bf16* sdt = sds + BM * LDC;                          // [FC][LDT]
  bf16* dus = sdt + FC * LDT;                          // [BM][LDC] du chunk
  bf16* dut = dus + BM * LDC;                          // [FC][LDT]
  bf16* wb = dut + FC * LDT;                           // staged weight tile; dh at the end
  const int row0 = blockIdx.x * BM, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int rowb = (warp & 1) * 16, half = warp >> 1;
  const bool vec = weights_vectorizable(w1, w2, d, f);
  const bool vec2 = vec && ((reinterpret_cast<uintptr_t>(dw1) |
                             reinterpret_cast<uintptr_t>(dw2)) & 7) == 0;

  ln_rows_bf16<DP>(x, ln_w, ln_b, hs, hst, row0, n, d, eps, mean_s, rstd_s);
  for (int c = tid; c < DP; c += THREADS) {
    float sum = 0.f;
#pragma unroll 8
    for (int r = 0; r < BM; ++r) {
      const int row = row0 + r;
      float v = 0.f;
      if (c < d && row < n)
        v = to_f(gout[(size_t)row * d + c]) * drop_mult(dr, row, c, d, DRAW_OUTER);
      sum += v;
      const bf16 vb = __float2bfloat16(v);
      gs[r * ldh + c] = vb;
      gst[c * LDT + r] = vb;
    }
    if (c < d) atomicAdd(db2 + c, sum);
  }
  __syncthreads();

  float dh[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[nt][e] = 0.f;

  for (int c0 = 0; c0 < f; c0 += FC) {
    if (tid < FC) db1s[tid] = 0.f;
    stage_bf16<FC, DP, false>(wb, ldh, w1, d, c0, f, 0, d, vec);  // W1[chunk][k]
    __syncthreads();
    float coef[4][4];
    {
      float u[4][4] = {};
      warp_mma<4>(u, hs + rowb * ldh, ldh, wb + half * 32 * ldh, ldh, DP);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = rowb + g + (e >> 1) * 8, cl = half * 32 + nt * 8 + 2 * t + (e & 1);
          const int col = c0 + cl;
          float sd = 0.f, cf = 0.f;
          if (col < f) {
            const float uu = u[nt][e] + b1[col];
            const float sig = 1.f / (1.f + expf(-uu));
            const float m = drop_mult(dr, row0 + rl, col, f, DRAW_INNER);
            sd = uu * sig * m;
            cf = m * (sig + uu * sig * (1.f - sig));
          }
          const bf16 sb = __float2bfloat16(sd);
          sds[rl * LDC + cl] = sb;
          sdt[cl * LDT + rl] = sb;
          coef[nt][e] = cf;
        }
    }
    __syncthreads();
    stage_bf16<DP, FC, true>(wb, ldh, w2, f, 0, d, c0, f, vec);  // W2^T[chunk][j]
    __syncthreads();
    {
      float ds[4][4] = {};
      warp_mma<4>(ds, gs + rowb * ldh, ldh, wb + half * 32 * ldh, ldh, DP);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float colsum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = rowb + g + (e >> 1) * 8, cl = half * 32 + nt * 8 + 2 * t + (e & 1);
          const float du = ds[nt][e] * coef[nt][e];
          colsum[e & 1] += du;
          const bf16 db = __float2bfloat16(du);
          dus[rl * LDC + cl] = db;
          dut[cl * LDT + rl] = db;
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float v = colsum[p];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) atomicAdd(db1s + half * 32 + nt * 8 + 2 * t + p, v);
        }
      }
    }
    __syncthreads();
    if (tid < FC && c0 + tid < f) atomicAdd(db1 + c0 + tid, db1s[tid]);

    // dW2[j][chunk] += sum_r g[r][j] * sd[r][chunk]: 16 rows of j per warp step
    for (int mt = warp; mt < DP / 16; mt += THREADS / 32) {
      float a[8][4] = {};
      warp_mma<8>(a, gst + mt * 16 * LDT, LDT, sdt, LDT, BM);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          add_pair(dw2, mt * 16 + g + p * 8, d, c0 + nt * 8 + 2 * t, f, a[nt][2 * p],
                   a[nt][2 * p + 1], vec2);
    }
    // dW1[chunk][k] += sum_r du[r][chunk] * h[r][k]: warp w owns chunk rows w*16..
    for (int ng = 0; ng < DP / 16; ++ng) {
      float a[2][4] = {};
      warp_mma<2>(a, dut + warp * 16 * LDT, LDT, hst + ng * 16 * LDT, LDT, BM);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          add_pair(dw1, c0 + warp * 16 + g + p * 8, f, ng * 16 + nt * 8 + 2 * t, d, a[nt][2 * p],
                   a[nt][2 * p + 1], vec2);
    }
    // dh += du W1[chunk, :]
    stage_bf16<FC, DP, true>(wb, LDC, w1, d, c0, f, 0, d, vec);  // W1^T[k][chunk]
    __syncthreads();
    warp_mma<NTW>(dh, dus + rowb * LDC, LDC, wb + half * (DP / 2) * LDC, LDC, FC);
    __syncthreads();
  }

  // LayerNorm backward (pallas_ffn.py:199-204); dh goes through shared memory.
  float* dhs = reinterpret_cast<float*>(wb);  // [BM][DP]
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dhs[(rowb + g + (e >> 1) * 8) * DP + half * (DP / 2) + nt * 8 + 2 * t + (e & 1)] =
          dh[nt][e];
  __syncthreads();
  for (int c = tid; c < d; c += THREADS) {
    float sb = 0.f, sw = 0.f;
    for (int r = 0; r < BM && row0 + r < n; ++r) {
      const float dhv = dhs[r * DP + c];
      const float xhat = (to_f(x[(size_t)(row0 + r) * d + c]) - mean_s[r]) * rstd_s[r];
      sb += dhv;
      sw += dhv * xhat;
    }
    atomicAdd(dln_b + c, sb);
    atomicAdd(dln_w + c, sw);
  }
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = row0 + r;
    if (row >= n) continue;  // uniform over the warp
    const float mean = mean_s[r], rstd = rstd_s[r];
    const bf16* xr = x + (size_t)row * d;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dhs[r * DP + c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      s1 += dxh;
      s2 += dxh * xhat;
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float dxh = dhs[r * DP + c] * ln_w[c];
      const float xhat = (to_f(xr[c]) - mean) * rstd;
      dx[(size_t)row * d + c] = __float2bfloat16(rstd * (dxh - m1 - xhat * m2));
    }
  }
}

template <int DP> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * (size_t)(BM * (DP + 8) + BM * LDC + wb_elems<DP>());
}
template <int DP> constexpr size_t bwd_mma_smem() {
  return sizeof(float) * (2 * BM + FC) +
         sizeof(bf16) * (size_t)(2 * BM * (DP + 8) + 2 * DP * LDT + 2 * BM * LDC +
                                 2 * FC * LDT + wb_elems<DP>());
}

constexpr size_t fwd_smem(int ncb) {
  return sizeof(float) * (size_t)(BM * (ncb * 64 + 4) + BM * TS + 64 * TS);
}
constexpr size_t bwd_smem(int ncb) {
  return sizeof(float) * (size_t)(2 * BM * (ncb * 64 + 4) + 2 * BM * TS + 64 * TS + 2 * BM + FC);
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

template <int DP>
cudaError_t launch_bwd_mma(const BwdArgs& a, int n, int d, int f, float eps, Drop dr,
                           cudaStream_t stream) {
  auto kern = ffn_bwd_mma_kernel<DP>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bwd_mma_smem<DP>());
  if (rc != cudaSuccess) return rc;
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  kern<<<(n + BM - 1) / BM, THREADS, bwd_mma_smem<DP>(), stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.g), fp(a.ln_w), fp(a.ln_b),
      fp(a.w1), fp(a.b1), fp(a.w2), static_cast<bf16*>(a.dx), fm(a.dln_w), fm(a.dln_b),
      fm(a.dw1), fm(a.db1), fm(a.dw2), fm(a.db2), n, d, f, eps, dr);
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

// g, dx: (n, d) in x's dtype; the six parameter gradients are fp32 buffers
// that the caller zeroed on the same stream (the kernel adds into them).
extern "C" int avec_ffn_bwd(const void* x, const void* g, const void* ln_w, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, void* dx,
                            void* dln_w, void* dln_b, void* dw1, void* db1, void* dw2,
                            void* db2, int n, int d, int f, float eps, int use_drop,
                            unsigned seed, unsigned thr, float inv_keep, int is_bf16,
                            void* stream) {
  if (n <= 0 || d <= 0 || f <= 0) return cudaErrorInvalidValue;
  const BwdArgs a{x, g, ln_w, ln_b, w1, b1, w2, dx, dln_w, dln_b, dw1, db1, dw2, db2};
  const Drop dr{seed, thr, inv_keep, use_drop};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch_bwd<float>(a, n, d, f, eps, dr, s);
  if (d <= 192) return launch_bwd_mma<192>(a, n, d, f, eps, dr, s);
  if (d <= 256) return launch_bwd_mma<256>(a, n, d, f, eps, dr, s);
  if (d <= 384) return launch_bwd_mma<384>(a, n, d, f, eps, dr, s);
  return cudaErrorInvalidValue;
}
