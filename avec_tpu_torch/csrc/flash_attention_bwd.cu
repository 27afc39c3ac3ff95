// Flash rel-pos attention backward for Hopper (sm_90a): dq' and dk'/dV.
//
// Replaces: avec_tpu/ops/pallas_attention.py `_flash_bwd_dq_kernel` (:193,
// pallas_call at :316) and `_flash_bwd_dkv_kernel` (:233, pallas_call at
// :339), reached through the custom VJP of `flash_attention_trainable` (:281).
//
// With s = scale * q' k'^T, the forward's lse and delta = rowsum(dO * O):
//     p   = exp(s - lse)            0 where key >= len or query >= len
//     dV  = p^T dO
//     dS  = p * (dO V^T - delta)
//     dq' = scale * dS k'           dk' = scale * dS^T q'
// Queries at or past the true length get a zero gradient although the forward
// gives them values, and a sequence of length 0 gets all-zero gradients: its
// tiles are skipped, so exp(s - lse) is never evaluated unmasked there. No
// (T, T) tensor reaches device memory.
//
// What bounds it on the H100: operations. At the training shapes (B=16, H=4,
// T=151/76, d_a=321/451, d_v=64/90) one backward recomputes s and dO V^T
// twice and forms three gradient products, about 2*T*len*(4 d_a + 4 d_v) per
// head: a few microseconds at the tensor-core peak on a few MB of operands.
// This first version runs fp32 FMAs on the inputs' values and is bound by
// the fp32 rate and, with 64-192 blocks, by latency.
//
// Design: two kernels, each output tile with one owner, so no atomics and a
// deterministic result. dq: one block of 256 threads per (b*h, 64-query tile)
// streaming 64-key tiles up to the true length; dk'/dV: one block per (b*h,
// 64-key tile) streaming query tiles up to the true length. s and dO V^T are
// built as in the forward kernel (32-wide chunks of d_a staged transposed,
// masked loads for the odd widths 321 and 451, no padded copies); p and dS go
// through shared memory, and the gradient tiles accumulate in registers, 4 x 4
// per thread for each 64-column block of d_a (and of d_v).

#include "tile.cuh"

namespace {

using namespace avec;

constexpr int BT = 64;         // queries / keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 register tile each

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *lengths;
  int heads, t, da, dv;
  float scale;
};

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int t) {
  const int v = lengths[b];
  return v < 0 ? 0 : (v > t ? t : v);
}

// p and dS for this thread's 4 x 4 (query, key) tile.
template <typename T>
__device__ __forceinline__ void probs_tile(float (&p)[4][4], float (&ds)[4][4], const T* q,
                                           const T* k, const T* v, const T* dout,
                                           const float* lse, const float* delta, int q0, int k0,
                                           int t, int valid, int da, int dv, float scale,
                                           float* sa) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<T>(s, q, q0, k, k0, t, da, sa);
  tile_dot<T>(dp, dout, q0, v, k0, t, dv, sa);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool row_ok = row < valid;
    const float l = row_ok ? lse[row] : 0.f, dl = row_ok ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row_ok && (k0 + tx * 4 + j) < valid;
      const float pv = ok ? expf(s[i][j] * scale - l) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - dl);
    }
  }
}

template <typename T, int NCB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ lengths,
                    T* __restrict__ dq, int heads, int t, int da, int dv, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;              // [2][32][TS] chunks, or one [64][TS] tile
  float* dst = sa + BT * TS;     // [key][query] dS, transposed
  const int bh = blockIdx.x, q0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = clamp_len(lengths, bh / heads, t);
  const size_t qk_base = (size_t)bh * t * da, v_base = (size_t)bh * t * dv;
  q += qk_base;
  k += qk_base;
  v += v_base;
  dout += v_base;
  lse += (size_t)bh * t;
  delta += (size_t)bh * t;

  float acc[NCB][4][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[cb][i][j] = 0.f;

  if (q0 < valid) {
    for (int k0 = 0; k0 < valid; k0 += BT) {
      float p[4][4], ds[4][4];
      probs_tile<T>(p, ds, q, k, v, dout, lse, delta, q0, k0, t, valid, da, dv, scale, sa);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(tx * 4 + j) * TS + ty * 4 + i] = ds[i][j];
      __syncthreads();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        stage_direct<T, BT, 64>(sa, k, da, k0, t, cb * 64, da);
        __syncthreads();
        mma_kk(acc[cb], dst + ty * 4, TS, sa + tx * 4, TS, BT);
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty * 4 + i, col = cb * 64 + tx * 4 + j;
        if (row < t && col < da)
          dq[qk_base + (size_t)row * da + col] = from_f<T>(acc[cb][i][j] * scale);
      }
}

template <typename T, int NCB, int NVB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ lengths,
                     T* __restrict__ dk, T* __restrict__ dvo, int heads, int t, int da, int dv,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;              // [2][32][TS] chunks, or one [64][TS] tile
  float* ps = sa + BT * TS;      // [query][key] p
  float* dss = ps + BT * TS;     // [query][key] dS
  const int bh = blockIdx.x, k0 = blockIdx.y * BT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = clamp_len(lengths, bh / heads, t);
  const size_t qk_base = (size_t)bh * t * da, v_base = (size_t)bh * t * dv;
  q += qk_base;
  k += qk_base;
  v += v_base;
  dout += v_base;
  lse += (size_t)bh * t;
  delta += (size_t)bh * t;

  float dka[NCB][4][4], dva[NVB][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) dka[cb][i][j] = 0.f;
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) dva[vb][i][j] = 0.f;
    }

  if (k0 < valid) {
    for (int q0 = 0; q0 < valid; q0 += BT) {
      {
        float p[4][4], ds[4][4];
        probs_tile<T>(p, ds, q, k, v, dout, lse, delta, q0, k0, t, valid, da, dv, scale, sa);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ps[(ty * 4 + i) * TS + tx * 4 + j] = p[i][j];
            dss[(ty * 4 + i) * TS + tx * 4 + j] = ds[i][j];
          }
      }
      __syncthreads();
      // Output rows are keys here: this thread owns keys k0 + ty*4 .. +3.
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) {
        stage_direct<T, BT, 64>(sa, dout, dv, q0, t, vb * 64, dv);
        __syncthreads();
        mma_kk(dva[vb], ps + ty * 4, TS, sa + tx * 4, TS, BT);
        __syncthreads();
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        stage_direct<T, BT, 64>(sa, q, da, q0, t, cb * 64, da);
        __syncthreads();
        mma_kk(dka[cb], dss + ty * 4, TS, sa + tx * 4, TS, BT);
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        const int col = cb * 64 + tx * 4 + j;
        if (col < da) dk[qk_base + (size_t)row * da + col] = from_f<T>(dka[cb][i][j] * scale);
      }
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) {
        const int col = vb * 64 + tx * 4 + j;
        if (col < dv) dvo[v_base + (size_t)row * dv + col] = from_f<T>(dva[vb][i][j]);
      }
    }
  }
}

constexpr size_t DQ_SMEM = sizeof(float) * 2 * BT * TS;
constexpr size_t DKV_SMEM = sizeof(float) * 3 * BT * TS;

template <typename T, int NCB>
cudaError_t launch_dq(const Args& a, void* dq, int bh, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, NCB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)DQ_SMEM);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(bh, (a.t + BT - 1) / BT);
  kern<<<grid, THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.lengths),
      static_cast<T*>(dq), a.heads, a.t, a.da, a.dv, a.scale);
  return cudaGetLastError();
}

template <typename T, int NCB, int NVB>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, int bh, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, NCB, NVB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)DKV_SMEM);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(bh, (a.t + BT - 1) / BT);
  kern<<<grid, THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.lengths),
      static_cast<T*>(dk), static_cast<T*>(dv), a.heads, a.t, a.da, a.dv, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const Args& a, void* dq, int bh, cudaStream_t s) {
  if (a.da <= 128) return launch_dq<T, 2>(a, dq, bh, s);
  if (a.da <= 384) return launch_dq<T, 6>(a, dq, bh, s);
  if (a.da <= 512) return launch_dq<T, 8>(a, dq, bh, s);
  return cudaErrorInvalidValue;
}

template <typename T, int NVB>
cudaError_t dispatch_dkv_da(const Args& a, void* dk, void* dv, int bh, cudaStream_t s) {
  if (a.da <= 128) return launch_dkv<T, 2, NVB>(a, dk, dv, bh, s);
  if (a.da <= 384) return launch_dkv<T, 6, NVB>(a, dk, dv, bh, s);
  if (a.da <= 512) return launch_dkv<T, 8, NVB>(a, dk, dv, bh, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(const Args& a, void* dk, void* dv, int bh, cudaStream_t s) {
  if (a.dv <= 64) return dispatch_dkv_da<T, 1>(a, dk, dv, bh, s);
  if (a.dv <= 128) return dispatch_dkv_da<T, 2>(a, dk, dv, bh, s);
  return cudaErrorInvalidValue;
}

bool bad_shape(int bh, int heads, int t, int da, int dv) {
  return bh <= 0 || heads <= 0 || t <= 0 || da <= 0 || dv <= 0;
}

}  // namespace

// q, k, dq: (bh, t, da); v, dout: (bh, t, dv) of one dtype (fp32 or bf16);
// lse, delta: (bh, t) fp32; lengths: (bh / heads,) int32.
// Returns the launch's cudaError_t.
extern "C" int avec_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, const void* lengths, void* dq,
                                           int bh, int heads, int t, int da, int dv,
                                           float scale, int is_bf16, void* stream) {
  if (bad_shape(bh, heads, t, da, dv)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, lengths, heads, t, da, dv, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_dq<__nv_bfloat16>(a, dq, bh, s);
  return dispatch_dq<float>(a, dq, bh, s);
}

// dk: (bh, t, da); dv_out: (bh, t, dv); other arguments as above.
extern "C" int avec_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, const void* lengths, void* dk,
                                            void* dv_out, int bh, int heads, int t, int da,
                                            int dv, float scale, int is_bf16, void* stream) {
  if (bad_shape(bh, heads, t, da, dv)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, lengths, heads, t, da, dv, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_dkv<__nv_bfloat16>(a, dk, dv_out, bh, s);
  return dispatch_dkv<float>(a, dk, dv_out, bh, s);
}
