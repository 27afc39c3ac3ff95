// Flash rel-pos attention forward for Hopper (sm_90a).
//
// Replaces: avec_tpu/ops/pallas_attention.py `_flash_kernel` (:55), launched
// by the pallas_call at :134 (`_flash_forward` :107, `flash_attention` :163,
// `rel_pos_flash_attention` :381).
//
// Computes, for each (batch*head) row block and query i,
//     out[i] = softmax_j(q'[i] . k'[j] * scale, keys j >= len masked) @ v
//     lse[i] = logsumexp_j(...)
// over the augmented rel-pos features q' = [q, a1, a2, q.b_pos] and
// k' = [k, cos, sin, 1] (width d_a = d_h + D + 1), without materialising the
// (T, T) score matrix in device memory.
//
// What bounds it on the H100: at the serving shapes (B=8, H=4, T=201/101,
// d_a=321/451, d_v=64/90) the call does 2*B*H*T*len*(d_a+d_v) operations on
// a few MB of inputs, so the tensor-core bound is a few microseconds and the
// memory bound about as much; in practice a launch of 64-128 blocks is bound
// by latency (too few blocks for 132 SMs, a serial walk over key tiles).
//
// Design: one block of 256 threads per (b*h, 64-query tile). A loop over
// 64-key tiles carries the running max, normaliser and an fp32 accumulator in
// registers (4 query rows x d_v/16 columns per thread). Scores are built in
// 32-wide chunks of d_a staged transposed in shared memory, so the odd widths
// 321 and 451 are handled by masked loads (zeros past d_a) instead of padding
// in device memory. Key tiles past the true length are skipped: with at least
// one valid key per row their weights are exactly zero. No wgmma, TMA or
// multi-stage pipelining yet: this kernel is the simple, exact first version.
// The Mosaic workarounds of the TPU kernel (128-lane padding of d_a/d_v, the
// lane-replicated lse) are not carried over; lse is written flat (B*H, T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int DC = 32;        // d_a chunk staged per pass
constexpr int PAD = 4;        // row padding of the transposed chunks (floats)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 score tile each
constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DVP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 T* __restrict__ out, float* __restrict__ lse, int heads, int t,
                 int da, int dv, float scale) {
  constexpr int CPT = DVP / 16;  // output columns per thread
  // Transposed Q and K chunks ([DC][64 + PAD] each); reused as P [64][65].
  __shared__ __align__(16) float smem_a[2 * DC * (BQ + PAD)];
  __shared__ __align__(16) float vs[BK * DVP];
  float* qs = smem_a;
  float* ks = smem_a + DC * (BQ + PAD);
  float* ps = smem_a;
  static_assert(BQ * (BK + 1) <= 2 * DC * (BQ + PAD), "P must fit the Q/K chunks");

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx*4 .. tx*4+3
  int valid = lengths[bh / heads];
  valid = valid < 0 ? 0 : (valid > t ? t : valid);
  // A row with no valid key softmaxes uniformly over all T keys (as the
  // plain version does), so then every tile is walked.
  const int kend = valid > 0 ? valid : t;
  const size_t qk_base = (size_t)bh * t * da;
  const size_t v_base = (size_t)bh * t * dv;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int c0 = 0; c0 < da; c0 += DC) {
      for (int e = tid; e < BQ * DC; e += THREADS) {
        const int r = e / DC, c = e % DC, col = c0 + c;
        const int qi = q0 + r, kj = k0 + r;
        float qv = 0.f, kv = 0.f;
        if (col < da) {
          if (qi < t) qv = to_f(q[qk_base + (size_t)qi * da + col]);
          if (kj < t) kv = to_f(k[qk_base + (size_t)kj * da + col]);
        }
        qs[c * (BQ + PAD) + r] = qv;
        ks[c * (BK + PAD) + r] = kv;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[c * (BQ + PAD) + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ks[c * (BK + PAD) + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      __syncthreads();
    }

    for (int e = tid; e < BK * DVP; e += THREADS) {
      const int r = e / DVP, c = e % DVP, kj = k0 + r;
      vs[e] = (kj < t && c < dv) ? to_f(v[v_base + (size_t)kj * dv + c]) : 0.f;
    }

    // Scale, mask, online softmax. The 16 threads that share a row are 16
    // consecutive lanes of one warp, so row reductions are xor shuffles.
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float sv = s[i][j] * scale;
        if (col >= t) sv = -INFINITY;
        else if (col >= valid) sv = NEG_INF;
        s[i][j] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    float rs[4], alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mn);
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        s[i][j] = p;
        rs[i] += p;
      }
      m[i] = mn;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i) rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * (BK + 1) + tx * 4 + j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[kk * DVP + tx * CPT + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t) continue;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx * CPT + c;
      if (col < dv) out[v_base + (size_t)row * dv + col] = from_f<T>(acc[i][c] / ll);
    }
    if (tx == 0) lse[(size_t)bh * t + row] = m[i] + logf(ll);
  }
}

template <typename T, int DVP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   void* out, void* lse, int bh, int heads, int t, int da, int dv,
                   float scale, cudaStream_t stream) {
  const dim3 grid(bh, (t + BQ - 1) / BQ);
  flash_fwd_kernel<T, DVP><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(lse),
      heads, t, da, dv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, void* lse, int bh, int heads, int t, int da, int dv,
                     float scale, cudaStream_t stream) {
  if (dv <= 32) return launch<T, 32>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, stream);
  if (dv <= 64) return launch<T, 64>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, stream);
  if (dv <= 96) return launch<T, 96>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k: (bh, t, da); v, out: (bh, t, dv) of one dtype (fp32 or bf16);
// lengths: (bh / heads,) int32; lse: (bh, t) fp32. Returns cudaGetLastError().
extern "C" int avec_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* lengths, void* out, void* lse,
                                        int bh, int heads, int t, int da, int dv,
                                        float scale, int is_bf16, void* stream) {
  if (bh <= 0 || t <= 0 || da <= 0 || dv <= 0 || heads <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
  return dispatch<float>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
}
