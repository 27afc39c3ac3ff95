// Video-stem BN-apply + ReLU + 3x3/2 max pool for Hopper (sm_90a).
//
// Replaces: avec_tpu/ops/pallas_stem.py `_bn_relu_pool_kernel` (:104),
// launched by the pallas_call at :149 (`bn_relu_pool` :136, reached from
// `fused_stem_eval` :267 on the serving path).
//
// Computes, on channels-last frames y (N, H, W, C) and per-channel a, b:
//     z   = relu(a[c] * y + b[c])      (fp32, rounded to y's dtype)
//     out = max over rows 2i-1..2i+1 and cols 2j-1..2j+1, clipped to the
//           frame; (N, (H-1)/2+1, (W-1)/2+1, C) in y's dtype.
// Clipping equals the TPU kernel's zero padding because z >= 0.
//
// What bounds it on the H100: memory. At the serving shape (N = 1608 frames
// of 44x44x64 bf16) it must read 398.5 MB and write 99.6 MB, 0.149 ms at
// 3.35 TB/s, against about 9 operations per input element.
//
// Design: one thread per output element with channels fastest, so a warp
// reads 32 neighbouring channels of one pixel (64 contiguous bytes in bf16)
// and neighbouring outputs share their overlapping window rows through L1/L2.
// The even-column selection that the TPU kernel left to XLA (a Mosaic limit)
// is done here. The affine is a separately rounded multiply and add, exactly
// as the plain PyTorch version computes it, so the bf16 result is bit-exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void bn_relu_pool_kernel(const T* __restrict__ y, const float* __restrict__ a,
                                    const float* __restrict__ b, T* __restrict__ out,
                                    long long n, int h, int w, int c, int ho, int wo) {
  const long long total = n * ho * wo * c;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int ch = (int)(idx % c);
    long long r = idx / c;
    const int j = (int)(r % wo);
    r /= wo;
    const int i = (int)(r % ho);
    const long long f = r / ho;
    const float ac = a[ch], bc = b[ch];
    const int r0 = max(2 * i - 1, 0), r1 = min(2 * i + 1, h - 1);
    const int c0 = max(2 * j - 1, 0), c1 = min(2 * j + 1, w - 1);
    const T* frame = y + f * h * w * c + ch;
    float best = -INFINITY;
    for (int rr = r0; rr <= r1; ++rr)
      for (int cc = c0; cc <= c1; ++cc) {
        const float z = fmaxf(__fadd_rn(__fmul_rn(ac, to_f(frame[((long long)rr * w + cc) * c])), bc), 0.f);
        best = fmaxf(best, to_f(from_f<T>(z)));
      }
    out[idx] = from_f<T>(best);
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* a, const void* b, void* out, long long n,
                   int h, int w, int c, cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const long long total = n * ho * wo * c;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  bn_relu_pool_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), n, h, w, c, ho, wo);
  return cudaGetLastError();
}

}  // namespace

// y: (n, h, w, c) channels-last, fp32 or bf16; a, b: (c,) fp32;
// out: (n, (h-1)/2+1, (w-1)/2+1, c) in y's dtype. Returns cudaGetLastError().
extern "C" int avec_bn_relu_pool(const void* y, const void* a, const void* b, void* out,
                                 long long n, int h, int w, int c, int is_bf16,
                                 void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(y, a, b, out, n, h, w, c, s);
  return launch<float>(y, a, b, out, n, h, w, c, s);
}
