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
// Design: each input byte crosses device memory once, in 16-byte loads. A
// thread owns 8 channels (bf16; 4 in fp32) of one output column j and walks
// down its frame's output rows: for each input row it loads the 16 bytes of
// input columns 2j-1, 2j, 2j+1, takes their horizontal max of relu(affine)
// (rounded to y's dtype, as the TPU kernel rounds z), and carries the max of
// input row 2i+1 in registers into output row i+1, so each thread loads
// each input row once; the column a neighbouring thread shares comes from
// L1. Threads run channels fastest, then columns, then frames: a warp reads
// whole pixels, and a frame's columns are one block's or two's (1608-2416
// frames on the main paths). The even-column selection that the TPU kernel
// left to XLA (a Mosaic limit) is done here. The affine is a separately
// rounded multiply and add, exactly as the plain PyTorch version computes
// it, so the bf16 result is bit-exact. C must be a multiple of 8 (bf16) or 4
// (fp32), and y 16-byte aligned.

#include "tile.cuh"

namespace {

using avec::load16;

constexpr int THREADS = 256;

// The 16 bytes at p from fp32 values, rounded to nearest.
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  auto bits = [](float x) { return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(x)); };
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = bits(v[2 * i]) | bits(v[2 * i + 1]) << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// z = relu(a y + b) in fp32 (multiply and add each rounded), rounded to T.
template <typename T>
__device__ __forceinline__ float bn_relu(float y, float a, float b) {
  const float z = fmaxf(__fadd_rn(__fmul_rn(a, y), b), 0.f);
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(z));
  return z;
}

// m = the max over input columns 2j-1 .. 2j+1 (those inside the frame) of z
// at the V channels of input row `p` (pointing at column 2j).
template <typename T, int V>
__device__ __forceinline__ void hmax(const T* __restrict__ p, int c, bool left, bool right,
                                     const float (&av)[V], const float (&bv)[V], float (&m)[V]) {
  float mid[V], lo[V], hi[V];
  load16(p, mid);
  if (left) load16(p - c, lo);
  if (right) load16(p + c, hi);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = bn_relu<T>(mid[v], av[v], bv[v]);
    if (left) m[v] = fmaxf(m[v], bn_relu<T>(lo[v], av[v], bv[v]));
    if (right) m[v] = fmaxf(m[v], bn_relu<T>(hi[v], av[v], bv[v]));
  }
}

// At most 85 registers, so that three blocks of 256 threads fit an SM: with
// 86 (two blocks) the bf16 kernel took 0.225 ms at the serving shape on the
// H100 against 0.182, and capped at 64 (four blocks, spilling) 0.219.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
bn_relu_pool_kernel(const T* __restrict__ y, const float* __restrict__ a,
                    const float* __restrict__ b, T* __restrict__ out, long long n, int h,
                    int w, int c, int ho, int wo) {
  constexpr int V = 16 / sizeof(T);
  const int groups = c / V;
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n * wo * groups) return;
  const int ch = (int)(idx % groups) * V;
  const long long r = idx / groups;
  const int j = (int)(r % wo);
  const long long f = r / wo;
  float av[V], bv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    av[v] = a[ch + v];
    bv[v] = b[ch + v];
  }
  const bool left = j > 0, right = 2 * j + 1 < w;  // window columns inside the frame
  const T* col = y + (f * h * w + 2 * j) * c + ch;  // input row 0, column 2j
  const long long row_step = (long long)w * c;
  T* o = out + ((f * ho) * wo + j) * c + ch;
  float carry[V];  // the max of input row 2i - 1
  for (int i = 0; i < ho; ++i) {
    float m[V];
    hmax<T, V>(col + 2 * i * row_step, c, left, right, av, bv, m);
    if (i > 0)
#pragma unroll
      for (int v = 0; v < V; ++v) m[v] = fmaxf(m[v], carry[v]);
    if (2 * i + 1 < h) {
      hmax<T, V>(col + (2 * i + 1) * row_step, c, left, right, av, bv, carry);
#pragma unroll
      for (int v = 0; v < V; ++v) m[v] = fmaxf(m[v], carry[v]);
    }
    store16(o + (long long)i * wo * c, m);
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* a, const void* b, void* out, long long n,
                   int h, int w, int c, cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const long long threads = n * wo * (c / (16 / (int)sizeof(T)));
  bn_relu_pool_kernel<T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), n, h, w, c, ho, wo);
  return cudaGetLastError();
}

}  // namespace

// y: (n, h, w, c) channels-last, fp32 or bf16, 16-byte aligned, c a
// multiple of 8 (bf16) or 4 (fp32); a, b: (c,) fp32; out: (n, (h-1)/2+1,
// (w-1)/2+1, c) in y's dtype. Returns cudaGetLastError().
extern "C" int avec_bn_relu_pool(const void* y, const void* a, const void* b, void* out,
                                 long long n, int h, int w, int c, int is_bf16,
                                 void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % (is_bf16 ? 8 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(y, a, b, out, n, h, w, c, s);
  return launch<float>(y, a, b, out, n, h, w, c, s);
}
