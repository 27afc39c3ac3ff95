// Shared-memory tile helpers of the hand-written kernels: the fp32 FMA path
// (first part) and the bf16 tensor-core path (`mma.sync`, last part).
//
// Every product in `ffn.cu` and `flash_attention_bwd.cu` is built from one
// register tile: a thread (ty = tid / 16, tx = tid % 16) owns output rows
// ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3 of a (blockDim.x / 4) x 64 tile
// and accumulates it in fp32 over a reduction index k. Operands are staged
// from device memory into shared memory as fp32 (bf16 inputs are widened;
// fp32 weights are first rounded to the compute type), with rows of 64
// columns padded to TS floats so that float4 loads stay aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace avec {

constexpr int TS = 68;  // row stride (floats) of a 64-column shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to the precision of T, as a float.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// acc[i][j] += sum_k a[k * lda + i] * b[k * ldb + j]: both operands k-major,
// `a` and `b` point at this thread's first row / column (16-byte aligned).
__device__ __forceinline__ void mma_kk(float (&acc)[4][4], const float* a, int lda,
                                       const float* b, int ldb, int kn) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(a + k * lda);
    const float4 b4 = *reinterpret_cast<const float4*>(b + k * ldb);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k a[i * lda + k] * b[k * ldb + j]: A row-major (`a` points
// at this thread's first row, at the first k), B k-major.
__device__ __forceinline__ void mma_rk(float (&acc)[4][4], const float* a, int lda,
                                       const float* b, int ldb, int kn) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    const float4 b4 = *reinterpret_cast<const float4*>(b + k * ldb);
    const float av[4] = {a[k], a[lda + k], a[2 * lda + k], a[3 * lda + k]};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dst[r * TS + c] = src[(row0 + r) * ld + col0 + c] for r < ROWS, c < COLS,
// rounded to R; zero where the source row >= row_lim or column >= col_lim.
template <typename R, int ROWS, int COLS, typename S>
__device__ __forceinline__ void stage_direct(float* dst, const S* __restrict__ src, size_t ld,
                                             int row0, int row_lim, int col0, int col_lim) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += blockDim.x) {
    const int r = e / COLS, c = e % COLS;
    const int row = row0 + r, col = col0 + c;
    float v = 0.f;
    if (row < row_lim && col < col_lim) v = rnd<R>(to_f(src[(size_t)row * ld + col]));
    dst[r * TS + c] = v;
  }
}

// dst[c * TS + r] = src[(row0 + r) * ld + col0 + c]: the transposed tile.
template <typename R, int ROWS, int COLS, typename S>
__device__ __forceinline__ void stage_transposed(float* dst, const S* __restrict__ src, size_t ld,
                                                 int row0, int row_lim, int col0, int col_lim) {
  for (int e = threadIdx.x; e < ROWS * COLS; e += blockDim.x) {
    const int r = e / COLS, c = e % COLS;
    const int row = row0 + r, col = col0 + c;
    float v = 0.f;
    if (row < row_lim && col < col_lim) v = rnd<R>(to_f(src[(size_t)row * ld + col]));
    dst[c * TS + r] = v;
  }
}

// acc[i][j] += sum_c A[a_row0 + ty*4 + i][c] * B[b_row0 + tx*4 + j][c] over
// c < width, for two row-major device arrays of row stride `width`, staged
// through `sa` (2 x 32 x TS floats) in transposed 32-column chunks. Rows at or
// past `row_lim` count as zero. Needs blockDim.x == 256 (64 x 64 tile).
template <typename T>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const T* __restrict__ a, int a_row0,
                                         const T* __restrict__ b, int b_row0, int row_lim,
                                         int width, float* sa) {
  float* as = sa;
  float* bs = sa + 32 * TS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c0 = 0; c0 < width; c0 += 32) {
    stage_transposed<T, 64, 32>(as, a, width, a_row0, row_lim, c0, width);
    stage_transposed<T, 64, 32>(bs, b, width, b_row0, row_lim, c0, width);
    __syncthreads();
    mma_kk(acc, as + ty * 4, TS, bs + tx * 4, TS, 32);
    __syncthreads();
  }
}

// ---- bf16 tensor-core path (mma.sync.m16n8k16, fp32 accumulation)
//
// A warp owns a 16-row output tile, NT column tiles of 8. Both operands lie in
// shared memory as bf16, row-major over the reduction index k: A[m][k] and
// B[n][k], so every fragment register is one aligned 32-bit load of two
// neighbouring k. Row strides are 8 mod 16 elements (lda = K + 8), which
// spreads the 8 rows x 4 k-pairs of a fragment load over all 32 banks.

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A (16 x kn) . B (NT*8 x kn)^T; `a` and `b` point at the tile's
// first row, kn is a multiple of 16. In acc[nt], lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns nt*8 + 2t and 2t + 1:
// element e sits at row g + (e / 2) * 8, column nt*8 + 2t + (e % 2).
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int kn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* a0 = a + g * lda + 2 * t;
  const bf16* a1 = a0 + 8 * lda;
  const bf16* bp = b + g * ldb + 2 * t;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    const uint32_t af[4] = {ld32(a0 + k0), ld32(a1 + k0), ld32(a0 + k0 + 8), ld32(a1 + k0 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bq = bp + nt * 8 * ldb + k0;
      mma_16816(acc[nt], af, ld32(bq), ld32(bq + 8));
    }
  }
}

// Stage a ROWS x COLS tile of a row-major fp32 matrix into shared memory as
// bf16: dst[r * ldd + c] (or dst[c * ldd + r] when TRANSPOSE) =
// bf16(src[(row0 + r) * ld + col0 + c]); zero where the source row >= row_lim
// or column >= col_lim. With `vec` (ld, col0, col_lim multiples of 4 and src
// 16-byte aligned) a thread starts 8 independent 16-byte loads before it
// converts and stores, which hides the L2 latency that a one-element loop
// pays on every iteration; without it the tile is staged element by element.
template <int ROWS, int COLS, bool TRANSPOSE>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ldd, const float* __restrict__ src,
                                           size_t ld, int row0, int row_lim, int col0,
                                           int col_lim, bool vec) {
  if (vec) {
    constexpr int CV = COLS / 4, V = ROWS * CV, UNROLL = 8;
    for (int e0 = threadIdx.x; e0 < V; e0 += blockDim.x * UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * blockDim.x;
        const int row = row0 + e / CV, col = col0 + (e % CV) * 4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < V && row < row_lim && col < col_lim)
          v[u] = *reinterpret_cast<const float4*>(src + (size_t)row * ld + col);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e >= V) break;
        const int r = e / CV, c = (e % CV) * 4;
        if (TRANSPOSE) {
          dst[c * ldd + r] = __float2bfloat16(v[u].x);
          dst[(c + 1) * ldd + r] = __float2bfloat16(v[u].y);
          dst[(c + 2) * ldd + r] = __float2bfloat16(v[u].z);
          dst[(c + 3) * ldd + r] = __float2bfloat16(v[u].w);
        } else {
          __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + r * ldd + c);
          d2[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
          d2[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
        }
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < ROWS * COLS; e += blockDim.x) {
    const int r = e / COLS, c = e % COLS;
    const int row = row0 + r, col = col0 + c;
    float v = 0.f;
    if (row < row_lim && col < col_lim) v = src[(size_t)row * ld + col];
    dst[TRANSPOSE ? c * ldd + r : r * ldd + c] = __float2bfloat16(v);
  }
}

}  // namespace avec
