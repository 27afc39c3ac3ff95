// Shared-memory tile helpers of the hand-written kernels: the fp32 FMA path
// (first part) and the bf16 tensor-core path (`mma.sync`, last parts).
//
// The fp32 products of `ffn.cu`, `flash_attention_bwd.cu`,
// `attention_module.cu` and `conv_module.cu` are built from one register
// tile: a thread (ty = tid / 16, tx = tid % 16) owns output rows
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

// The 16 bytes at p (16-byte aligned) as fp32: 8 bf16 or 4 fp32 values.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact: the bits, shifted
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
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

// The 64 x 64 output tile of `gemm_tile`, its reduction chunk and its block
// size (16 x 16 threads, a 4 x 4 register tile each).
constexpr int GEMM_EDGE = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;

// acc[i][j] += sum over k in [k_begin, k_end) of fa(row, k) * fb(k, col) for
// this thread's rows ty*4 + i and columns tx*4 + j of a 64 x 64 tile. fa(i, k)
// and fb(k, j) take tile-local i, j and the global k and return 0 outside
// their operand. A_KFAST / B_KFAST say whether consecutive k (else
// consecutive i / j) are neighbours in memory, which picks the
// thread-to-element map so that the loads of a warp coalesce. `sm` holds
// 2 x GEMM_BK x TS floats; blockDim.x must be GEMM_THREADS.
template <bool A_KFAST, bool B_KFAST, class FA, class FB>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], FA fa, FB fb, int k_begin,
                                          int k_end, float* sm) {
  constexpr int BT = GEMM_EDGE, BK = GEMM_BK;
  float* as = sm;
  float* bs = sm + BK * TS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BT * BK; e += GEMM_THREADS) {
      const int i = A_KFAST ? e / BK : e % BT;
      const int k = A_KFAST ? e % BK : e / BT;
      as[k * TS + i] = (k0 + k < k_end) ? fa(i, k0 + k) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BT * BK; e += GEMM_THREADS) {
      const int j = B_KFAST ? e / BK : e % BT;
      const int k = B_KFAST ? e % BK : e / BT;
      bs[k * TS + j] = (k0 + k < k_end) ? fb(k0 + k, j) : 0.f;
    }
    __syncthreads();
    mma_kk(acc, as + ty * 4, TS, bs + tx * 4, TS, BK);
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

// ---- block-level tensor-core tiles (mma.sync, fp32 accumulation)
//
// `mma_tile` computes the same 64 x 64 output tile as `gemm_tile` with 256
// threads, on the tensor cores: operands are staged as bf16 into shared
// memory in chunks of MMA_BK reduction indices and multiplied with
// `warp_mma`. Warp w owns rows (w % 4) * 16 .. +15 and columns (w / 4) * 32
// .. +31 of the tile: in acc[nt][e], lane (g = lane / 4, t = lane % 4) holds
// row (w % 4) * 16 + g + (e / 2) * 8, column (w / 4) * 32 + nt * 8 + 2 t +
// (e % 2) (`mma_tile_at`). `sm` holds MMA_STAGE bf16 values.
//
// Operands come from device memory in 16-byte pieces of 8 elements, bf16 or
// fp32 (rounded to bf16 at staging), described by one of two sources:
//   RowSrc: row(r) points at tile row r's element k = 0, the elements
//           contiguous in k (nullptr: a zero row);
//   ColSrc: krow(k) points at tile column 0 of reduction index k, the tile's
//           columns contiguous, `valid` of them real (the rest read as 0).
// Pointers are 16-byte aligned at every multiple of 8 elements. Each thread
// stages one piece of A and one of B per chunk, and loads the next chunk's
// pieces before the current chunk's products, so the loads hide behind the
// tensor cores.

constexpr int MMA_BK = 32;                 // reduction chunk
constexpr int MMA_LD = MMA_BK + 8;         // row stride of a staged chunk
constexpr int MMA_STAGE = 2 * 64 * MMA_LD; // bf16 values of the staging buffer

__device__ __forceinline__ void mma_tile_at(int nt, int e, int& i, int& j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  i = (warp & 3) * 16 + (lane >> 2) + (e >> 1) * 8;
  j = (warp >> 2) * 32 + nt * 8 + 2 * (lane & 3) + (e & 1);
}

template <typename T, class F> struct RowSrc {
  F row;
};
template <typename T, class F> struct ColSrc {
  F krow;
  int valid;
};
template <typename T, class F> __device__ __forceinline__ RowSrc<T, F> rows_of(F f) {
  return RowSrc<T, F>{f};
}
template <typename T, class F>
__device__ __forceinline__ ColSrc<T, F> cols_of(F f, int valid) {
  return ColSrc<T, F>{f, valid};
}

// Eight staged values as four words of bf16 pairs, low half first.
struct Piece {
  uint32_t w[4];
};

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 elements at p, of which the first n are real.
__device__ __forceinline__ Piece load_piece(const bf16* p, int n) {
  Piece c{{0u, 0u, 0u, 0u}};
  if (n >= 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    for (int q = 0; q < n; ++q) c.w[q >> 1] |= (uint32_t)s[q] << (16 * (q & 1));
  }
  return c;
}

__device__ __forceinline__ void load8(const float* p, int n, float (&v)[8]) {
  if (n >= 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
    v[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = q < n ? p[q] : 0.f;
  }
}

__device__ __forceinline__ Piece load_piece(const float* p, int n) {
  float v[8];
  load8(p, n, v);
  return Piece{{bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                bf16_pair(v[6], v[7])}};
}

// Where this thread's piece of chunk k0 .. k0 + MMA_BK lies (64 rows x 4
// pieces), and how many of its 8 elements are real (nullptr: none).
template <typename T, class F>
__device__ __forceinline__ const T* mma_piece(const RowSrc<T, F>& s, int k0, int k_end, int& n) {
  const int r = threadIdx.x >> 2, k = k0 + (threadIdx.x & 3) * 8;
  const T* p = s.row(r);
  if (p == nullptr || k >= k_end) return nullptr;
  n = k_end - k;
  return p + k;
}

// (32 reduction indices x 8 pieces of 8 columns; warp w takes columns w * 8.)
template <typename T, class F>
__device__ __forceinline__ const T* mma_piece(const ColSrc<T, F>& s, int k0, int k_end, int& n) {
  const int k = k0 + (threadIdx.x & 31), c8 = (threadIdx.x >> 5) * 8;
  if (k >= k_end || c8 >= s.valid) return nullptr;
  n = s.valid - c8;
  return s.krow(k) + c8;
}

// Loads this thread's piece of chunk k0 as bf16.
template <class S>
__device__ __forceinline__ Piece mma_load(const S& s, int k0, int k_end) {
  int n = 0;
  const auto* p = mma_piece(s, k0, k_end, n);
  return p == nullptr ? Piece{{0u, 0u, 0u, 0u}} : load_piece(p, n);
}

template <typename T, class F>
__device__ __forceinline__ void mma_store(const RowSrc<T, F>&, bf16* dst, const Piece& c) {
  const int r = threadIdx.x >> 2, q8 = (threadIdx.x & 3) * 8;
  *reinterpret_cast<uint4*>(dst + r * MMA_LD + q8) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
}
template <typename T, class F>
__device__ __forceinline__ void mma_store(const ColSrc<T, F>&, bf16* dst, const Piece& c) {
  const int kk = threadIdx.x & 31, c8 = (threadIdx.x >> 5) * 8;
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    d[(c8 + q) * MMA_LD + kk] = (unsigned short)(c.w[q >> 1] >> (16 * (q & 1)));
}

// acc += A . B^T over k in [k_begin, k_end): A (64 rows of the tile) and B
// (64 columns) from their sources.
template <class SA, class SB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const SA& a, const SB& b,
                                         int k_begin, int k_end, bf16* sm) {
  bf16* as = sm;
  bf16* bs = sm + 64 * MMA_LD;
  const int warp = threadIdx.x >> 5, rowb = (warp & 3) * 16, colb = (warp >> 2) * 32;
  Piece pa{}, pb{};
  if (k_begin < k_end) {
    pa = mma_load(a, k_begin, k_end);
    pb = mma_load(b, k_begin, k_end);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BK) {
    mma_store(a, as, pa);
    mma_store(b, bs, pb);
    __syncthreads();
    if (k0 + MMA_BK < k_end) {
      pa = mma_load(a, k0 + MMA_BK, k_end);
      pb = mma_load(b, k0 + MMA_BK, k_end);
    }
    warp_mma<4>(acc, as + rowb * MMA_LD, MMA_LD, bs + colb * MMA_LD, MMA_LD, MMA_BK);
    __syncthreads();
  }
}

// ---- fp32 operands at fp32 precision on the bf16 tensor cores
//
// Where a TPU kernel multiplies an fp32 value unrounded, the operand enters
// `mma.sync` as three bf16 parts, hi = bf16(v), mid = bf16(v - hi) and lo =
// bf16(v - hi - mid), which sum to v exactly (its 24 significant bits in
// three pieces of 8; each difference is exact in fp32). With fp32
// accumulation, hi . B + mid . B + lo . B is then the fp32 product for a bf16
// B; for an fp32 B the six part products down to 2^-16 of the leading one
// are summed. The parts are split in registers from fp32 in shared memory,
// whose row strides are 8 mod 32 floats so that the 64-bit fragment loads of
// a warp meet no bank conflict.

constexpr int MMA_LDF = MMA_BK + 8;  // row stride (floats) of a staged fp32 chunk
// staging buffer, in bf16 values, of `mma_tile_f32`: two fp32 chunks
constexpr int MMA_STAGE_F32 = 2 * 64 * MMA_LDF * 2;

__device__ __forceinline__ float2 ld64(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The first P parts of two neighbouring fp32 values as bf16 pairs into
// parts[i][r]; with P = 1 the values are rounded to bf16.
template <int P>
__device__ __forceinline__ void split_pair(float2 v, uint32_t (&parts)[P][4], int r) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
    parts[i][r] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    v.x -= hf.x;
    v.y -= hf.y;
  }
}

// acc[nt] += A (16 x kn) . B (NT*8 x kn)^T as `warp_mma`, A in fp32 (row
// stride lda floats) taken as its first PA parts, B bf16.
template <int NT, int PA>
__device__ __forceinline__ void warp_mma_fa(float (&acc)[NT][4], const float* a, int lda,
                                            const bf16* b, int ldb, int kn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda + 2 * t;
  const float* a1 = a0 + 8 * lda;
  const bf16* bp = b + g * ldb + 2 * t;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t af[PA][4];
    split_pair<PA>(ld64(a0 + k0), af, 0);
    split_pair<PA>(ld64(a1 + k0), af, 1);
    split_pair<PA>(ld64(a0 + k0 + 8), af, 2);
    split_pair<PA>(ld64(a1 + k0 + 8), af, 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* bq = bp + nt * 8 * ldb + k0;
      const uint32_t b0 = ld32(bq), b1 = ld32(bq + 8);
#pragma unroll
      for (int i = 0; i < PA; ++i) mma_16816(acc[nt], af[i], b0, b1);
    }
  }
}

// The same with B in fp32 too (row stride ldb floats), both in three parts.
template <int NT>
__device__ __forceinline__ void warp_mma_ff(float (&acc)[NT][4], const float* a, int lda,
                                            const float* b, int ldb, int kn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda + 2 * t;
  const float* a1 = a0 + 8 * lda;
  const float* bp = b + g * ldb + 2 * t;
  for (int k0 = 0; k0 < kn; k0 += 16) {
    uint32_t af[3][4], bf[3][4];
    split_pair<3>(ld64(a0 + k0), af, 0);
    split_pair<3>(ld64(a1 + k0), af, 1);
    split_pair<3>(ld64(a0 + k0 + 8), af, 2);
    split_pair<3>(ld64(a1 + k0 + 8), af, 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bq = bp + nt * 8 * ldb + k0;
      split_pair<3>(ld64(bq), bf, 0);
      split_pair<3>(ld64(bq + 8), bf, 1);
      mma_16816(acc[nt], af[0], bf[0][0], bf[0][1]);
      mma_16816(acc[nt], af[0], bf[1][0], bf[1][1]);
      mma_16816(acc[nt], af[1], bf[0][0], bf[0][1]);
      mma_16816(acc[nt], af[0], bf[2][0], bf[2][1]);
      mma_16816(acc[nt], af[1], bf[1][0], bf[1][1]);
      mma_16816(acc[nt], af[2], bf[0][0], bf[0][1]);
    }
  }
}

// This thread's piece of chunk k0 from an fp32 source, and its store into a
// staged fp32 chunk (row stride MMA_LDF).
struct Piece32 {
  float v[8];
};

template <class S>
__device__ __forceinline__ Piece32 mma_load32(const S& s, int k0, int k_end) {
  Piece32 c;
  int n = 0;
  const float* p = mma_piece(s, k0, k_end, n);
  if (p == nullptr) {
#pragma unroll
    for (int q = 0; q < 8; ++q) c.v[q] = 0.f;
  } else {
    load8(p, n, c.v);
  }
  return c;
}
template <class F>
__device__ __forceinline__ void mma_store32(const RowSrc<float, F>&, float* dst,
                                            const Piece32& c) {
  const int r = threadIdx.x >> 2, q8 = (threadIdx.x & 3) * 8;
  float4* d = reinterpret_cast<float4*>(dst + r * MMA_LDF + q8);
  d[0] = make_float4(c.v[0], c.v[1], c.v[2], c.v[3]);
  d[1] = make_float4(c.v[4], c.v[5], c.v[6], c.v[7]);
}
template <class F>
__device__ __forceinline__ void mma_store32(const ColSrc<float, F>&, float* dst,
                                            const Piece32& c) {
  const int kk = threadIdx.x & 31, c8 = (threadIdx.x >> 5) * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[(c8 + q) * MMA_LDF + kk] = c.v[q];
}

// acc += A . B^T as `mma_tile`, A from an fp32 source at fp32 precision; B
// from a bf16 source, or with B_F32 from an fp32 source at fp32 precision
// too. `sm` holds MMA_STAGE_F32 bf16 values.
template <bool B_F32 = false, class SA, class SB>
__device__ __forceinline__ void mma_tile_f32(float (&acc)[4][4], const SA& a, const SB& b,
                                             int k_begin, int k_end, bf16* sm) {
  float* as = reinterpret_cast<float*>(sm);
  float* bsf = as + 64 * MMA_LDF;
  bf16* bs = reinterpret_cast<bf16*>(bsf);
  const int warp = threadIdx.x >> 5, rowb = (warp & 3) * 16, colb = (warp >> 2) * 32;
  Piece32 pa{}, pbf{};
  Piece pb{};
  auto load = [&](int k0) {
    pa = mma_load32(a, k0, k_end);
    if constexpr (B_F32)
      pbf = mma_load32(b, k0, k_end);
    else
      pb = mma_load(b, k0, k_end);
  };
  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BK) {
    mma_store32(a, as, pa);
    if constexpr (B_F32)
      mma_store32(b, bsf, pbf);
    else
      mma_store(b, bs, pb);
    __syncthreads();
    if (k0 + MMA_BK < k_end) load(k0 + MMA_BK);
    if constexpr (B_F32)
      warp_mma_ff<4>(acc, as + rowb * MMA_LDF, MMA_LDF, bsf + colb * MMA_LDF, MMA_LDF, MMA_BK);
    else
      warp_mma_fa<4, 3>(acc, as + rowb * MMA_LDF, MMA_LDF, bs + colb * MMA_LD, MMA_LD, MMA_BK);
    __syncthreads();
  }
}

// acc += A . B^T with A in shared memory as fp32, a[i * lda + k] for the
// tile's 64 rows and k in [k_begin, round up(k_end, MMA_BK)), zero past
// k_end, lda 8 mod 32, taken as its first PA parts (PA = 1: A rounded to
// bf16, PA = 3: at fp32 precision); B from a bf16 source, staged in `sm`
// (MMA_STAGE bf16 values).
template <int PA, class SB>
__device__ __forceinline__ void mma_tile_saf(float (&acc)[4][4], const float* a, int lda,
                                             const SB& b, int k_begin, int k_end, bf16* sm) {
  bf16* bs = sm + 64 * MMA_LD;
  const int warp = threadIdx.x >> 5, rowb = (warp & 3) * 16, colb = (warp >> 2) * 32;
  Piece pb{};
  if (k_begin < k_end) pb = mma_load(b, k_begin, k_end);
  for (int k0 = k_begin; k0 < k_end; k0 += MMA_BK) {
    mma_store(b, bs, pb);
    __syncthreads();
    if (k0 + MMA_BK < k_end) pb = mma_load(b, k0 + MMA_BK, k_end);
    warp_mma_fa<4, PA>(acc, a + rowb * lda + k0, lda, bs + colb * MMA_LD, MMA_LD, MMA_BK);
    __syncthreads();
  }
}

}  // namespace avec
