// The bf16 copies that the flash attention forward (`flash_attention.cu`)
// and backward (`flash_attention_bwd.cu`) read by TMA, and the prep stage
// that writes them.
//
// TMA needs row strides that are multiples of 16 bytes, and rows of q', k'
// (d_a = 321 / 451) and of v, dO (d_v = 90) in bf16 are 642, 902 and 180
// bytes. So the first launch of a bf16 call copies its row operands into
// scratch that the wrapper allocates, each row rounded up to 8 elements
// (lda = round8(d_a), ldv = round8(d_v)) with zero pad columns; the main
// kernels then read 64 x 64 boxes of the copies, zeros past the width.

#pragma once

#include "tile.cuh"

namespace avec {
namespace flash {

constexpr int BT = 64;  // queries / keys per tile

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int t) {
  const int v = lengths[b];
  return v < 0 ? 0 : (v > t ? t : v);
}

// The bf16 copies in scratch: q', k' (bh * t, lda), v and dO (bh * t, ldv);
// dO only in the backward's (nullptr in the forward's).
struct Copies {
  bf16 *q, *k, *v, *dout;
  int lda, ldv;
};

// Carves `base` (nullptr: sizes only) into the copies of `rows` rows; returns
// the bytes they take.
inline size_t carve(char* base, int rows, int da, int dv, bool with_dout, Copies* c) {
  c->lda = round8(da);
  c->ldv = round8(dv);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    bf16* p = base == nullptr ? nullptr : reinterpret_cast<bf16*>(base + at);
    at += (bytes + 1023) / 1024 * 1024;
    return p;
  };
  c->q = take((size_t)rows * c->lda * 2);
  c->k = take((size_t)rows * c->lda * 2);
  c->v = take((size_t)rows * c->ldv * 2);
  c->dout = with_dout ? take((size_t)rows * c->ldv * 2) : nullptr;
  return at;
}

// blockIdx.y picks q', k', v or dO; one thread per 8 columns of a row of the
// copy, written as one 16-byte store, zero past the width. ALL_ROWS (the
// forward): every row is copied, as every query has an output and a
// sequence of length 0 averages v over all T keys. Else (the backward) rows
// at or past their sequence's length, about half of them at T = 151, are
// written as zeros without being read: the kernels mask them, and a tile
// that reaches them needs them finite.
template <bool ALL_ROWS>
__global__ void __launch_bounds__(256)
flash_prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const int* __restrict__ lengths, Copies c, int rows, int t, int heads, int da,
                  int dv) {
  const int which = blockIdx.y;
  const bf16* src = which == 0 ? q : which == 1 ? k : which == 2 ? v : dout;
  bf16* dst = which == 0 ? c.q : which == 1 ? c.k : which == 2 ? c.v : c.dout;
  const int cols = which < 2 ? da : dv, ld = which < 2 ? c.lda : c.ldv, chunks = ld / 8;
  const long long total = (long long)rows * chunks;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const int r = (int)(i / chunks), c8 = (int)(i - (long long)r * chunks) * 8;
    const bool live = ALL_ROWS || r % t < clamp_len(lengths, r / t / heads, t);
    const bf16* s = src + (size_t)r * cols + c8;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vals[e] = live && c8 + e < cols ? s[e] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c8) = *reinterpret_cast<const uint4*>(vals);
  }
}

// Writes the copies `c` (dO too where c.dout is set) of `rows` = bh * t rows
// on stream `st`; returns the launch's cudaError_t.
template <bool ALL_ROWS>
cudaError_t launch_prep(const void* q, const void* k, const void* v, const void* dout,
                        const void* lengths, const Copies& c, int rows, int t, int heads, int da,
                        int dv, cudaStream_t st) {
  const int blocks = cdiv(cdiv(rows * (c.lda / 8), 256), 4);
  flash_prep_kernel<ALL_ROWS><<<dim3(blocks, c.dout != nullptr ? 4 : 3), 256, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const int*>(lengths), c, rows, t, heads, da,
      dv);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace avec
