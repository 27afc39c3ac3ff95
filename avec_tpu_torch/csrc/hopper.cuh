// Hopper (sm_90a) building blocks of the bf16 tensor-core stages of `ffn.cu`
// and `conv_module.cu`: 2-d TMA tile loads that complete on an `mbarrier`,
// warpgroup matrix multiplies (`wgmma`) on 128-byte-swizzled, K-major
// shared-memory tiles, a one-warpgroup TMA/`wgmma` main loop, and a launch of
// independent 64 x 64 fp32 output tiles (`wgmma_products_kernel`).
//
// Tile convention: a tile is ROWS x 64 bf16 values, one 128-byte row per
// matrix row (the reduction index k along the row), written by one TMA load
// of a tensor map with box {64, ROWS} and CU_TENSOR_MAP_SWIZZLE_128B into
// shared memory aligned to 1024 bytes. `wgmma` reads A (64 x 16) and B
// (N x 16) slices of such tiles through a descriptor: 8-row groups 1024
// bytes apart (SBO), 128-byte swizzle, and the 16-column slice ks selected
// by advancing the start address by 32 bytes.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, whose
// address the CUDA runtime hands out (`tensor_map_2d`), so the libraries
// link against the runtime only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avec {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed. A phase
// that never completes (a load that was never issued, or a byte count that
// does not match) stops the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads by the async proxy (`wgmma` operands written by the threads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA

// Loads the box of `map` at (c0 = inner coordinate, c1 = outer coordinate)
// into `dst`; the bytes complete on `bar`. Out-of-bounds elements are zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma

// Descriptor of a K-major, 128-byte-swizzled tile slice starting at `p`.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits until at most one committed group is still running.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) += A (64 x 16) . B (64 x 16)^T, both K-major in shared
// memory. In d, thread tid of the warpgroup holds rows 16 (tid / 32) + g and
// + 8 (g = lane / 4) at columns 8 i + 2 (lane % 4) and + 1: d[4 i + e] sits at
// row 16 (tid / 32) + g + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A . B^T over one 64-column k tile: four k16 slices.
__device__ __forceinline__ void wgmma_tile_k64(float (&d)[32], const __nv_bfloat16* a,
                                               const __nv_bfloat16* b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_64x64(d, sw128_desc(a + ks * 16), sw128_desc(b + ks * 16));
}

// Element offset of (row r, column c) in a 64-column bf16 tile with the
// 128-byte swizzle (the layout TMA writes and `wgmma` reads): the 16-byte
// chunk c / 8 of row r moves to chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ int sw128_at(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

constexpr int TILE_ELEMS = 64 * 64;           // one 64 x 64 bf16 tile
constexpr int TILE_BYTES = TILE_ELEMS * 2;

// The 1024-byte-aligned start of the dynamic shared memory.
__device__ __forceinline__ unsigned char* smem_base_1k() {
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~static_cast<uintptr_t>(1023));
}

// One warpgroup (blockDim.x == 128) computes acc[j] = A . B_j^T over the k
// tiles kt0 .. kt1-1: A is the 64-row box of `ma` at row a_row, B_j the
// 64-row box of mb[j] at row b_row[j]. Thread 0 keeps the tiles coming by
// TMA through RING stages of 1 + NB tiles at `ring` (1024-byte aligned) that
// complete on `bars` (RING barriers, initialised here). The products of one
// stage run while the next stage's tiles are awaited: a stage is refilled
// once the products that read it have retired in every warp.
template <int NB, int RING>
__device__ __forceinline__ void wg_mainloop(float (&acc)[NB][32], __nv_bfloat16* ring,
                                            uint64_t* bars, const CUtensorMap* ma, int a_row,
                                            const CUtensorMap* const (&mb)[NB],
                                            const int (&b_row)[NB], int kt0, int kt1) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto load = [&](int kt) {
    const int st = (kt - kt0) % RING;
    __nv_bfloat16* t = ring + st * (1 + NB) * TILE_ELEMS;
    mbar_expect_tx(&bars[st], (1 + NB) * TILE_BYTES);
    tma_load_2d(t, ma, &bars[st], kt * 64, a_row);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_2d(t + (1 + j) * TILE_ELEMS, mb[j], &bars[st], kt * 64, b_row[j]);
  };
  if (tid == 0)
    for (int kt = kt0; kt < kt1 && kt < kt0 + RING; ++kt) load(kt);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % RING;
    mbar_wait(&bars[st], ((kt - kt0) / RING) & 1);
    const __nv_bfloat16* t = ring + st * (1 + NB) * TILE_ELEMS;
#pragma unroll
    for (int j = 0; j < NB; ++j) acc_fence(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NB; ++j) wgmma_tile_k64(acc[j], t, t + (1 + j) * TILE_ELEMS);
    wgmma_commit();
    wgmma_wait_one();  // the previous stage's products have retired
#pragma unroll
    for (int j = 0; j < NB; ++j) acc_fence(acc[j]);
    __syncthreads();
    if (tid == 0 && kt > kt0 && kt - 1 + RING < kt1) load(kt - 1 + RING);
  }
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NB; ++j) acc_fence(acc[j]);
  __syncthreads();  // the ring is free for the caller's epilogue
}

// One product of `wgmma_products_kernel`: out[split][i][j] (fp32, row stride
// ldo) = sum over the split's share of k of A[i][k] B[j][k], for A (m, k)
// and B (nn, k) read through the job's tensor maps; the job's tiles start at
// block `block0` of the launch.
struct ProductJob {
  int m, nn, k, splits, tiles_n, block0;
  float* out;
  int ldo;
};

template <int J>
struct ProductMaps {
  CUtensorMap a[J], b[J];
};

template <int J>
struct ProductJobs {
  ProductJob job[J];
};

constexpr int PRODUCT_RING = 4;
constexpr size_t PRODUCT_SMEM = 1024 + PRODUCT_RING * 2 * TILE_BYTES + PRODUCT_RING * 8;

// J independent products in one launch: one warpgroup per 64 x 64 output
// tile (and split of k), each element of `out` with one owner.
template <int J>
__global__ void __launch_bounds__(128)
wgmma_products_kernel(const __grid_constant__ ProductMaps<J> maps, ProductJobs<J> jobs) {
  unsigned char* base = smem_base_1k();
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + PRODUCT_RING * 2 * TILE_BYTES);
  int j = 0;
  while (j < J - 1 && (int)blockIdx.x >= jobs.job[j + 1].block0) ++j;
  const ProductJob& jb = jobs.job[j];
  const int local = blockIdx.x - jb.block0;
  const int split = local % jb.splits, tile = local / jb.splits;
  const int m0 = (tile / jb.tiles_n) * 64, n0 = (tile % jb.tiles_n) * 64;
  const int kt_all = (jb.k + 63) / 64, per = (kt_all + jb.splits - 1) / jb.splits;
  const int kt0 = split * per, kt1 = min(kt_all, kt0 + per);
  const CUtensorMap* const mb[1] = {&maps.b[j]};
  const int b_row[1] = {n0};
  float acc[1][32];
  wg_mainloop<1, PRODUCT_RING>(acc, ring, bars, &maps.a[j], m0, mb, b_row, kt0, kt1);

  float* out = jb.out + (size_t)split * jb.m * jb.ldo;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + w * 16 + g + (e >> 1) * 8, c = n0 + i * 8 + 2 * q + (e & 1);
      if (r < jb.m && c < jb.nn) out[(size_t)r * jb.ldo + c] = acc[0][4 * i + e];
    }
}

// Fills in block0 of every job; returns the launch's block count.
template <int J>
inline int product_blocks(ProductJobs<J>* jobs) {
  int blocks = 0;
  for (int j = 0; j < J; ++j) {
    jobs->job[j].block0 = blocks;
    blocks += (jobs->job[j].m + 63) / 64 * jobs->job[j].tiles_n * jobs->job[j].splits;
  }
  return blocks;
}

// ---- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 matrix (rows x cols, row stride `ld`
// elements, a multiple of 8) read in boxes of 64 columns x `box_rows` rows,
// 128-byte swizzled; elements past `rows` or `cols` read as zero.
inline bool tensor_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int ld,
                          int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace avec
