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
// tiles are skipped, so exp(s - lse) is never evaluated there. No (T, T)
// tensor reaches device memory. p and dS are fp32, as in the TPU kernel
// (:212-221, :258-270), whose three gradient products multiply them in fp32.
//
// What bounds it on the H100: bytes. At the training shapes (B=16, H=4,
// T=151/76, d_a=321/451, d_v=64/90) one call reads the valid rows of q', k',
// v, dO once and writes dq', dk', dV: about 17 MB at T = 151, 5 us at 3.35
// TB/s; its products (s and dO V^T twice, three gradient products, about
// 2 T len (4 d_a + 4 d_v) per head) take about 2.5 us at the bf16
// tensor-core peak.
//
// bf16 (the training path), for Hopper's tensor cores. Three launches on the
// caller's stream, over scratch that the wrapper allocates
// (avec_flash_attention_bwd_scratch_bytes):
//   1 prep  bf16 copies of q', k' (rows padded to lda = d_a rounded up to 8)
//           and of v, dO (ldv), pad columns zero: rows of 642 / 902 / 180
//           bytes are no multiple of 16, which TMA's strides need; rows past
//           the length are zeros, not read (`flash_common.cuh`, shared with
//           the forward);
//   2 dq    one warpgroup per (b*h, 64-query tile, 192 columns of d_a);
//   3 dk/dV one warpgroup per (b*h, 64-key tile, 192 columns of d_a), and
//           per (b*h, 64-key tile) one more for dV.
// Both main kernels are one template: a block keeps its own 64 rows of the
// two row operands (q' and dO for dq, k' and v for dk/dV) in shared memory
// and streams the other side's 64-row tiles (k' and v, or q' and dO) up to
// the true length, all by TMA as 64 x 64 boxes, 128-byte swizzled. Per
// streamed tile it forms s and dO V^T (or their transposes) with `wgmma`
// from the K-major tiles, computes p and dS in fp32 in the accumulators'
// registers, splits them there into three bf16 parts that sum to them
// exactly (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)), and
// adds part . B for each part into its output columns, with A from registers
// and B the streamed tile itself read MN-major (the transpose bit of
// `wgmma`, hopper.cuh `wgmma_64x64_rs_mn`): the tile that was the B^T of s is
// the B of the gradient product, so no transposed copy is written or read.
// The column split over the grid (each block recomputes s and dO V^T, 2.7
// MFLOP per tile pair at d_a = 321) keeps the accumulators at 96 registers a
// thread; at T = 151 two blocks fit on an SM (112 KB of tiles each), and the
// 224 dq blocks below the lengths run in one wave. Each output tile has one
// owner and sums its streamed tiles in order: no atomics, the same bits on
// every run. The streamed tiles that the gradient product does not read are
// reloaded for the next tile as soon as s and dO V^T have retired; the output
// tile leaves through shared memory, a warp's stores one row's neighbouring
// columns. What bounds it now is latency, not bytes: one warpgroup per block
// and at most two blocks per SM wait in turn on the first tiles' arrival, on
// the fp32 p / dS and split code and on the products.
// Built with -DAVEC_FLASH_BWD_PARTS=1 (a control that only the card test and
// chip_smoke.py build, into their own library) p and dS are rounded to bf16
// instead, to measure what the three parts buy.
//
// fp32 (the verification path) keeps the first version's FMA kernels: one
// block of 256 threads per (b*h, 64-query tile) for dq and per (b*h, 64-key
// tile) for dk/dV, s and dO V^T built in 32-wide chunks staged transposed
// with masked loads, p and dS through shared memory, the gradient tiles in
// registers, 4 x 4 per thread for each 64-column block of d_a (and of d_v).

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tile.cuh"

namespace {

using namespace avec;
using namespace avec::flash;

// `which` of the C entry: dq, dk and dV (both: the backward)
constexpr int BWD_DQ = 1, BWD_DKV = 2;
constexpr int THREADS = 256;   // FMA path: 16 x 16 threads, 4 x 4 register tile each

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *lengths;
  int heads, t, da, dv;
  float scale;
};

// ---- fp32: FMA kernels

// p and dS for this thread's 4 x 4 (query, key) tile.
__device__ __forceinline__ void probs_tile(float (&p)[4][4], float (&ds)[4][4], const float* q,
                                           const float* k, const float* v, const float* dout,
                                           const float* lse, const float* delta, int q0, int k0,
                                           int t, int valid, int da, int dv, float scale,
                                           float* sa) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<float>(s, q, q0, k, k0, t, da, sa);
  tile_dot<float>(dp, dout, q0, v, k0, t, dv, sa);
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

template <int NCB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ lengths, float* __restrict__ dq, int heads, int t,
                    int da, int dv, float scale) {
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
      probs_tile(p, ds, q, k, v, dout, lse, delta, q0, k0, t, valid, da, dv, scale, sa);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[(tx * 4 + j) * TS + ty * 4 + i] = ds[i][j];
      __syncthreads();
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        stage_direct<float, BT, 64>(sa, k, da, k0, t, cb * 64, da);
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
          dq[qk_base + (size_t)row * da + col] = acc[cb][i][j] * scale;
      }
}

template <int NCB, int NVB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lengths, float* __restrict__ dk,
                     float* __restrict__ dvo, int heads, int t, int da, int dv, float scale) {
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
        probs_tile(p, ds, q, k, v, dout, lse, delta, q0, k0, t, valid, da, dv, scale, sa);
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
        stage_direct<float, BT, 64>(sa, dout, dv, q0, t, vb * 64, dv);
        __syncthreads();
        mma_kk(dva[vb], ps + ty * 4, TS, sa + tx * 4, TS, BT);
        __syncthreads();
      }
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        stage_direct<float, BT, 64>(sa, q, da, q0, t, cb * 64, da);
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
        if (col < da) dk[qk_base + (size_t)row * da + col] = dka[cb][i][j] * scale;
      }
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) {
        const int col = vb * 64 + tx * 4 + j;
        if (col < dv) dvo[v_base + (size_t)row * dv + col] = dva[vb][i][j];
      }
    }
  }
}

constexpr size_t DQ_SMEM = sizeof(float) * 2 * BT * TS;
constexpr size_t DKV_SMEM = sizeof(float) * 3 * BT * TS;

template <int NCB>
cudaError_t launch_dq(const Args& a, void* dq, int bh, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<NCB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)DQ_SMEM);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(bh, cdiv(a.t, BT));
  kern<<<grid, THREADS, DQ_SMEM, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.lengths), static_cast<float*>(dq), a.heads, a.t, a.da, a.dv,
      a.scale);
  return cudaGetLastError();
}

template <int NCB, int NVB>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, int bh, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<NCB, NVB>;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)DKV_SMEM);
  if (rc != cudaSuccess) return rc;
  const dim3 grid(bh, cdiv(a.t, BT));
  kern<<<grid, THREADS, DKV_SMEM, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.lengths), static_cast<float*>(dk), static_cast<float*>(dv),
      a.heads, a.t, a.da, a.dv, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dq(const Args& a, void* dq, int bh, cudaStream_t s) {
  if (a.da <= 128) return launch_dq<2>(a, dq, bh, s);
  if (a.da <= 384) return launch_dq<6>(a, dq, bh, s);
  return launch_dq<8>(a, dq, bh, s);
}

template <int NVB>
cudaError_t dispatch_dkv_da(const Args& a, void* dk, void* dv, int bh, cudaStream_t s) {
  if (a.da <= 128) return launch_dkv<2, NVB>(a, dk, dv, bh, s);
  if (a.da <= 384) return launch_dkv<6, NVB>(a, dk, dv, bh, s);
  return launch_dkv<8, NVB>(a, dk, dv, bh, s);
}

cudaError_t dispatch_dkv(const Args& a, void* dk, void* dv, int bh, cudaStream_t s) {
  if (a.dv <= 64) return dispatch_dkv_da<1>(a, dk, dv, bh, s);
  return dispatch_dkv_da<2>(a, dk, dv, bh, s);
}

// ---- bf16: tensor-core kernels

constexpr int WG = 128;                         // one warpgroup
constexpr int GT = 3;                           // 64-column output tiles per block
constexpr int OUT_LD = GT * 64 + 8;             // row stride of the staged output tile
#ifndef AVEC_FLASH_BWD_PARTS
#define AVEC_FLASH_BWD_PARTS 3
#endif
constexpr int PARTS = AVEC_FLASH_BWD_PARTS;     // bf16 parts of p and dS
static_assert(PARTS == 3 || PARTS == 1, "p and dS enter as 3 parts, or 1 (the control)");

struct Maps {
  CUtensorMap q, k, v, dout;  // the copies as (bh * t, width) boxes of 64 x 64
};

// Without the 1024 bytes of alignment slack that `smem_base_1k` allows for:
// a kernel without static shared memory finds its dynamic shared memory
// 1024-aligned (the kernel traps otherwise), and at T = 151 (7 tiles a side)
// two blocks then fit on an SM, 48 bytes short with the slack.
size_t main_smem(int da, int dv) {
  return 2 * (size_t)(cdiv(da, 64) + cdiv(dv, 64)) * hopper::TILE_BYTES + 3 * 8;
}

// Stages 2 and 3. KV = false: dq; blockIdx = (b*h, 64-query tile, GT-tile
// group of d_a). KV = true: dk/dV; blockIdx = (b*h, 64-key tile, group), the
// last group dV. "Own" tiles are the block's 64 rows of its row operands
// (q' then dO, or k' then v), "streamed" tiles the other side's 64 rows of
// the same two (k' then v, or q' then dO), one tile per 64 columns. In the
// accumulators, rows are own rows and columns streamed rows.
template <bool KV>
__global__ void __launch_bounds__(WG, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ lengths,
                       bf16* __restrict__ out_a, bf16* __restrict__ out_v, int heads, int t,
                       int da, int dv, float scale) {
  using namespace hopper;
  const int nca = cdiv(da, 64), ncv = cdiv(dv, 64), ntiles = nca + ncv;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw;
  if ((smem_u32(base) & 1023) != 0) __trap();
  bf16* own = reinterpret_cast<bf16*>(base);  // ntiles tiles, swizzled
  bf16* str = own + ntiles * TILE_ELEMS;      // ntiles tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(str + ntiles * TILE_ELEMS);
  uint64_t *own_bar = bars, *rest_bar = bars + 1, *grp_bar = bars + 2;
  const int tid = threadIdx.x, bh = blockIdx.x, r0 = blockIdx.y * BT, grp = blockIdx.z;
  const int w = tid / 32, g = (tid % 32) >> 2, qd = tid & 3;
  const int valid = clamp_len(lengths, bh / heads, t);
  const int row_base = bh * t;
  // The block's output tiles among the streamed ones: dV reads the streamed
  // dO tiles and needs no dO V^T; the others read up to GT streamed q' (k')
  // tiles. The other streamed tiles ("rest") are free once s and dO V^T
  // have retired.
  const bool v_group = KV && grp == cdiv(nca, GT);
  const int o0 = v_group ? nca : GT * grp;
  const int no = v_group ? ncv : min(GT, nca - GT * grp);
  const bool need_dp = !v_group;
  uint32_t rest = 0;
  for (int i = 0; i < (need_dp ? ntiles : nca); ++i)
    if (i < o0 || i >= o0 + no) rest |= 1u << i;
  const CUtensorMap* own_a = KV ? &maps.k : &maps.q;
  const CUtensorMap* own_v = KV ? &maps.v : &maps.dout;
  const CUtensorMap* str_a = KV ? &maps.q : &maps.k;
  const CUtensorMap* str_v = KV ? &maps.dout : &maps.v;
  const int nj = r0 < valid ? cdiv(valid, BT) : 0;  // streamed tiles up to the length

  auto load_str = [&](int i, int j, uint64_t* bar) {
    const bool a = i < nca;
    tma_load_2d(str + i * TILE_ELEMS, a ? str_a : str_v, bar, (a ? i : i - nca) * 64,
                row_base + j * BT);
  };
  auto issue_rest = [&](int j) {
    mbar_expect_tx(rest_bar, __popc(rest) * TILE_BYTES);
    for (uint32_t m = rest; m != 0; m &= m - 1) load_str(__ffs(m) - 1, j, rest_bar);
  };
  auto issue_grp = [&](int j) {
    mbar_expect_tx(grp_bar, no * TILE_BYTES);
    for (int i = o0; i < o0 + no; ++i) load_str(i, j, grp_bar);
  };

  float acc[GT][32];
#pragma unroll
  for (int n = 0; n < GT; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[n][i] = 0.f;

  if (nj > 0) {
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      tma_prefetch_desc(&maps.q);
      tma_prefetch_desc(&maps.k);
      tma_prefetch_desc(&maps.v);
      tma_prefetch_desc(&maps.dout);
      const int n_own = nca + (need_dp ? ncv : 0);
      mbar_expect_tx(own_bar, n_own * TILE_BYTES);
      for (int i = 0; i < n_own; ++i) {
        const bool a = i < nca;
        tma_load_2d(own + i * TILE_ELEMS, a ? own_a : own_v, own_bar, (a ? i : i - nca) * 64,
                    row_base + r0);
      }
      issue_rest(0);
      issue_grp(0);
    }
    // lse and delta of the own rows (dq: queries, fixed) are read once.
    float l_row[2] = {0.f, 0.f}, d_row[2] = {0.f, 0.f};
    if constexpr (!KV) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + w * 16 + g + 8 * h;
        if (row < valid) {
          l_row[h] = lse[(size_t)row_base + row];
          d_row[h] = delta[(size_t)row_base + row];
        }
      }
    }
    mbar_wait(own_bar, 0);

    for (int j = 0; j < nj; ++j) {
      const uint32_t par = j & 1;
      mbar_wait(rest_bar, par);
      mbar_wait(grp_bar, par);
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      acc_fence(s);
      acc_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 8; ++kt)
        if (kt < nca) wgmma_tile_k64(s, own + kt * TILE_ELEMS, str + kt * TILE_ELEMS);
#pragma unroll
      for (int vt = 0; vt < 2; ++vt)
        if (need_dp && vt < ncv)
          wgmma_tile_k64(dp, own + (nca + vt) * TILE_ELEMS, str + (nca + vt) * TILE_ELEMS);
      wgmma_commit();
      wgmma_wait_all();
      acc_fence(s);
      acc_fence(dp);
      __syncthreads();  // every warp's products have read the streamed tiles
      if (tid == 0 && j + 1 < nj) issue_rest(j + 1);

      // lse and delta of the streamed rows (dk/dV: queries, the columns).
      float l_col[8][2], d_col[8][2];
      if constexpr (KV) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * BT + 8 * i + 2 * qd + e;
            const bool ok = col < valid;
            l_col[i][e] = ok ? lse[(size_t)row_base + col] : 0.f;
            d_col[i][e] = ok ? delta[(size_t)row_base + col] : 0.f;
          }
      }
      // x = dS (or p for dV) in place of s; 0 outside the valid square.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = e & 1;
          const int own_row = r0 + w * 16 + g + 8 * h, col = j * BT + 8 * i + 2 * qd + c;
          const bool ok = own_row < valid && col < valid;
          float l, dl;
          if constexpr (KV) {
            l = l_col[i][c];
            dl = d_col[i][c];
          } else {
            l = l_row[h];
            dl = d_row[h];
          }
          const float p = ok ? expf(s[4 * i + e] * scale - l) : 0.f;
          s[4 * i + e] = v_group ? p : p * (dp[4 * i + e] - dl);
        }
      // The parts of x as A fragments: k slice ks holds columns 16 ks .. +15.
      uint32_t af[4][PARTS][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_pair<PARTS>(make_float2(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]), af[ks], r);
#pragma unroll
      for (int n = 0; n < GT; ++n) acc_fence(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int n = 0; n < GT; ++n) {
        if (n >= no) continue;
        const bf16* b = str + (o0 + n) * TILE_ELEMS;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int pt = 0; pt < PARTS; ++pt)
            wgmma_64x64_rs_mn(acc[n], af[ks][pt], b + ks * 16 * 64);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int pt = 0; pt < PARTS; ++pt) reg_fence(af[ks][pt]);
#pragma unroll
      for (int n = 0; n < GT; ++n) acc_fence(acc[n]);
      __syncthreads();  // every warp's products have read the group's tiles
      if (tid == 0 && j + 1 < nj) issue_grp(j + 1);
    }
  }

  // Rows at or past the length (and whole blocks past it) store zeros. The
  // tile goes through shared memory (free now: every load has landed and
  // every product retired), so that a warp's stores are 32 neighbouring
  // columns of one row; the rows of 642 / 902 / 180 bytes allow no wider
  // aligned stores.
  const float mult = v_group ? 1.f : scale;
  bf16* stage = reinterpret_cast<bf16*>(base);  // [64][OUT_LD]
#pragma unroll
  for (int n = 0; n < GT; ++n) {
    if (n >= no) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(stage + (w * 16 + g + 8 * h) * OUT_LD + n * 64 + 8 * i +
                                           2 * qd) =
            __floats2bfloat162_rn(acc[n][4 * i + 2 * h] * mult, acc[n][4 * i + 2 * h + 1] * mult);
  }
  __syncthreads();
  const int width = v_group ? dv : da, c0 = v_group ? 0 : o0 * 64;
  const int cols = min(no * 64, width - c0), rows = min(BT, t - r0), lane = tid % 32;
  bf16* out = (v_group ? out_v : out_a) + ((size_t)row_base + r0) * width + c0;
#pragma unroll 2
  for (int r = w; r < rows; r += WG / 32) {  // one warp per row
    bf16 vals[GT * 2];
#pragma unroll
    for (int m = 0; m < GT * 2; ++m) vals[m] = stage[r * OUT_LD + lane + 32 * m];
#pragma unroll
    for (int m = 0; m < GT * 2; ++m)
      if (lane + 32 * m < cols) out[(size_t)r * width + lane + 32 * m] = vals[m];
  }
}

template <bool KV>
cudaError_t launch_main(const Maps& maps, const Args& a, void* out_a, void* out_v, int bh,
                        cudaStream_t st) {
  auto kern = flash_bwd_wgmma_kernel<KV>;
  static bool attr = false;  // the largest shared memory, set once
  if (!attr) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)main_smem(512, 128));
    if (rc != cudaSuccess) return rc;
    attr = true;
  }
  const dim3 grid(bh, cdiv(a.t, BT), cdiv(cdiv(a.da, 64), GT) + (KV ? 1 : 0));
  kern<<<grid, WG, main_smem(a.da, a.dv), st>>>(
      maps, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.lengths), static_cast<bf16*>(out_a), static_cast<bf16*>(out_v),
      a.heads, a.t, a.da, a.dv, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const Args& a, void* dq, void* dk, void* dv_out, void* scratch, int bh,
                        int which, cudaStream_t st) {
  const int rows = bh * a.t;
  Copies c;
  carve(static_cast<char*>(scratch), rows, a.da, a.dv, true, &c);
  Maps maps;
  if (!hopper::tensor_map_2d(&maps.q, c.q, rows, a.da, c.lda, BT) ||
      !hopper::tensor_map_2d(&maps.k, c.k, rows, a.da, c.lda, BT) ||
      !hopper::tensor_map_2d(&maps.v, c.v, rows, a.dv, c.ldv, BT) ||
      !hopper::tensor_map_2d(&maps.dout, c.dout, rows, a.dv, c.ldv, BT))
    return cudaErrorInvalidValue;
  cudaError_t rc = launch_prep<false>(a.q, a.k, a.v, a.dout, a.lengths, c, rows, a.t, a.heads,
                                      a.da, a.dv, st);
  if (rc == cudaSuccess && (which & BWD_DQ))
    rc = launch_main<false>(maps, a, dq, nullptr, bh, st);
  if (rc == cudaSuccess && (which & BWD_DKV))
    rc = launch_main<true>(maps, a, dk, dv_out, bh, st);
  return rc;
}

}  // namespace

// Bytes of scratch one backward call needs (0: none, the fp32 path).
extern "C" long long avec_flash_attention_bwd_scratch_bytes(int bh, int t, int da, int dv,
                                                            int is_bf16) {
  if (!is_bf16 || bh <= 0 || t <= 0 || da <= 0 || dv <= 0) return 0;
  Copies c;
  return (long long)carve(nullptr, bh * t, da, dv, true, &c);
}

// q, k, dq, dk: (bh, t, da); v, dout, dv_out: (bh, t, dv), of one dtype (fp32
// or bf16); lse, delta: (bh, t) fp32; lengths: (bh / heads,) int32. `which`
// (3: the backward): bit 0 computes dq, bit 1 dk and dV (dq alone: the dq
// half of the call that chip_smoke.py times). bf16 writes its copies into
// `scratch`, a device buffer of avec_flash_attention_bwd_scratch_bytes
// (256-byte aligned), in every call before its kernels read them; fp32
// needs none. d_a <= 512 and d_v <= 128. Returns the launches' cudaError_t.
extern "C" int avec_flash_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* lengths, void* dq, void* dk, void* dv_out,
                                        void* scratch, int bh, int heads, int t, int da, int dv,
                                        float scale, int is_bf16, int which, void* stream) {
  if (bh <= 0 || heads <= 0 || t <= 0 || da <= 0 || dv <= 0 || da > 512 || dv > 128 ||
      which < 1 || which > 3)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, lengths, heads, t, da, dv, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    return launch_bf16(a, dq, dk, dv_out, scratch, bh, which, s);
  }
  cudaError_t rc = cudaSuccess;
  if (which & BWD_DQ) rc = dispatch_dq(a, dq, bh, s);
  if (rc == cudaSuccess && (which & BWD_DKV)) rc = dispatch_dkv(a, dk, dv_out, bh, s);
  return rc;
}
