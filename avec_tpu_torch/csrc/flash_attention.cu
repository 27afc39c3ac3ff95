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
// (T, T) score matrix in device memory. Keys past the length score -1e30
// (the TPU kernel's mask value), so a sequence of length 0 averages v over
// all T keys; key tiles past the length are skipped. lse is written flat as
// (B*H, T) fp32, the layout the backward (flash_attention_bwd.cu) reads. The
// Mosaic workarounds of the TPU kernel (128-lane padding of d_a / d_v, the
// lane-replicated lse) are not carried over.
//
// What bounds it on the H100: latency. At the serving shapes (B=8, H=4,
// T=201/101, d_a=321/451, d_v=64/90) one call does 2*B*H*T*len*(d_a+d_v)
// operations on a few MB of inputs, a few microseconds at the bf16
// tensor-core peak and about as much at the memory rate; a launch of
// 64-128 blocks (224 in training) walks up to 4 key tiles one after the
// other, each a chain of TMA load, product, softmax and product.
//
// bf16 (the serving path and the flash training route), for Hopper's tensor
// cores. Two launches on the caller's stream, over scratch that the wrapper
// allocates (avec_flash_attention_fwd_scratch_bytes):
//   1 prep  bf16 copies of q', k' and v with rows rounded up to 8 elements,
//           pad columns zero (`flash_common.cuh`, shared with the backward):
//           TMA needs 16-byte row strides;
//   2 main  one warpgroup per (b*h, 64-query tile) and a producer warp. The
//           block keeps its q' tile in shared memory as 64 x 64 TMA boxes,
//           128-byte swizzled; the producer streams, per 64-key tile up to
//           the length, its k' tiles, then its v tiles, through a ring of
//           single-tile stages on `mbarrier`s, refilling a stage as soon as
//           the four consumer warps have released it (as many stages as let
//           two blocks share an SM where that many fit, at most two key
//           tiles' operands).
//           Per key tile the consumers form s = q' k'^T with `wgmma` (both
//           K-major), scale and mask it and run the online softmax in the
//           accumulator's registers (a row is held by the four lanes of a
//           quad, so its max and sum are two shuffles), split p into three
//           bf16 parts that sum to it exactly (the TPU kernel multiplies p
//           in fp32), and add part . V with A from registers and V the
//           streamed tile read MN-major (hopper.cuh `wgmma_64x64_rs_mn`), so
//           v is never transposed; d_v = 90 runs as two 64-column outputs.
// Each element of out and lse has one owner and no sum crosses blocks: no
// atomics, the same bits on every run. Rows of the last query tile past T
// (the next sequence's, or TMA's zeros) are computed and not written.
// Built with -DAVEC_FLASH_FWD_PARTS=1 (a control that only the card test and
// chip_smoke.py build, into their own library) p is rounded to bf16
// instead, to measure what the three parts buy.
//
// fp32 (the verification path) keeps the first version: one block of 256
// threads per (b*h, 64-query tile), a loop over 64-key tiles carrying the
// running max, normaliser and an fp32 accumulator in registers (4 query
// rows x d_v/16 columns per thread), scores built as FMAs from 32-wide
// chunks of d_a staged transposed in shared memory (masked loads, zeros
// past d_a).

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tile.cuh"

#include <math.h>

namespace {

using namespace avec;
using namespace avec::flash;

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

// ---- fp32: FMA kernel

constexpr int DC = 32;        // d_a chunk staged per pass
constexpr int PAD = 4;        // row padding of the transposed chunks (floats)
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 score tile each

template <int DVP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ out, float* __restrict__ lse, int heads, int t, int da,
                 int dv, float scale) {
  constexpr int CPT = DVP / 16;  // output columns per thread
  // Transposed Q and K chunks ([DC][64 + PAD] each); reused as P [64][65].
  __shared__ __align__(16) float smem_a[2 * DC * (BT + PAD)];
  __shared__ __align__(16) float vs[BT * DVP];
  float* qs = smem_a;
  float* ks = smem_a + DC * (BT + PAD);
  float* ps = smem_a;
  static_assert(BT * (BT + 1) <= 2 * DC * (BT + PAD), "P must fit the Q/K chunks");

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx*4 .. tx*4+3
  const int valid = clamp_len(lengths, bh / heads, t);
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

  for (int k0 = 0; k0 < kend; k0 += BT) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int c0 = 0; c0 < da; c0 += DC) {
      for (int e = tid; e < BT * DC; e += THREADS) {
        const int r = e / DC, c = e % DC, col = c0 + c;
        const int qi = q0 + r, kj = k0 + r;
        float qv = 0.f, kv = 0.f;
        if (col < da) {
          if (qi < t) qv = q[qk_base + (size_t)qi * da + col];
          if (kj < t) kv = k[qk_base + (size_t)kj * da + col];
        }
        qs[c * (BT + PAD) + r] = qv;
        ks[c * (BT + PAD) + r] = kv;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[c * (BT + PAD) + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ks[c * (BT + PAD) + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
      __syncthreads();
    }

    for (int e = tid; e < BT * DVP; e += THREADS) {
      const int r = e / DVP, c = e % DVP, kj = k0 + r;
      vs[e] = (kj < t && c < dv) ? v[v_base + (size_t)kj * dv + c] : 0.f;
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
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * (BT + 1) + tx * 4 + j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BT + 1) + kk];
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
      if (col < dv) out[v_base + (size_t)row * dv + col] = acc[i][c] / ll;
    }
    if (tx == 0) lse[(size_t)bh * t + row] = m[i] + logf(ll);
  }
}

template <int DVP>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const void* lengths,
                        void* out, void* lse, int bh, int heads, int t, int da, int dv,
                        float scale, cudaStream_t stream) {
  const dim3 grid(bh, cdiv(t, BT));
  flash_fwd_kernel<DVP><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lengths), static_cast<float*>(out), static_cast<float*>(lse),
      heads, t, da, dv, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const void* q, const void* k, const void* v, const void* lengths,
                          void* out, void* lse, int bh, int heads, int t, int da, int dv,
                          float scale, cudaStream_t s) {
  if (dv <= 32) return launch_fp32<32>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
  if (dv <= 64) return launch_fp32<64>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
  return launch_fp32<96>(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
}

// ---- bf16: tensor-core kernel

constexpr int WG = 128;  // the consumer warpgroup; one producer warp besides
#ifndef AVEC_FLASH_FWD_PARTS
#define AVEC_FLASH_FWD_PARTS 3
#endif
constexpr int PARTS = AVEC_FLASH_FWD_PARTS;  // bf16 parts of p
static_assert(PARTS == 3 || PARTS == 1, "p enters as 3 parts, or 1 (the control)");

struct FwdMaps {
  CUtensorMap q, k, v;  // the copies as (bh * t, width) boxes of 64 x 64
};

// The main kernel's shared memory: the q' tiles, the ring, its 2 ring + 1
// barriers. Without the 1024 bytes of alignment slack that `smem_base_1k`
// allows for: a kernel without static shared memory finds its dynamic
// shared memory 1024-aligned (the kernel traps otherwise), and at d_a = 321
// two blocks then fit on an SM with a ring of 8.
size_t fwd_smem(int nca, int ring) {
  return (size_t)(nca + ring) * hopper::TILE_BYTES + (2 * ring + 1) * 8;
}

// The card's shared memory limits (per SM, per block, and what the system
// keeps of each block's), read once.
struct Limits {
  int smem_sm, smem_block, reserved;
};

const Limits& limits() {
  static const Limits lim = [] {
    Limits l{233472, 232448, 1024};
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&l.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
      cudaDeviceGetAttribute(&l.smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      cudaDeviceGetAttribute(&l.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    }
    return l;
  }();
  return lim;
}

// Stages of the ring: at most two key tiles' operands (nca k' tiles and ncv
// v tiles each) and never fewer than one key tile's, which the consumers
// take as one group; as many as let two blocks share an SM where that many
// fit (d_a = 321, d_v = 64: 8 stages; at T = 151, B = 16 the 192 blocks then
// run at once, 17 us a launch on an H100 against 23 with one block an SM),
// else as many as one block may hold. 0: does not fit.
int fwd_ring(int nca, int ncv) {
  const Limits& lim = limits();
  const int per_key = nca + ncv;
  const long long budgets[2] = {lim.smem_sm / 2 - lim.reserved, lim.smem_block};
  for (const long long budget : budgets)
    for (int r = 2 * per_key; r >= per_key; --r)
      if ((long long)fwd_smem(nca, r) <= budget) return r;
  return 0;
}

// One warpgroup of consumers per (b*h, 64-query tile) and one producer warp,
// NCV = ceil(d_v / 64) output tiles. The producer's lane 0 asks for the q'
// tiles, then for every streamed tile in the order the products take them
// (per key tile its nca k' tiles, then its NCV v tiles), each into the next
// stage once the four consumer warps have released it. The consumers take a
// key tile's k' tiles as one group and its v tiles as the next.
template <int NCV>
__global__ void __launch_bounds__(WG + 32)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, const int* __restrict__ lengths,
                       bf16* __restrict__ out, float* __restrict__ lse, int heads, int t, int da,
                       int dv, int ring_n, float scale) {
  using namespace hopper;
  const int nca = cdiv(da, 64);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if ((smem_u32(smem_raw) & 1023) != 0) __trap();
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                               // nca tiles
  bf16* ring = qs + nca * TILE_ELEMS;                                         // ring_n tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_n * TILE_ELEMS);  // ring_n
  uint64_t* empty = full + ring_n;                                            // ring_n
  uint64_t* q_bar = empty + ring_n;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane >> 2, qd = lane & 3;
  const int bh = blockIdx.x, q0 = blockIdx.y * BT, row_base = bh * t;
  const int valid = clamp_len(lengths, bh / heads, t);
  // a row without valid keys softmaxes uniformly over all T keys
  const int nkt = cdiv(valid > 0 ? valid : t, BT);

  if (tid == 0) {
    for (int i = 0; i < ring_n; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WG / 32);  // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();  // the only barrier of all WG + 32 threads

  if (w == WG / 32) {  // the producer warp
    if (lane != 0) return;
    tma_prefetch_desc(&maps.q);
    tma_prefetch_desc(&maps.k);
    tma_prefetch_desc(&maps.v);
    mbar_expect_tx(q_bar, nca * TILE_BYTES);
    for (int kc = 0; kc < nca; ++kc)
      tma_load_2d(qs + kc * TILE_ELEMS, &maps.q, q_bar, kc * 64, row_base + q0);
    int slot = 0, use = 0;  // stage, and how often it was filled before
    for (int j = 0; j < nkt; ++j)
      for (int i = 0; i < nca + NCV; ++i) {
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        mbar_expect_tx(&full[slot], TILE_BYTES);
        const bool a = i < nca;
        tma_load_2d(ring + slot * TILE_ELEMS, a ? &maps.k : &maps.v, &full[slot],
                    (a ? i : i - nca) * 64, row_base + j * BT);
        if (++slot == ring_n) slot = 0, ++use;
      }
    return;
  }

  // the consumers' view: the first stage of the group being taken and the
  // parity of that stage's use
  int out_slot = 0, out_par = 0;
  auto stage_of = [&](int i, int& par) {
    int st = out_slot + i;
    par = out_par;
    if (st >= ring_n) st -= ring_n, par ^= 1;
    return st;
  };
  auto tile = [&](int i) {  // the i-th tile of the group being taken
    int par;
    return static_cast<const bf16*>(ring + stage_of(i, par) * TILE_ELEMS);
  };
  auto wait_group = [&](int count) {
    for (int i = 0; i < count; ++i) {
      int par;
      const int st = stage_of(i, par);
      mbar_wait(&full[st], par);
    }
  };
  // this warp has retired its products on the group's `count` tiles
  auto release = [&](int count) {
    if (lane == 0)
      for (int i = 0; i < count; ++i) {
        int par;
        mbar_arrive(&empty[stage_of(i, par)]);
      }
    out_slot = stage_of(count, out_par);
  };

  // this thread's rows r0 = 16 w + g (h = 0) and r0 + 8 (h = 1): running max,
  // normaliser and output columns, in the accumulator layout of hopper.cuh
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NCV][32];
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int j = 0; j < nkt; ++j) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wait_group(nca);
    acc_fence(s);
    wgmma_fence();
    for (int kc = 0; kc < nca; ++kc) wgmma_tile_k64(s, qs + kc * TILE_ELEMS, tile(kc));
    wgmma_commit();
    wgmma_wait_all();
    acc_fence(s);
    release(nca);

    // scale and mask: -inf past t (no key), -1e30 at keys past the length
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BT + 8 * i + 2 * qd + (e & 1);
        float v = s[4 * i + e] * scale;
        if (col >= t) v = -INFINITY;
        else if (col >= valid) v = NEG_INF;
        s[4 * i + e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    // p's parts as A fragments: k slice ks holds key columns 16 ks .. +15
    uint32_t af[4][PARTS][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair<PARTS>(make_float2(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]), af[ks], r);
    wait_group(NCV);
#pragma unroll
    for (int c = 0; c < NCV; ++c) acc_fence(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int pt = 0; pt < PARTS; ++pt)
          wgmma_64x64_rs_mn(o[c], af[ks][pt], tile(c) + ks * 16 * 64);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt) reg_fence(af[ks][pt]);
#pragma unroll
    for (int c = 0; c < NCV; ++c) acc_fence(o[c]);
    release(NCV);
  }

  // out = o / l in bf16 (column pairs as one 4-byte store where d_v is
  // even), lse = m + log l; rows past t are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w * 16 + g + 8 * h;
    if (row >= t) continue;
    const float ll = fmaxf(l[h], 1e-30f);
    bf16* orow = out + ((size_t)row_base + row) * dv;
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c * 64 + 8 * i + 2 * qd;
        const float a = o[c][4 * i + 2 * h] / ll, b = o[c][4 * i + 2 * h + 1] / ll;
        if (dv % 2 == 0 && col < dv) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(a, b);
        } else {
          if (col < dv) orow[col] = __float2bfloat16(a);
          if (col + 1 < dv) orow[col + 1] = __float2bfloat16(b);
        }
      }
    if (qd == 0) lse[(size_t)row_base + row] = m[h] + logf(ll);
  }
}

template <int NCV>
cudaError_t launch_main(const FwdMaps& maps, const void* lengths, void* out, void* lse, int bh,
                        int heads, int t, int da, int dv, float scale, cudaStream_t st) {
  auto kern = flash_fwd_wgmma_kernel<NCV>;
  static bool attr = false;  // the largest shared memory, set once
  if (!attr) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limits().smem_block);
    if (rc != cudaSuccess) return rc;
    attr = true;
  }
  const dim3 grid(bh, cdiv(t, BT));
  const int nca = cdiv(da, 64), ring = fwd_ring(nca, NCV);
  if (ring == 0) return cudaErrorInvalidValue;
  kern<<<grid, WG + 32, fwd_smem(nca, ring), st>>>(
      maps, static_cast<const int*>(lengths), static_cast<bf16*>(out), static_cast<float*>(lse),
      heads, t, da, dv, ring, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* lengths,
                        void* out, void* lse, void* scratch, int bh, int heads, int t, int da,
                        int dv, float scale, cudaStream_t st) {
  const int rows = bh * t;
  Copies c;
  carve(static_cast<char*>(scratch), rows, da, dv, false, &c);
  FwdMaps maps;
  if (!hopper::tensor_map_2d(&maps.q, c.q, rows, da, c.lda, BT) ||
      !hopper::tensor_map_2d(&maps.k, c.k, rows, da, c.lda, BT) ||
      !hopper::tensor_map_2d(&maps.v, c.v, rows, dv, c.ldv, BT))
    return cudaErrorInvalidValue;
  const cudaError_t rc =
      launch_prep<true>(q, k, v, nullptr, lengths, c, rows, t, heads, da, dv, st);
  if (rc != cudaSuccess) return rc;
  if (dv <= 64) return launch_main<1>(maps, lengths, out, lse, bh, heads, t, da, dv, scale, st);
  return launch_main<2>(maps, lengths, out, lse, bh, heads, t, da, dv, scale, st);
}

}  // namespace

// Bytes of scratch one forward call needs (0: none, the fp32 path).
extern "C" long long avec_flash_attention_fwd_scratch_bytes(int bh, int t, int da, int dv,
                                                            int is_bf16) {
  if (!is_bf16 || bh <= 0 || t <= 0 || da <= 0 || dv <= 0) return 0;
  Copies c;
  return (long long)carve(nullptr, bh * t, da, dv, false, &c);
}

// q, k: (bh, t, da); v, out: (bh, t, dv) of one dtype (fp32 or bf16);
// lengths: (bh / heads,) int32; lse: (bh, t) fp32. bf16 writes its copies
// into `scratch`, a device buffer of avec_flash_attention_fwd_scratch_bytes
// (256-byte aligned), before its main kernel reads them; fp32 needs none.
// d_v <= 96, and in bf16 d_a <= 512. Returns the launches' cudaError_t.
extern "C" int avec_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* lengths, void* out, void* lse, void* scratch,
                                        int bh, int heads, int t, int da, int dv, float scale,
                                        int is_bf16, void* stream) {
  if (bh <= 0 || t <= 0 || da <= 0 || dv <= 0 || dv > 96 || heads <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (scratch == nullptr || da > 512) return cudaErrorInvalidValue;
    return launch_bf16(q, k, v, lengths, out, lse, scratch, bh, heads, t, da, dv, scale, s);
  }
  return dispatch_fp32(q, k, v, lengths, out, lse, bh, heads, t, da, dv, scale, s);
}
