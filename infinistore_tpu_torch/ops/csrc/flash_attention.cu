// K3 (causal flash prefill) and K2 (flash prefill over a bucketed prefix):
// one tile loop, two masks.
//
// K3 replaces flash_causal_attention_pallas
// (infinistore_tpu/ops/pallas_attention.py:330-402, body _flash_kernel
// :126-173): q [B, Sq, H, D], k/v [B, Sk, H_kv, D]; query row i sits at key
// position q_offset + i and sees keys 0 .. q_offset + i.
//
// K2 replaces flash_prefix_attention_pallas (:243-327, body
// _flash_prefix_kernel :176-240): k/v are [bucketed prefix | self] with
// Sk = prefix_pad + Sq; rows [0, prefix_len) are the valid prefix (seen in
// full), rows [prefix_len, prefix_pad) are bucket slack (masked), and self
// row prefix_pad + j is seen by query i iff j <= i.  prefix_len is a plain
// int: the engine holds it on the host.  prefix_pad need not be a multiple
// of a tile, so one tile may hold prefix, slack and self rows at once.
//
// Both return softmax(q k^T / sqrt(D)) v over the visible keys, [B, Sq, H, D],
// GQA query head h reading KV head h / (H / H_kv).  Queries and keys keep the
// [B, S, H, D] layout in device memory: nothing is transposed or padded.
//
// Bound on the H100 at the chip smoke's shapes (H=32, H_kv=8, D=128, bf16):
// operations.  K3 at Sq = Sk = 2048 does ~4 * Sq * Sk/2 * D * H = 34 GFLOP
// on 48 MiB of q/k/v/out; K2 at Sq=512 over a 1024-row bucket holding 700
// valid rows does ~6 GFLOP on 18 MiB.  Both are far above the card's
// ~295 flop/byte, so the least time is the flops over the bf16 tensor-core
// peak (989 TFLOP/s), which only wgmma reaches.
//
// bf16 (the model path): tensor cores.  One block per (128 query rows, query
// head, batch row): two warpgroups of 64 query rows each, 256 threads.
// Thread 0 loads Q once and then the K/V tiles of 128 rows through TMA (4-D
// tensor maps over [B, S, H, D], 128-byte swizzle, rows past S land as
// zeros) into a ring of two stages, each reported on a "full" mbarrier and
// released by all 256 threads on an "empty" one, so tile j+1 loads while
// tile j runs its two products; thread 0 refills a stage as soon as both
// warpgroups have released it.  Per tile a warpgroup computes S = Q K^T
// with wgmma from shared memory (both K-major: rows are contiguous in D),
// folds S into the fp32 online softmax in the accumulator's own layout (row
// max and sum over the 4 threads of a row by quad shuffles, exp2 with
// scale * log2(e) folded into one FMA), rounds P to bf16 as the plain
// version does (probs.to(v.dtype)) and, since a bf16 accumulator fragment
// is laid out as the A operand of the next wgmma, runs O += P V with P
// straight from registers and V from shared memory (V is MN-major for this
// product: the descriptor's transpose bit).  The two warpgroups interleave
// on the SM, one's softmax under the other's products.  Masks cost only the
// tiles that cross the causal diagonal, the prefix boundary, the bucket
// slack or the end of K; no block loads a tile above its causal frontier or
// a tile of slack alone, and the query tiles with the most work are
// scheduled first.
//
// The FMA kernel: f32 at every head size (the f32 tests and tolerances,
// atol = rtol = 1e-4, which TF32 tensor cores, ~3 decimal digits, would
// not meet), and bf16 at D = 32 (the TINY test model), whose 64-byte rows
// are half of the 128-byte swizzled row the wgmma path is laid out for.
// One block per (64-row query tile, query head, batch row), 256 threads
// each owning a 4 x 4 patch of the 64 x 64 score tile; scores and P.V are
// fp32 FMAs from padded fp32 shared memory, folded through the shared
// online softmax; in bf16, P is rounded to bf16 before P.V as the plain
// version and the wgmma path round it.
#include <cuda.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using istpu::kNegInf;

// Whether chunk-local query row ``qi`` sees key row ``kp``: the one
// definition of visibility for both paths (prefix_pad < 0 selects K3).
__device__ __forceinline__ bool key_visible(int kp, int qi, int Sk,
                                            int q_offset, int prefix_pad,
                                            int prefix_len) {
  if (kp >= Sk) return false;
  if (prefix_pad < 0) return kp <= q_offset + qi;          // K3
  return kp < prefix_pad ? kp < prefix_len : kp - prefix_pad <= qi;  // K2
}

// ======================= bf16: wgmma + TMA ring =======================

namespace tc {

namespace sm90 = istpu::sm90;

constexpr int kBQ = 128;           // query rows per block
constexpr int kBK = 128;           // key rows per K/V tile
constexpr int kStages = 2;         // K/V tiles in flight
// Two warpgroups of 64 query rows.  Their thread 0 also issues the loads:
// with no producer warpgroup, ptxas may give each thread up to 255
// registers, enough for the S and O fragments (64 fp32 each) and P without
// serialising the wgmma, which it does within the 168 a 384-thread block
// leaves (setmaxnreg did not lift that limit in ptxas 12.9).
constexpr int kThreads = 256;
constexpr int kSwzCols = 64;       // bf16 columns in a 128-byte row
constexpr uint32_t kSwzRow = 128;  // bytes of one swizzled row

// Shared memory, from a 1024-aligned base: Q as D/64 column blocks of
// [kBQ][64], then per stage K and V as D/64 blocks of [kBK][64] each (the
// layout TMA writes for a 64-column box), then the mbarriers.
template <int D>
struct Smem {
  static constexpr int kBlocks = D / kSwzCols;
  static constexpr uint32_t kQ = kBQ * D * 2;
  static constexpr uint32_t kTile = kBK * D * 2;  // one K or one V tile
  static constexpr uint32_t kBars = kQ + kStages * 2 * kTile;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

struct Args {
  __nv_bfloat16* out;  // [B, Sq, H, D]
  int Sq, Sk, H, Hkv, q_offset, prefix_pad, prefix_len;
  float c;             // scale * log2(e)
};

// The last key row query row ``q`` may see.
template <bool kPrefix>
__device__ __forceinline__ int frontier(const Args& a, int q) {
  return kPrefix ? a.prefix_pad + q : a.q_offset + q;
}

// K2: a tile holding neither a valid prefix row nor a self row is bucket
// slack, never loaded.  The loader and both warpgroups skip the same tiles.
template <bool kPrefix>
__device__ __forceinline__ bool slack_tile(const Args& a, int k0) {
  return kPrefix && k0 >= a.prefix_len && k0 + kBK <= a.prefix_pad;
}

// Whether every key of the tile at ``k0`` is visible to every query row
// from ``q_first`` on (visibility only grows with the row).
template <bool kPrefix>
__device__ __forceinline__ bool tile_unmasked(const Args& a, int k0,
                                              int q_first) {
  const int k_last = k0 + kBK - 1;
  if (k_last >= a.Sk) return false;
  if (!kPrefix) return k_last <= a.q_offset + q_first;
  if (k_last < a.prefix_pad) return k_last < a.prefix_len;
  return k0 >= a.prefix_pad && k_last - a.prefix_pad <= q_first;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[4], uint64_t v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&p)[4],
                                             uint64_t v) {
  sm90::wgmma_rs_m64n64k16(o, p, v);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&p)[4],
                                              uint64_t v) {
  sm90::wgmma_rs_m64n128k16(o, p, v);
}

// A block's shared memory and coordinates.
template <int D>
struct Block {
  uint32_t q_s;   // Q, 1024-aligned; the K/V stages follow it
  uint32_t bars;  // mbarriers: q_full, full[kStages], empty[kStages]
  int h, b, q0, hk, n_kt;

  __device__ uint32_t k_s(int s) const {
    return q_s + Smem<D>::kQ + 2 * Smem<D>::kTile * s;
  }
  __device__ uint32_t v_s(int s) const { return k_s(s) + Smem<D>::kTile; }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return bars + 8u * (1 + kStages + s);
  }
};

// Thread 0's loads: Q once, then the block's K/V tiles in order into the
// ring, a stage refilled once all 256 threads have released it.
template <int D, bool kPrefix>
struct Loader {
  const Block<D>& blk;
  const Args& a;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int kt = 0;  // next tile of the block to load
  int n = 0;   // tiles loaded so far

  __device__ void load_q(const CUtensorMap* tq) const {
    sm90::mbar_arrive_expect_tx(blk.q_full(), Smem<D>::kQ);
    for (int c = 0; c < Smem<D>::kBlocks; ++c)
      sm90::tma_load_4d(blk.q_s + c * kBQ * kSwzRow, tq, blk.q_full(),
                        c * kSwzCols, blk.h, blk.q0, blk.b);
  }

  __device__ void load_next() {
    while (kt < blk.n_kt && slack_tile<kPrefix>(a, kt * kBK)) ++kt;
    if (kt >= blk.n_kt) return;
    const int s = n % kStages;
    if (n >= kStages) sm90::mbar_wait(blk.empty(s), (n / kStages - 1) & 1);
    sm90::mbar_arrive_expect_tx(blk.full(s), 2 * Smem<D>::kTile);
    for (int c = 0; c < Smem<D>::kBlocks; ++c) {
      const uint32_t off = c * kBK * kSwzRow;
      sm90::tma_load_4d(blk.k_s(s) + off, tk, blk.full(s), c * kSwzCols,
                        blk.hk, kt * kBK, blk.b);
      sm90::tma_load_4d(blk.v_s(s) + off, tv, blk.full(s), c * kSwzCols,
                        blk.hk, kt * kBK, blk.b);
    }
    ++kt;
    ++n;
  }
};

template <int D, bool kPrefix>
__device__ __forceinline__ void flash(const CUtensorMap* tq,
                                      const CUtensorMap* tk,
                                      const CUtensorMap* tv, const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  Block<D> blk;
  blk.q_s = (raw + 1023u) & ~1023u;
  blk.bars = blk.q_s + Smem<D>::kBars;
  blk.h = blockIdx.x;
  blk.b = blockIdx.y;
  blk.q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // most work first
  blk.hk = blk.h / (a.H / a.Hkv);
  blk.n_kt = min((a.Sk + kBK - 1) / kBK,
                 frontier<kPrefix>(a, min(blk.q0 + kBQ, a.Sq) - 1) / kBK + 1);
  Loader<D, kPrefix> loader{blk, a, tk, tv};

  if (threadIdx.x == 0) {
    sm90::mbar_init(blk.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(blk.full(s), 1);
      sm90::mbar_init(blk.empty(s), kThreads);
    }
    sm90::fence_barrier_init();
    loader.load_q(tq);
    for (int s = 0; s < kStages; ++s) loader.load_next();
  }
  __syncthreads();

  // warpgroup wg owns query rows q0 + 64 wg .. + 63; in the accumulator
  // layout thread (warp, lane) holds rows r0 and r0 + 8 and, of every 8
  // columns, columns c0 and c0 + 1
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_first = blk.q0 + 64 * wg;
  const int wg_front = wg_first < a.Sq
      ? frontier<kPrefix>(a, min(wg_first + 63, a.Sq - 1)) : -1;
  const int r0 = wg_first + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_wg = blk.q_s + 64 * wg * kSwzRow;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of each row's sum

  sm90::mbar_wait(blk.q_full(), 0);
  int it = 0;
  for (int kt = 0; kt < blk.n_kt; ++kt) {
    const int k0 = kt * kBK;
    if (slack_tile<kPrefix>(a, k0)) continue;
    const int s = it % kStages;
    sm90::mbar_wait(blk.full(s), (it / kStages) & 1);
    ++it;
    if (k0 <= wg_front) {  // else no row of this warpgroup sees the tile
      // S = Q K^T: D/16 steps of 16 columns; a step inside a 128-byte
      // swizzled row advances the descriptor by 32 bytes
      float sc[kBK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        sm90::wgmma_ss_m64n128k16(
            sc,
            sm90::desc_sw128(q_wg + (kk / 4) * kBQ * kSwzRow + col, 16, 1024),
            sm90::desc_sw128(blk.k_s(s) + (kk / 4) * kBK * kSwzRow + col, 16,
                             1024),
            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      if (!tile_unmasked<kPrefix>(a, k0, wg_first)) {
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = r0 + 8 * (e / 2);
            const int kp = k0 + 8 * n + c0 + (e % 2);
            if (!key_visible(kp, qi, a.Sk, a.q_offset,
                             kPrefix ? a.prefix_pad : -1, a.prefix_len))
              sc[4 * n + e] = -INFINITY;
          }
      }

      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[i] = istpu::online_softmax_rescale_log2(m[i], mx, a.c);
        const float mc = m[i] * a.c;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = sc[4 * n + 2 * i + j];
            x = istpu::online_softmax_prob_log2(x, mc, a.c);
            sum += x;
          }
        l[i] = l[i] * corr[i] + sum;
      }

      // P in bf16 as the A fragments of O += P V, 16 keys per step
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) sm90::fence_regs(p[kk]);
      sm90::wgmma_fence();
      // V is MN-major here: 16 keys per step are 16 swizzled rows (2 KiB);
      // the D/64 column blocks sit kBK rows apart (leading byte offset), 8
      // rows of a block 1024 bytes apart (stride byte offset)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(o, p[kk],
                    sm90::desc_sw128(blk.v_s(s) + kk * 16 * kSwzRow,
                                     kBK * kSwzRow, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    sm90::mbar_arrive(blk.empty(s));
    // refill the stage once the other warpgroup has released it too
    if (threadIdx.x == 0) loader.load_next();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    if (qi >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* dst =
        a.out + (((size_t)blk.b * a.Sq + qi) * a.H + blk.h) * D + c0;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
  }
}

}  // namespace tc

// Two entry points, so a profile tells K3 from K2 by name.
template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1) flash_causal_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const tc::Args a) {
  tc::flash<D, false>(&tq, &tk, &tv, a);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1) flash_prefix_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const tc::Args a) {
  tc::flash<D, true>(&tq, &tk, &tv, a);
}

// cuTensorMapEncodeTiled, found through the runtime so the library needs no
// -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, heads, D] tensor as the 4-D map (D, heads, S, B) whose box
// is 64 columns (one 128-byte swizzled row) of ``rows`` rows of one head.
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                 int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)tc::kSwzCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kPrefix>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int Hkv,
                        int q_offset, int prefix_pad, int prefix_len,
                        float scale, cudaStream_t stream) {
  if (Sk == 0)  // no key at all: every row is zero, as the f32 path gives
    return cudaMemsetAsync(out, 0, (size_t)B * Sq * H * D * 2, stream);
  const auto kernel = kPrefix ? &flash_prefix_bf16_kernel<D>
                              : &flash_causal_bf16_kernel<D>;
  constexpr size_t smem = tc::Smem<D>::kBytes;
  static bool smem_raised = false;  // once per instantiation
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, B, Sq, H, D, tc::kBQ) ||
      !encode_bshd(&tk, k, B, Sk, Hkv, D, tc::kBK) ||
      !encode_bshd(&tv, v, B, Sk, Hkv, D, tc::kBK))
    return cudaErrorInvalidValue;
  const tc::Args a{static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv,
                   q_offset, prefix_pad, prefix_len,
                   scale * 1.4426950408889634f};
  const dim3 grid(H, B, (Sq + tc::kBQ - 1) / tc::kBQ);
  kernel<<<grid, tc::kThreads, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// ================ FMA: f32, and bf16 at D = 32 ================

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kPS = kBK + 1;     // padded row stride of the probability tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fma_kernel(
    const T* __restrict__ q,  // [B, Sq, H, D]
    const T* __restrict__ k,  // [B, Sk, H_kv, D]
    const T* __restrict__ v,  // [B, Sk, H_kv, D]
    T* __restrict__ out,      // [B, Sq, H, D]
    int Sq, int Sk, int H, int Hkv, int q_offset, int prefix_pad,
    int prefix_len, float scale) {
  constexpr int kVec = istpu::Vec16<T>::kN;
  constexpr int kKS = D + 1;        // padded row stride of q_s / k_s
  constexpr int kDC = D / 16;       // output columns per thread
  constexpr int kRowVecs = D / kVec;
  extern __shared__ float smem[];
  float* q_s = smem;                // [kBQ][kKS], pre-scaled
  float* k_s = q_s + kBQ * kKS;     // [kBK][kKS]
  float* v_s = k_s + kBK * kKS;     // [kBK][D]
  float* p_s = v_s + kBK * D;       // [kBQ][kPS]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // owns query rows ty*kRows .. +kRows-1
  const int tx = tid & 15;  // owns columns tx, tx+16, ...
  const int q0 = qt * kBQ;

  for (int idx = tid; idx < kBQ * kRowVecs; idx += kThreads) {
    const int row = idx / kRowVecs;
    const int col = (idx - row * kRowVecs) * kVec;
    float tmp[kVec];
    if (q0 + row < Sq) {
      const T* src = q + (((size_t)b * Sq + q0 + row) * H + h) * D + col;
      istpu::unpack16(*reinterpret_cast<const uint4*>(src), tmp, T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[row * kKS + col + e] = tmp[e] * scale;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // causal frontier: the last key row any query row of this tile can see
  const int q_last = q0 + kBQ - 1;
  const int frontier = prefix_pad < 0 ? q_offset + q_last : prefix_pad + q_last;
  const int n_kt = min((Sk + kBK - 1) / kBK, frontier / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // K2: a tile holding neither a valid prefix row nor a self row is
    // bucket slack, never loaded
    if (prefix_pad >= 0 && k0 >= prefix_len && k0 + kBK <= prefix_pad) continue;

    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int idx = tid; idx < kBK * kRowVecs; idx += kThreads) {
      const int row = idx / kRowVecs;
      const int col = (idx - row * kRowVecs) * kVec;
      float tk[kVec], tv[kVec];
      if (k0 + row < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + row) * Hkv + hk) * D + col;
        istpu::unpack16(*reinterpret_cast<const uint4*>(k + off), tk, T());
        istpu::unpack16(*reinterpret_cast<const uint4*>(v + off), tv, T());
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[row * kKS + col + e] = tk[e];
        v_s[row * D + col + e] = tv[e];
      }
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * kKS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + 16 * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (!key_visible(k0 + tx + 16 * j, q0 + row, Sk, q_offset, prefix_pad,
                         prefix_len)) {
          s[i][j] = -INFINITY;
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 16 threads sharing a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      }
      const float corr = istpu::online_softmax_rescale(m[i], tile_max);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pr = istpu::online_softmax_prob(s[i][j], m[i]);
        psum += pr;
        // P.V in the input type's P, as the plain version rounds it
        p_s[row * kPS + tx + 16 * j] =
            static_cast<float>(istpu::from_float<T>(pr));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      l[i] = l[i] * corr + psum;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kPS + c];
#pragma unroll
      for (int cc = 0; cc < kDC; ++cc) {
        const float vv = v_s[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][cc] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      dst[tx + 16 * c] = istpu::from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                       int prefix_pad, int prefix_len, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS) *
      sizeof(float);
  auto kernel = flash_fma_kernel<T, D>;
  static bool smem_raised = false;  // once per instantiation
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv,
      q_offset, prefix_pad, prefix_len, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                   int prefix_pad, int prefix_len, float scale, int dtype,
                   cudaStream_t s) {
  if (dtype == istpu::kF32)
    return launch_fma<float, D>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset,
                                prefix_pad, prefix_len, scale, s);
  if (dtype != istpu::kBF16) return cudaErrorInvalidValue;
  if constexpr (D % tc::kSwzCols != 0)  // rows narrower than a swizzled row
    return launch_fma<__nv_bfloat16, D>(q, k, v, out, B, Sq, Sk, H, Hkv,
                                        q_offset, prefix_pad, prefix_len,
                                        scale, s);
  else if (prefix_pad < 0)
    return launch_bf16<D, false>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset,
                                 prefix_pad, prefix_len, scale, s);
  else
    return launch_bf16<D, true>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset,
                                prefix_pad, prefix_len, scale, s);
}

}  // namespace

// Launches K3 (prefix_pad < 0) or K2 (prefix_pad >= 0) on ``stream``: bf16
// on the tensor cores at D = 64 and 128, f32 and bf16 at D = 32 on the FMA
// path.  The caller checks shapes,
// types, contiguity and 16-byte alignment; this returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a head size or type it was
// not built for, or a tensor TMA cannot map).
extern "C" int istpu_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int Hkv, int D,
                                     int q_offset, int prefix_pad,
                                     int prefix_len, float scale, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0) return cudaErrorInvalidValue;
  if (D == 32)
    return launch<32>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, prefix_pad,
                      prefix_len, scale, dtype, s);
  if (D == 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, prefix_pad,
                      prefix_len, scale, dtype, s);
  if (D == 128)
    return launch<128>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, prefix_pad,
                       prefix_len, scale, dtype, s);
  return cudaErrorInvalidValue;
}
