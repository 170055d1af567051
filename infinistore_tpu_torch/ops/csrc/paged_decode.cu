// K1: one-token GQA decode attention read straight off the paged KV cache.
//
// Replaces the TPU kernel paged_decode_attention_pallas
// (infinistore_tpu/ops/pallas_attention.py:406-483, body _decode_kernel
// :68-123).  Computes, for every row b and query head h,
//   out[b, h] = softmax(q[b, h] . K[b, :seq_len]^T / sqrt(D)) V[b, :seq_len]
// where K/V of row b are the pages block_table[b, 0 .. ceil(seq_len/T)-1] of
// one layer's cache [2, H_kv, n_blocks, T, D], and query head h reads KV head
// h / (H / H_kv).
//
// K4: every layer's decode attention in ONE launch.  Replaces
// paged_decode_attention_pallas_alllayers (pallas_attention.py:486-561):
// qs [L, B, H, D], cache [L, 2, H_kv, n_blocks, T, D], one block table and
// one seq_lens for all layers, out [L, B, H, D].  It is an instrument, not a
// model path (bench_gpu.py leg_invocation_overhead): the same bytes and
// arithmetic as L K1 launches in one launch.  K1 is this kernel at L = 1;
// blockIdx.z picks the layer and nothing else depends on it, so K4's output
// equals L K1 launches bit for bit.
//
// Bound on the H100: bytes.  Each decoded token reads every valid K and V
// row of its sequence once (B * H_kv * seq_len * D * 2 elements) and does ~2
// flops per byte, far below the ~295 flop/byte at which the card turns
// compute bound.  The least time is those bytes over 3.35 TB/s, so the
// design aims at bytes in flight and at parallelism, not at FLOPs.
//
// Design:
// - Split page walk (flash-decoding).  The grid is (splits, B * H_kv, L).
//   Split s of row b covers pages [s * split_pages, (s + 1) * split_pages)
//   of the row; the wrapper derives split_pages and the split count from
//   T and the table width alone (never from seq_lens), so a launch needs no
//   host sync and can be captured in a CUDA graph, and the split does not
//   depend on L.  A block whose split starts past the row's last page exits
//   at once.
// - Pages arrive by 1-D bulk copies (cp.async.bulk, one per page piece,
//   issued by warp 0's lanes) into a ring of kStages shared-memory stages of
//   8 KiB of K and 8 KiB of V each (32 tokens in bf16 at D = 128), completion
//   counted on one mbarrier per stage.  K and V stay in their own type in
//   shared memory.  Only the rows below seq_len are copied.
// - The arithmetic is in registers, on the CUDA cores.  A warp owns up to 4
//   query rows of the group (their Q in registers, widened to fp32) and a
//   share of each stage's tokens: a lane holds one 16-byte slice of a K/V
//   row, D/8 (bf16) lanes cover a row, so one warp step scores 1-4 tokens,
//   reduced by warp shuffles.  Softmax statistics (fp32, base 2, through
//   attention_common.cuh's online-softmax helpers as K3/K2) stay per warp
//   for the whole split; the warps of one query-row group are combined once
//   per split, in warp order.  One __syncthreads per stage releases it for
//   the refill.  Tensor cores (mma.sync with the group padded to 16 rows)
//   are not used: ldmatrix over K/V rows 2*D bytes apart conflicts 8 ways
//   unless each row is copied on its own into a padded stride, and copies
//   of single rows were slower than this loop's arithmetic.
// - The splits are merged in the same launch.  A row with one active split
//   writes out directly.  Otherwise each block writes its (m, l, acc[D])
//   partials in fp32 to the workspace, fences, and takes a ticket from the
//   row's counter; the last block to arrive merges all partials in split
//   order (log-sum-exp), writes out and resets the counter to 0.  Every
//   block writes its partial and the merge reads them all back, so the
//   result does not depend on which block came last: two launches on the
//   same inputs are equal bit for bit.
// - A pad row (seq_len <= 0, more pages than the table holds, or any table
//   entry it would read outside [0, n_blocks)) reads no cache page and its
//   split-0 block writes zeros.  Every block of the row checks the row's
//   entries cooperatively (a stride per thread, then __syncthreads_or), so
//   all blocks of a row agree and a pad row takes no ticket.
//
// The counter buffer ([L * B * H_kv] int32, zero between launches) is
// owned by the wrapper per device and stream, and shared by every launch on
// that stream: launches on one stream run one after another, so two never
// take tickets from the same counter at once.  A caller that passes one
// buffer to launches on two streams at once breaks the merge.
//
// Not carried over from the TPU kernel: its sublane padding of the query
// group to 8/16 rows (:426-437) exists for the TPU's (8, 128) tiling; here
// a warp takes 1-4 rows as they are.  Its sequential page grid with the
// running sums in VMEM scratch (and the index clamp, :444-457, that stops
// fetches past the last page) exists because the TPU runs a grid in order
// on one core; here blocks run in parallel on 132 SMs, a loop inside the
// block walks one split, and the last block merges the splits.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using istpu::kNegInf;
namespace sm90 = istpu::sm90;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;         // query heads per KV head
constexpr int kStages = 4;          // ring depth
constexpr int kStageBytes = 8192;   // of K (and again of V) per stage
constexpr int kSmem = kStages * 2 * kStageBytes;
constexpr float kLog2e = 1.4426950408889634f;
// A split's partial in the workspace: acc [R][D], then m [R] and l [R] in
// a tail of kRecStats floats (16-byte aligned records for any R).
constexpr int kRecStats = 2 * kMaxRep;

// RW: query rows per warp; G: row groups (warps with distinct rows).  The
// other kWarps / G warps of a group split each stage's tokens between them.
template <typename T, int D, int RW, int G>
__global__ void __launch_bounds__(kThreads, 3) paged_decode_kernel(
    const T* __restrict__ q,        // [L, B, H, D], RoPE applied
    const T* __restrict__ cache,    // [L, 2, H_kv, n_blocks, Tp, D]
    const int* __restrict__ table,  // [B, max_pages]
    const int* __restrict__ lens,   // [B], valid tokens incl. the current one
    T* __restrict__ out,            // [L, B, H, D]
    float* __restrict__ ws,         // [L, B, H_kv, splits, R * D + 32]
    int* __restrict__ counters,     // [L, B, H_kv], zero between launches
    int B, int H, int Hkv, int n_blocks, int Tp, int max_pages,
    int split_pages, float scale, size_t q_layer, size_t cache_layer) {
  constexpr int TG = kWarps / G;               // warps per row group
  constexpr int kVec = istpu::Vec16<T>::kN;    // elements per lane slice
  constexpr int LR = D / kVec;                 // lanes per K/V row
  constexpr int TW = 32 / LR;                  // tokens per warp step
  constexpr int ST = kStageBytes / (D * (int)sizeof(T));  // tokens per stage
  constexpr int STW = ST / TG;                 // a warp's tokens per stage
  constexpr int CH = 4 * TW;                   // tokens per softmax update
  static_assert(LR <= 32 && STW % CH == 0, "stage layout");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ int last_block;

  const int split = blockIdx.x;
  const int hk = blockIdx.y % Hkv;
  const int b = blockIdx.y / Hkv;
  const int layer = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = H / Hkv;

  const int seq_len = lens[b];
  const int n_pages = seq_len > 0 ? (seq_len + Tp - 1) / Tp : 0;
  const int* row_table = table + (size_t)b * max_pages;
  const int page0 = split * split_pages;
  bool pad = seq_len <= 0 || n_pages > max_pages;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(bars));
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(bar0 + 8 * s, 1);
    sm90::fence_barrier_init();
  }
  if (!pad) {
    if (page0 >= n_pages) return;  // a split past the row's last page
    int bad = 0;
    for (int p = tid; p < n_pages; p += kThreads) {
      const int blk = row_table[p];
      bad |= blk < 0 || blk >= n_blocks;
    }
    pad = __syncthreads_or(bad);  // also publishes the barriers' init
  }
  T* o = out + blockIdx.z * q_layer + ((size_t)b * H + (size_t)hk * R) * D;
  if (pad) {
    if (split == 0) {
      for (int i = tid; i < R * D; i += kThreads) {
        o[i] = istpu::from_float<T>(0.f);
      }
    }
    return;
  }

  const int n_active = (n_pages + split_pages - 1) / split_pages;
  const int tok0 = page0 * Tp;
  const int tok1 = min(seq_len, (page0 + split_pages) * Tp);
  const int n_st = (tok1 - tok0 + ST - 1) / ST;

  const size_t page_elems = (size_t)Tp * D;
  const T* k_base =
      cache + layer * cache_layer + (size_t)hk * n_blocks * page_elems;
  const T* v_base = cache + layer * cache_layer +
                    ((size_t)Hkv + hk) * n_blocks * page_elems;

  // Warp 0: stage i's K and V rows [t0, t1) of the row, one bulk copy per
  // page piece, a lane per piece.
  auto issue = [&](int i) {
    const int t0 = tok0 + i * ST;
    const int t1 = min(t0 + ST, tok1);
    const int slot = i % kStages;
    const uint32_t bar = bar0 + 8 * slot;
    const uint32_t kdst = ring + slot * 2 * kStageBytes;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(
          bar, (uint32_t)(2 * (t1 - t0) * D * sizeof(T)));
    }
    __syncwarp();
    const int p0 = t0 / Tp;
    const int n_piece = (t1 - 1) / Tp - p0 + 1;
    for (int j = lane; j < n_piece; j += 32) {
      const int p = p0 + j;
      const int a = max(t0, p * Tp);
      const int e = min(t1, (p + 1) * Tp);
      const size_t off = (size_t)row_table[p] * page_elems +
                         (size_t)(a - p * Tp) * D;
      const uint32_t bytes = (uint32_t)((e - a) * D * sizeof(T));
      const uint32_t dst = kdst + (uint32_t)((a - t0) * D * sizeof(T));
      sm90::bulk_load_1d(dst, k_base + off, bytes, bar);
      sm90::bulk_load_1d(dst + kStageBytes, v_base + off, bytes, bar);
    }
  };
  if (warp == 0) {
    for (int i = 0; i < min(kStages, n_st); ++i) issue(i);
  }

  const int g = warp / TG;   // row group
  const int tg = warp % TG;  // token share within the group
  const int slot = lane / LR;
  const int col = (lane % LR) * kVec;
  const float c = scale * kLog2e;

  float qf[RW][kVec];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = g * RW + i;
    if (r < R) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + blockIdx.z * q_layer + ((size_t)b * H + (size_t)hk * R + r) * D +
          col);
      istpu::unpack16(u, qf[i], T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) qf[i][e] = 0.f;
    }
  }
  float m[RW], l[RW], acc[RW][kVec];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.f;
  }

  for (int it = 0; it < n_st; ++it) {
    const int stage = it % kStages;
    sm90::mbar_wait(bar0 + 8 * stage, (it / kStages) & 1);
    const int n_valid = min(ST, tok1 - tok0 - it * ST);
    const T* ks = reinterpret_cast<const T*>(smem + stage * 2 * kStageBytes);
    const T* vs = ks + ST * D;
#pragma unroll
    for (int ch = 0; ch < STW / CH; ++ch) {
      const int base = tg * STW + ch * CH;
      if (base >= n_valid) break;
      float s[4][RW];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = base + j * TW + slot;
        float kf[kVec];
        istpu::unpack16(*reinterpret_cast<const uint4*>(ks + t * D + col), kf,
                        T());
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int e = 0; e < kVec; e += 2) {
            a0 = fmaf(qf[i][e], kf[e], a0);
            a1 = fmaf(qf[i][e + 1], kf[e + 1], a1);
          }
          float dot = a0 + a1;
#pragma unroll
          for (int off = LR / 2; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          s[j][i] = t < n_valid ? dot : -INFINITY;
        }
      }
      float mc[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float mx = fmaxf(fmaxf(s[0][i], s[1][i]), fmaxf(s[2][i], s[3][i]));
#pragma unroll
        for (int off = LR; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float corr = istpu::online_softmax_rescale_log2(m[i], mx, c);
        if (corr != 1.f) {  // warp-uniform
          l[i] *= corr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[i][e] *= corr;
        }
        mc[i] = m[i] * c;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = base + j * TW + slot;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);  // rows past n_valid: stale
        if (t < n_valid) u = *reinterpret_cast<const uint4*>(vs + t * D + col);
        float vf[kVec];
        istpu::unpack16(u, vf, T());
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float p = istpu::online_softmax_prob_log2(s[j][i], mc[i], c);
          l[i] += p;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
        }
      }
    }
    if (it + kStages < n_st) {
      __syncthreads();  // every warp is done with this stage
      if (warp == 0) issue(it + kStages);
    }
  }

  // the warp's token slots share m: sum their l and acc
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int off = LR; off < 32; off <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      }
    }
  }
  // the TG warps of a row group, in order, into the group's first warp
  if constexpr (TG > 1) {
    __syncthreads();  // the ring is consumed: reuse it
    float* red = reinterpret_cast<float*>(smem);  // [kWarps][RW][D]
    float* red_ml = red + kWarps * RW * D;        // [kWarps][RW][2]
    if (tg > 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        if (slot == 0) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            red[(warp * RW + i) * D + col + e] = acc[i][e];
          }
        }
        if (lane == 0) {
          red_ml[(warp * RW + i) * 2] = m[i];
          red_ml[(warp * RW + i) * 2 + 1] = l[i];
        }
      }
    }
    __syncthreads();
    if (tg == 0) {
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float mx = m[i];
        for (int w = warp + 1; w < warp + TG; ++w) {
          mx = fmaxf(mx, red_ml[(w * RW + i) * 2]);
        }
        const float corr = exp2f((m[i] - mx) * c);
        l[i] *= corr;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][e] *= corr;
        for (int w = warp + 1; w < warp + TG; ++w) {
          const float wt = exp2f((red_ml[(w * RW + i) * 2] - mx) * c);
          l[i] = fmaf(wt, red_ml[(w * RW + i) * 2 + 1], l[i]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[i][e] = fmaf(wt, red[(w * RW + i) * D + col + e], acc[i][e]);
          }
        }
        m[i] = mx;
      }
    }
  }

  const size_t rec = (size_t)R * D + kRecStats;
  const size_t row_id = ((size_t)layer * B + b) * Hkv + hk;
  float* ws_row = ws + row_id * gridDim.x * rec;
  if (tg == 0 && slot == 0) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = g * RW + i;
      if (r >= R) continue;
      if (n_active == 1) {
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
        float y[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) y[e] = acc[i][e] * inv;
        *reinterpret_cast<uint4*>(o + r * D + col) = istpu::pack16(y, T());
      } else {
        float* part = ws_row + split * rec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          *reinterpret_cast<float4*>(part + r * D + col + e) = make_float4(
              acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
        }
        if (col == 0) {
          part[R * D + r] = m[i];
          part[R * D + R + r] = l[i];
        }
      }
    }
  }
  if (n_active == 1) return;

  // the last of the row's active splits merges them, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(counters + row_id, 1) == n_active - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // every split's m and l at once (one L2 round trip), then per row the
  // weights exp2((m_s - max) * c) and 1 / sum(w_s * l_s) in split order
  float* w_s = reinterpret_cast<float*>(smem);  // [n_active][R]
  float* l_s = w_s + n_active * R;               // [n_active][R]
  float* inv_s = l_s + n_active * R;             // [R]
  for (int i = tid; i < n_active * R; i += kThreads) {
    const float* stats = ws_row + (i / R) * rec + R * D + i % R;
    w_s[i] = __ldcg(stats);
    l_s[i] = __ldcg(stats + R);
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    float mx = kNegInf;
    for (int s = 0; s < n_active; ++s) mx = fmaxf(mx, w_s[s * R + r]);
    float den = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float wt = exp2f((w_s[s * R + r] - mx) * c);
      w_s[s * R + r] = wt;
      den = fmaf(wt, l_s[s * R + r], den);
    }
    inv_s[r] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  // out = sum_s w_s * acc_s / den, four columns a thread, the splits'
  // loads unrolled so several are in flight
  for (int i4 = tid; i4 < R * D / 4; i4 += kThreads) {
    const int r = i4 * 4 / D;
    float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < n_active; ++s) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(ws_row + s * rec) + i4);
      const float wt = w_s[s * R + r];
      y[0] = fmaf(wt, a.x, y[0]);
      y[1] = fmaf(wt, a.y, y[1]);
      y[2] = fmaf(wt, a.z, y[2]);
      y[3] = fmaf(wt, a.w, y[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[i4 * 4 + e] = istpu::from_float<T>(y[e] * inv_s[r]);
    }
  }
  if (tid == 0) counters[row_id] = 0;
}

template <typename T, int D, int RW, int G>
cudaError_t launch(const void* q, const void* cache, const int* table,
                   const int* lens, void* out, float* ws, int* counters,
                   int L, int B, int H, int Hkv, int n_blocks, int Tp,
                   int max_pages, int split_pages, int n_splits, float scale,
                   cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D, RW, G>;
  // raised once per instantiation (the ring's size is fixed), so no launch,
  // one captured in a CUDA graph included, calls the runtime for more than
  // the launch itself
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const size_t q_layer = (size_t)B * H * D;
  const size_t cache_layer = (size_t)2 * Hkv * n_blocks * Tp * D;
  kernel<<<dim3(n_splits, B * Hkv, L), kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), table, lens,
      static_cast<T*>(out), ws, counters, B, H, Hkv, n_blocks, Tp, max_pages,
      split_pages, scale, q_layer, cache_layer);
  return cudaGetLastError();
}

// Rows per warp and row groups for a query group of R rows.
template <typename T, int D>
cudaError_t launch_rep(int R, const void* q, const void* cache,
                       const int* table, const int* lens, void* out, float* ws,
                       int* counters, int L, int B, int H, int Hkv,
                       int n_blocks, int Tp, int max_pages, int split_pages,
                       int n_splits, float scale, cudaStream_t s) {
#define ISTPU_LAUNCH(RW, G)                                                   \
  return launch<T, D, RW, G>(q, cache, table, lens, out, ws, counters, L, B, \
                             H, Hkv, n_blocks, Tp, max_pages, split_pages,   \
                             n_splits, scale, s)
  if (R <= 1) ISTPU_LAUNCH(1, 1);
  if (R <= 2) ISTPU_LAUNCH(2, 1);
  if (R <= 4) ISTPU_LAUNCH(4, 1);
  if (R <= 8) ISTPU_LAUNCH(4, 2);
  ISTPU_LAUNCH(4, 4);
#undef ISTPU_LAUNCH
}

}  // namespace

// Launches the kernel on ``stream`` over ``L`` layers: K1 is L = 1 (q/out
// [B, H, D], cache [2, H_kv, n_blocks, Tp, D]), K4 any L (q/out [L, B, H, D],
// cache [L, 2, H_kv, n_blocks, Tp, D], one table and one lens for every
// layer).  Each row's pages are walked in ``n_splits`` splits of
// ``split_pages`` pages (n_splits * split_pages >= max_pages).  ``ws``: fp32
// workspace of L * B * H_kv * n_splits * ((H / H_kv) * D + 32) floats (unused,
// may be null, when n_splits == 1); ``counters``: L * B * H_kv int32, zero
// before the launch and zero after it, used by no launch on another stream
// meanwhile.  The caller checks shapes, types,
// contiguity and 16-byte alignment; this returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a head size, type or split it was
// not built for).
extern "C" int istpu_paged_decode(const void* q, const void* cache,
                                  const int* table, const int* lens, void* out,
                                  void* ws, void* counters, int L, int B,
                                  int H, int Hkv, int n_blocks, int Tp, int D,
                                  int max_pages, int split_pages, int n_splits,
                                  float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Hkv != 0 || H / Hkv > kMaxRep || Tp < 1 || L < 1 || L > 65535 ||
      B * Hkv > 65535 || split_pages < 1 || n_splits < 1 ||
      (long long)n_splits * split_pages < max_pages ||
      (n_splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const int R = H / Hkv;
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == istpu::kBF16) {
    if (D == 32)
      return launch_rep<__nv_bfloat16, 32>(R, q, cache, table, lens, out, w,
                                           cnt, L, B, H, Hkv, n_blocks, Tp,
                                           max_pages, split_pages, n_splits,
                                           scale, s);
    if (D == 64)
      return launch_rep<__nv_bfloat16, 64>(R, q, cache, table, lens, out, w,
                                           cnt, L, B, H, Hkv, n_blocks, Tp,
                                           max_pages, split_pages, n_splits,
                                           scale, s);
    if (D == 128)
      return launch_rep<__nv_bfloat16, 128>(R, q, cache, table, lens, out, w,
                                            cnt, L, B, H, Hkv, n_blocks, Tp,
                                            max_pages, split_pages, n_splits,
                                            scale, s);
  } else if (dtype == istpu::kF32) {
    if (D == 32)
      return launch_rep<float, 32>(R, q, cache, table, lens, out, w, cnt, L,
                                   B, H, Hkv, n_blocks, Tp, max_pages,
                                   split_pages, n_splits, scale, s);
    if (D == 64)
      return launch_rep<float, 64>(R, q, cache, table, lens, out, w, cnt, L,
                                   B, H, Hkv, n_blocks, Tp, max_pages,
                                   split_pages, n_splits, scale, s);
    if (D == 128)
      return launch_rep<float, 128>(R, q, cache, table, lens, out, w, cnt, L,
                                    B, H, Hkv, n_blocks, Tp, max_pages,
                                    split_pages, n_splits, scale, s);
  }
  return cudaErrorInvalidValue;
}
