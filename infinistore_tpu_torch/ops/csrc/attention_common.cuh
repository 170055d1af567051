// Shared device helpers of the attention kernels (paged_decode.cu,
// flash_attention.cu): element conversion, 16-byte tile loads, and the one
// fp32 online-softmax update every kernel folds its score tiles through (in
// base e, or base 2 for the tensor-core kernel), so the kernels' numerics
// cannot drift apart (the TPU kernels share
// _online_softmax_step in infinistore_tpu/ops/pallas_attention.py:52-65 for
// the same reason).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace istpu {

// Finite start value of the running max, as in the TPU kernels (-1e30): a
// row that has seen no visible key keeps a finite max, so the rescale factor
// exp(m_old - m_new) is exp(0) = 1 and never exp(-inf + inf) = NaN.  Masked
// scores themselves are -INFINITY and contribute exp(-inf) = 0.
constexpr float kNegInf = -1e30f;

// Element types the kernels take; the C entry points name them by code.
enum DType : int { kBF16 = 0, kF32 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / sizeof(T);
};

// Widen one 16-byte vector of T into kN floats.
__device__ __forceinline__ void unpack16(const uint4& u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float* dst,
                                         __nv_bfloat16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Narrow kN floats into one 16-byte vector of T (round to nearest even).
__device__ __forceinline__ uint4 pack16(const float* src, float) {
  return make_uint4(__float_as_uint(src[0]), __float_as_uint(src[1]),
                    __float_as_uint(src[2]), __float_as_uint(src[3]));
}
__device__ __forceinline__ uint4 pack16(const float* src, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  }
  return u;
}

// Online softmax, part 1: fold a score tile's row maximum into the running
// max ``m`` and return the factor exp(m_old - m_new) by which the running
// denominator and numerator of that row are rescaled.
__device__ __forceinline__ float online_softmax_rescale(float& m,
                                                        float tile_max) {
  const float m_new = fmaxf(m, tile_max);
  const float corr = expf(m - m_new);
  m = m_new;
  return corr;
}

// Online softmax, part 2: the unnormalised probability of one score against
// the updated running max (0 for a masked score).
__device__ __forceinline__ float online_softmax_prob(float s, float m) {
  return expf(s - m);
}

// The same update in base 2, for scores that are not pre-scaled: ``c`` =
// scale * log2(e), so exp2(c * (s - m)) = exp(scale * (s - m)) and the scale
// costs one FMA per score.  ``m`` is the running max of the raw scores.
__device__ __forceinline__ float online_softmax_rescale_log2(float& m,
                                                            float tile_max,
                                                            float c) {
  const float m_new = fmaxf(m, tile_max);
  const float corr = exp2f((m - m_new) * c);
  m = m_new;
  return corr;
}

// ``mc`` = m * c, taken once per row.
__device__ __forceinline__ float online_softmax_prob_log2(float s, float mc,
                                                         float c) {
  return exp2f(fmaf(s, c, -mc));
}

}  // namespace istpu

// Every library built from these sources exports its CUDA error text, so the
// Python wrapper can name a failed launch.
extern "C" const char* istpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
