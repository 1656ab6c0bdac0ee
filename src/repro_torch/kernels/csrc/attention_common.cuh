// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu): the mask constant and vector loads and stores that
// turn bf16 or float32 rows into float32 registers and back.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

// The float32 mask value of the reference (repro/kernels/ops.py NEG_INF).
// Finite on purpose: a row whose keys are all masked so far gets p = 1
// until a live key arrives and corr = exp(NEG_INF - m) = 0 wipes it, where
// -inf would give exp(-inf - -inf) = NaN.
constexpr float kNegInf = -2.0e38f;
// The reference clamps the softmax denominator before dividing.
constexpr float kMinDenominator = 1e-30f;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements at p (aligned to N elements) as float32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  const Vec<float, N> x = *reinterpret_cast<const Vec<float, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x.v[i];
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&out)[N]) {
  const Vec<__nv_bfloat16, N> x =
      *reinterpret_cast<const Vec<__nv_bfloat16, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __bfloat162float(x.v[i]);
}

// N float32 values to p (aligned to N elements), rounded to nearest even
// for bf16, as torch's .to(torch.bfloat16) rounds.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[N]) {
  Vec<float, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = in[i];
  *reinterpret_cast<Vec<float, N>*>(p) = x;
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&in)[N]) {
  Vec<__nv_bfloat16, N> x;
#pragma unroll
  for (int i = 0; i < N; ++i) x.v[i] = __float2bfloat16_rn(in[i]);
  *reinterpret_cast<Vec<__nv_bfloat16, N>*>(p) = x;
}

__device__ __forceinline__ float apply_softcap(float s, float softcap) {
  return softcap > 0.0f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace attn
