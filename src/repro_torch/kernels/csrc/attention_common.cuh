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

// 16 bytes from global src to shared dst without passing through
// registers (cp.async, cached in L2 only). With full false nothing is read
// and dst is zero-filled, so a ragged or invalid row costs no fetch.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lets kernel take `bytes` of dynamic shared memory on the current device:
// above 48 KB a kernel must opt in, once per device. `done` holds one bit
// per device and belongs to the caller's kernel instantiation.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes,
                        unsigned long long& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (done >> device & 1ull) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done |= 1ull << device;
  return err;
}

}  // namespace attn
