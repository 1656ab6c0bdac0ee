// V-trace (IMPALA, Espeholt et al. 2018, §4.1) in one launch, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/vtrace.py::vtrace_scan
// (body _kernel) together with the elementwise math of its wrapper
// repro/kernels/ops.py::vtrace_from_importance_weights_kernel: rho/c
// clipping, the TD errors delta_t, the reverse recurrence
//     acc_t = delta_t + discount_t * c_t * acc_{t+1},   acc_T = 0,
// vs_t = values_t + acc_t, and the policy-gradient advantages
//     pg_t = min(rho_pg, rho_t) * (r_t + discount_t * vs_{t+1} - values_t).
//
// Design. One thread owns one batch column b and walks t = T-1 .. 0. It
// carries acc_{t+1}, values_{t+1} and vs_{t+1} in registers, so each
// element is read once and both outputs come out of the same reverse pass;
// nothing carries between threads or blocks (the TPU kernel instead ran
// the time loop over a (T, 128) lane tile held in VMEM). Arrays are
// row-major (T, B), so the 32 threads of a warp read 32 neighbouring
// floats of one row per step. Any B is accepted: threads past the edge
// return at once (the TPU kernel needs B divisible by its 128-lane block).
//
// Bound. 4 reads + 2 writes of (T, B) float32 plus the (B,) bootstrap:
// about 61 KB at the learner's T=80, B=32. That is ~18 ns at 3.35 TB/s,
// far below one launch's latency, so at the main path's shapes the kernel
// is bound by launch latency; at large B it is bound by bytes. The serial
// T loop leaves one column's loads exposed per step; hiding that (several
// steps of loads in flight, or a parallel scan over T) is later work.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; the function returns cudaGetLastError() so that a
// refused launch is reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void vtrace_kernel(const float* __restrict__ log_rhos,
                              const float* __restrict__ discounts,
                              const float* __restrict__ rewards,
                              const float* __restrict__ values,
                              const float* __restrict__ bootstrap,
                              float* __restrict__ vs,
                              float* __restrict__ pg_advantages,
                              int T, int B, float clip_rho, float clip_c,
                              float clip_pg_rho) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float boot = bootstrap[b];
  float acc = 0.0f;       // acc_{t+1}
  float v_next = boot;    // values_{t+1}
  float vs_next = boot;   // vs_{t+1}
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float rho = expf(log_rhos[i]);
    const float discount = discounts[i];
    const float reward = rewards[i];
    const float value = values[i];
    const float delta =
        fminf(clip_rho, rho) * (reward + discount * v_next - value);
    acc = delta + discount * fminf(clip_c, rho) * acc;
    const float vs_t = value + acc;
    vs[i] = vs_t;
    pg_advantages[i] =
        fminf(clip_pg_rho, rho) * (reward + discount * vs_next - value);
    v_next = value;
    vs_next = vs_t;
  }
}

}  // namespace

extern "C" int vtrace_from_importance_weights(
    const void* log_rhos, const void* discounts, const void* rewards,
    const void* values, const void* bootstrap, void* vs, void* pg_advantages,
    int T, int B, float clip_rho, float clip_c, float clip_pg_rho,
    void* stream) {
  if (T > 0 && B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    vtrace_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_rhos),
        static_cast<const float*>(discounts),
        static_cast<const float*>(rewards),
        static_cast<const float*>(values),
        static_cast<const float*>(bootstrap), static_cast<float*>(vs),
        static_cast<float*>(pg_advantages), T, B, clip_rho, clip_c,
        clip_pg_rho);
  }
  return static_cast<int>(cudaGetLastError());
}
