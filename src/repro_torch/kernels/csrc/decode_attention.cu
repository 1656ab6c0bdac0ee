// Decode attention: one query token per batch row against its KV cache,
// with per-slot validity (ring buffers), optional sliding window and tanh
// logit softcap, grouped-query heads, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention (body _kernel):
//     o[b,h] = sum_t softmax_t(mask(softcap(scale * q[b,h] . k[b,t,h/G])))
//              * v[b,t,h/G]
// where slot t is valid when 0 <= slot_pos[b,t] <= pos[b] (and
// pos[b] - slot_pos[b,t] < window); slot_pos is (S,) or (B,S) and pos a
// scalar or (B,), as the reference broadcasts them. The mask is the
// reference's NEG_INF = -2e38, the softcap comes before it, and l is
// clamped to 1e-30 before dividing.
//
// Design. One block of 8 warps owns one (batch row, KV head) and up to 4
// of the G query heads that share it (G > 4 takes more blocks along z), so
// each cache row is read once for all of them, as the TPU kernel's
// (group, hd) query tile did. Each warp walks its own slots, 4 at a time;
// its 32 lanes split head_dim, so a slot's K and V rows are read as one
// coalesced 256-byte (bf16, hd 128) load per warp, and the query rows sit
// in registers. Each warp keeps a float32 online softmax (m, l, acc) per
// query head; at the end the 8 partial states are merged through shared
// memory. The cache is read in the model's own (B, cap, K, hd) layout
// through strides: the JAX wrapper copied it to (B, K, cap, hd) at every
// call, this kernel needs no copy. At head_dim 80 (Zamba2's shared block,
// whose 32 query heads have 32 KV heads, so a block holds one query row)
// the first 20 lanes load 4 elements each and the other 12 hold zeros.
//
// Bound. Decode attention reads the whole live cache once per token and
// does 4 FLOPs per cached element and query head: at the serving shape
// (B 8, cap 576, K 8, hd 128, bf16) that is 18.9 MB and 19 MFLOP per
// layer, so bytes bound it (5.6 us at 3.35 TB/s). The grid is only B * K
// = 64 blocks, fewer than the 132 SMs, with 8 rows in flight per warp; a
// split over cache blocks with a combine pass, which fills the card, is
// later work.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using attn::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;    // query heads of one KV head per block
constexpr int kUnroll = 4;  // cache slots per warp step

struct Args {
  const int* slot_pos;
  long long slot_stride_b;  // 0: one (S,) row for every batch row
  const int* pos;           // null: pos_scalar for every batch row
  long long pos_stride_b;   // 0: one position for every batch row
  int pos_scalar;
  int S, group;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale, softcap;
  int window;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            Args a) {
  // head_dim elements of one lane: hd / 32, or at hd 80 four elements in
  // each of the first 20 lanes (the others hold zeros and store nothing)
  constexpr int E = HD % 32 == 0 ? HD / 32 : 4;
  constexpr int kLanes = HD / E;
  static_assert(HD % E == 0 && kLanes <= 32, "head_dim");
  const bool lane_on = kLanes == 32 || threadIdx.x % 32 < kLanes;
  __shared__ float s_m[kWarps][kRows];
  __shared__ float s_l[kWarps][kRows];
  __shared__ float s_acc[kWarps][kRows][32 * E];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * a.group + blockIdx.z * kRows;  // first query head
  const int rows = min(kRows, a.group - static_cast<int>(blockIdx.z) * kRows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_pos = a.pos ? a.pos[b * a.pos_stride_b] : a.pos_scalar;
  const int* slot_pos = a.slot_pos + b * a.slot_stride_b;

  float qr[kRows][E], m[kRows], l[kRows], acc[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows && lane_on) {
      attn::load_vec<E>(q + b * a.q_sb + (h0 + r) * a.q_sh + lane * E, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const T* kb = k + b * a.k_sb + kvh * a.k_sh + lane * E;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh + lane * E;

  for (int t0 = warp * kUnroll; t0 < a.S; t0 += kWarps * kUnroll) {
    float kk[kUnroll][E], s[kUnroll][kRows];
    bool in[kUnroll], live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      in[u] = t < a.S;
      live[u] = false;
      if (in[u]) {
        if (lane_on) {
          attn::load_vec<E>(kb + t * a.k_ss, kk[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kk[u][e] = 0.f;
        }
        const int sp = slot_pos[t];
        live[u] = sp >= 0 && sp <= row_pos &&
                  (a.window <= 0 || row_pos - sp < a.window);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kk[u][e] = 0.f;
      }
    }
    // q . k over the lane's elements, then summed across the warp
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[r][e], kk[u][e], x);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u][r] = live[u] ? attn::apply_softcap(x * a.scale, a.softcap)
                          : kNegInf;
      }
    float vv[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (in[u] && lane_on) {
        attn::load_vec<E>(vb + (t0 + u) * a.v_ss, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (in[u]) mx = fmaxf(mx, s[u][r]);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float p[kUnroll], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = in[u] ? expf(s[u][r] - m_new) : 0.f;
        sum += p[u];
      }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float x = acc[r][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vv[u][e], x);
        acc[r][e] = x;
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w][r] - mx);
      den = fmaf(s_l[w][r], f, den);
      num = fmaf(s_acc[w][r][d], f, num);
    }
    const float out[1] = {num / fmaxf(den, attn::kMinDenominator)};
    attn::store_vec<1>(o + b * a.o_sb + (h0 + r) * a.o_sh + d, out);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int K, const Args& a, cudaStream_t stream) {
  const dim3 grid(K, B, (a.group + kRows - 1) / kRows);
  decode_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int K, const Args& a,
                        cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, K, a, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, K, a, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, K, a, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, K, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,hd) and o (B,H,hd) by their (b, head) strides; k and v (B,S,K,hd)
// by their (b, slot, head) strides, all in elements with hd contiguous;
// is_bf16 selects bf16 for all four, else float32. slot_pos: int32, row b
// at slot_pos + b * slot_stride_b. pos: int32 at pos + b * pos_stride_b,
// or null for pos_scalar. hd must be 64, 80, 128 or 256.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, void* o,
    const void* slot_pos, long long slot_stride_b, const void* pos,
    long long pos_stride_b, int pos_scalar, int is_bf16, int B, int H,
    int K, int S, int hd, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale, int window,
    float softcap, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  Args a;
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.slot_stride_b = slot_stride_b;
  a.pos = static_cast<const int*>(pos);
  a.pos_stride_b = pos_stride_b;
  a.pos_scalar = pos_scalar;
  a.S = S;
  a.group = H / K;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.scale = scale;
  a.softcap = softcap;
  a.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, K, a, s);
  return dispatch_hd<float>(hd, q, k, v, o, B, K, a, s);
}
