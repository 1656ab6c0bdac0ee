// Flash attention forward (causal or not, optional sliding window and tanh
// logit softcap, grouped-query heads) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel). Same function, not the same blocks:
//     o[b,h,i] = sum_j softmax_j(mask(softcap(scale * q[b,h,i] . k[b,h/G,j])))
//                * v[b,h/G,j]
// with the reference's NEG_INF = -2e38 mask (not -inf), the softcap before
// the mask, float32 m / l / acc, and l clamped to 1e-30 before dividing.
//
// Design. One block of 256 threads owns one (batch, query head, 64-row
// query tile); blocks of the longest (last) query tiles are issued first.
// It loops over 64-key tiles from the window's first live tile to the
// causal diagonal, so fully masked tiles are never read, as the TPU kernel
// skipped them with pl.when. The query tile stays in shared memory as
// float32; each key tile is read once into shared memory for QK^T and the
// value tile is then read into the same buffer for PV, which keeps a block
// at 88 KB for head_dim 128 so that two blocks share an SM. The 16 x 16
// threads each hold a 4 x 4 patch of the score tile and 4 rows x hd/16
// columns of the float32 accumulator in registers; row max and row sum
// are shuffles across the 16 threads of a row group. The kernel reads the
// query head's KV head as h / G itself: K and V are never expanded to H
// heads. A ragged last tile is masked (keys past S contribute exactly 0,
// query rows past S are not stored), so S need not divide by 64, where the
// TPU kernel needed S % block == 0. Inputs are bf16 or float32 with any
// strides whose head_dim axis is contiguous, so the model's (B, S, H, hd)
// activations go in as transposed views, without a copy. head_dim is 64,
// 80, 128 or 256; at 80 (Zamba2's shared block) the value columns 64..79
// fall to the first four thread columns, and the others skip their second
// chunk.
//
// Bound. At the serving path's prefill shapes (Qwen3-4B: 32 query heads
// over 8 KV heads, hd 128, bf16) the causal work at S = 512 is about
// 2 * 2 * H * S^2/2 * hd = 2.1 GFLOP against 10.5 MB read and written:
// 2.2 us at the bf16 tensor-core rate, 3.1 us at the memory rate, so the
// card's own bound is bytes. This first kernel computes in float32 on the
// CUDA cores (67 TFLOP/s: 32 us for the same work), with no tensor cores,
// wgmma, TMA, or overlap of loads with compute: the operations bound it,
// and those are the levers of later work.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using attn::kNegInf;

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kRG = 16;              // thread rows
constexpr int kCG = 16;              // thread columns
constexpr int kThreads = kRG * kCG;  // 256
constexpr int kTM = kBQ / kRG;       // query rows per thread
constexpr int kTN = kBK / kCG;       // keys per thread
constexpr int kPStride = kBK + 16;   // score rows of a warp on other banks
static_assert(kBQ == kBK, "load_tile loads 64-row tiles of q, k and v");

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * (HD + 4) +
          static_cast<size_t>(kBQ) * kPStride);
}

struct Strides {
  long long b, h, s;
};

// Rows row0 .. row0+63 of one (b, head) slice into a float32 tile with
// row stride HD + 4; rows at or past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride_s, int row0,
                                          int S) {
  constexpr int kVecs = HD / 4;
  for (int idx = threadIdx.x; idx < kBK * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) attn::load_vec<4>(src + (row0 + r) * stride_s + c, x);
    attn::store_vec<4>(dst + r * (HD + 4) + c, x);
  }
}

__device__ __forceinline__ float row_group_max(float x) {
#pragma unroll
  for (int off = kCG / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_group_sum(float x) {
#pragma unroll
  for (int off = kCG / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Whether thread column cg holds output columns 4 cg + 64 j .. + 3: always
// when 64 divides HD, so those head_dims compile as if unchecked.
template <int HD>
__device__ __forceinline__ bool has_chunk_of(int cg, int j) {
  return HD % 64 == 0 || 4 * cg + 64 * j < HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int group, int S, Strides qs, Strides ks,
                           Strides vs, Strides os, float scale, int causal,
                           int window, float softcap) {
  // float4 column chunks of a thread in PV: columns 4 cg + 64 j. At hd 80
  // the second chunk covers columns 64..79, so only cg < 4 holds one.
  constexpr int kDV = (HD + 63) / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + kBQ * (HD + 4);
  float* sP = sKV + kBK * (HD + 4);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int kvh = h / group;
  const int rg = threadIdx.x / kCG;
  const int cg = threadIdx.x % kCG;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  load_tile<T, HD>(sQ, qb, qs.s, q0, S);

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_tiles = (S + kBK - 1) / kBK;
  const int hi = causal ? min(n_tiles, q_last / kBK + 1) : n_tiles;
  const int lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float m[kTM], l[kTM], acc[kTM][kDV][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's PV is done with sKV and sP
    load_tile<T, HD>(sKV, kb, ks.s, k0, S);
    __syncthreads();

    // scores of this thread's 4 x 4 patch: rows rg + 16 i, keys cg + 16 j
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[kTM][4], kv[kTN][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        attn::load_vec<4>(sQ + (rg + kRG * i) * (HD + 4) + d, qv[i]);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        attn::load_vec<4>(sKV + (cg + kCG * j) * (HD + 4) + d, kv[j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

    // mask and online softmax, one query row at a time
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int qpos = q0 + rg + kRG * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kpos = k0 + cg + kCG * j;
        const bool live = (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = live ? attn::apply_softcap(s[i][j] * scale, softcap)
                       : kNegInf;
        if (kpos < S) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kpos = k0 + cg + kCG * j;
        const float p = kpos < S ? expf(s[i][j] - m_new) : 0.f;
        sP[(rg + kRG * i) * kPStride + cg + kCG * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }

    __syncthreads();  // every thread is done with K; P is written
    load_tile<T, HD>(sKV, vb, vs.s, k0, S);
    __syncthreads();

    // acc += P V: rows rg + 16 i, columns 4 cg + 64 j .. + 3
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float pv[kTM][4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        attn::load_vec<4>(sP + (rg + kRG * i) * kPStride + c, pv[i]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int j = 0; j < kDV; ++j) {
          if (!has_chunk_of<HD>(cg, j)) continue;
          float vv[4];
          attn::load_vec<4>(sKV + (c + t) * (HD + 4) + 4 * cg + 64 * j, vv);
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = fmaf(pv[i][t], vv[e], acc[i][j][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qpos = q0 + rg + kRG * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], attn::kMinDenominator);
#pragma unroll
    for (int j = 0; j < kDV; ++j) {
      if (!has_chunk_of<HD>(cg, j)) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][j][e] / denom;
      attn::store_vec<4>(ob + qpos * os.s + 4 * cg + 64 * j, out);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int S, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB of shared memory a kernel must opt in, once per device
  static unsigned long long opted_in = 0;  // one bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!(opted_in >> device & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in |= 1ull << device;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / K, S, qs, ks, vs, os,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int K, int S, Strides qs,
                        Strides ks, Strides vs, Strides os, float scale,
                        int causal, int window, float softcap,
                        cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, K, S, qs, ks, vs, os, scale,
                           causal, window, softcap, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, K, S, qs, ks, vs, os, scale,
                           causal, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, K, S, qs, ks, vs, os, scale,
                            causal, window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, K, S, qs, ks, vs, os, scale,
                            causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,S,hd), k and v (B,K,S,hd), o (B,H,S,hd), each given by its
// (b, head, s) strides in elements with hd contiguous; is_bf16 selects
// bf16 for all four, else float32. hd must be 64, 80, 128 or 256.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int K, int S, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int window,
    float softcap, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, K, S, qs, ks, vs,
                                      os, scale, causal, window, softcap, s);
  return dispatch_hd<float>(hd, q, k, v, o, B, H, K, S, qs, ks, vs, os,
                            scale, causal, window, softcap, s);
}
