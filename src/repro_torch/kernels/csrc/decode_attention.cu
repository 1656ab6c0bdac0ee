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
// clamped to 1e-30 before dividing. A row with no valid slot at all gets
// what the reference's softmax over S equal logits gives: the mean of V.
//
// Bound. Decode attention reads the live cache once per token and does 4
// FLOPs per cached element and query head, about G = 4 FLOPs per byte at
// Qwen3-4B's shape, far below the ~295 at which bf16 tensor cores would
// matter: bytes bound it, and it stays on the CUDA cores. At the serving
// shape (B 8, cap 576, K 8, hd 128, bf16, rows at their own positions) the
// K and V rows of the valid slots, with q, o, slot_pos and pos, are 13.5
// MB: 4.04 us at 3.35 TB/s. The design is about bytes in flight.
//
// Design. The grid is (K, B, splits x ceil(G/4)): a block owns one (batch
// row, KV head), up to 4 of the G query heads that share it, so each cache
// row is read once for all of them, as the TPU kernel's (group, hd) query
// tile did, and one contiguous range of slots. The wrapper picks splits
// (ops.decode_splits): ranges of a multiple of 32 slots, no empty split,
// and at least two blocks per SM (264) where S allows: 6 ranges of 96
// slots at the serving shape (384 blocks, where one range per block gave
// 64 on 132 SMs). A block first reads its range's slot_pos; a range with
// no valid slot loads nothing and leaves an empty state (m = NEG_INF, l =
// 0). Otherwise its K and V go through a ring of three stages of 32 slots
// (16 in float32) in shared memory, loaded by all threads with 16-byte
// cp.async, so two tiles (32 KB at hd 128 bf16) are in flight while the
// block computes on the third; slots that are invalid or past the range
// are zero-filled, not fetched. The four warps take 4 slots of a tile at
// a time; a warp's 32 lanes split head_dim (at hd 80, 4 elements in each
// of the first 20 lanes) with the query rows in registers, sum the 16
// dot products of 4 slots and 4 rows across the warp in one exchange of
// 16 shuffles (where 16 separate sums took 80), and keep a float32 online
// softmax (m, l, acc) per query head, in log2 units, in which an invalid
// slot has p = 0. With G = 1 (Zamba2's shared block) a block holds one
// query row, not four of which three are empty. The warps' states merge
// through shared memory.
// With one split the block writes o. With more, it writes its partial (m,
// l, acc) in float32 to a workspace the wrapper allocates (B H splits (hd
// + 2) floats: 0.4 MB at the serving shape, written and read once), and a
// second kernel, launched from the same C entry point on the same stream,
// merges the splits per (b, h) as the in-block merge does. A second launch
// costs a few us of host time, where a last-block semaphore would need a
// counter that persists between calls, unsafe under CUDA-graph capture and
// concurrent streams. The cache is read in the model's own (B, cap, K, hd)
// layout through strides: the JAX wrapper copied it to (B, K, cap, hd) at
// every call, this kernel needs no copy.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// after each launch so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using attn::kNegInf;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 4;  // query heads of one KV head per block
constexpr int kUnroll = 4;   // cache slots per warp step
constexpr int kStages = 3;   // ring of K and V tiles
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// slots per ring tile: 8 KB of K (and of V) at hd 128
template <typename T>
constexpr int kTileSlots = sizeof(T) == 2 ? 32 : 16;

template <typename T, int HD>
constexpr size_t smem_bytes() {
  // the ring, reused after the loop for the warps' accumulators
  constexpr int E = HD % 32 == 0 ? HD / 32 : 4;
  constexpr size_t ring = 2 * kStages * kTileSlots<T> * HD * sizeof(T);
  constexpr size_t merge = kWarps * kMaxRows * 32 * E * sizeof(float);
  return ring > merge ? ring : merge;
}

struct Args {
  const int* slot_pos;
  long long slot_stride_b;  // 0: one (S,) row for every batch row
  const int* pos;           // null: pos_scalar for every batch row
  long long pos_stride_b;   // 0: one position for every batch row
  int pos_scalar;
  int S, H, group;
  int splits, range;  // slot ranges per (b, KV head) and slots per range
  float* ws;          // splits > 1: (B, H, splits) (m, l), then acc
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale, softcap;
  int window;
};

__device__ __forceinline__ int row_position(const Args& a, int b) {
  return a.pos ? a.pos[b * a.pos_stride_b] : a.pos_scalar;
}

__device__ __forceinline__ bool slot_valid(const Args& a, const int* sp,
                                           int t, int row_pos) {
  const int p = sp[t];
  return p >= 0 && p <= row_pos && (a.window <= 0 || row_pos - p < a.window);
}

// One output element from its merged state: num / den, or, for a row with
// no valid slot (den = 0), what the reference's softmax over S equal
// NEG_INF logits gives: the mean of V's column over all slots.
template <typename T>
__device__ __forceinline__ float finish(float num, float den,
                                        const T* v_col, long long v_ss,
                                        int S) {
  if (den > 0.f) return __fdividef(num, fmaxf(den, attn::kMinDenominator));
  float sum = 0.f;
  for (int t = 0; t < S; ++t) {
    float x[1];
    attn::load_vec<1>(v_col + t * v_ss, x);
    sum += x[0];
  }
  return __fdividef(sum, static_cast<float>(S));
}

// Sums each of the N values v[] over the warp's 32 lanes with 2N - 1 +
// log2(32 / N) shuffles, where N separate reductions take 5N: each halving
// step trades half of the values with the lane OFF away. Returns the total
// of value lane / (32 / N), so that every value's total sits in 32 / N
// neighbouring lanes. N is a power of two, at most 32.
template <int N, int n = N, int OFF = 16>
__device__ __forceinline__ float warp_sum_many(float (&v)[N]) {
  if constexpr (n > 1) {
    const bool upper = threadIdx.x & OFF;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    return warp_sum_many<N, n / 2, OFF / 2>(v);
  } else {
    float x = v[0];
#pragma unroll
    for (int off = OFF; off > 0; off /= 2)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
}

template <typename T>
__device__ __forceinline__ void store_out(const Args& a, T* o, int b, int h,
                                          int d, float value) {
  const float out[1] = {value};
  attn::store_vec<1>(o + b * a.o_sb + h * a.o_sh + d, out);
}

// ROWS: query heads per block, 4 (GQA) or 1 (a KV head per query head,
// as in Zamba2's shared block, where 4 would compute 3 empty rows).
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            Args a) {
  // head_dim elements of one lane: hd / 32, or at hd 80 four elements in
  // each of the first 20 lanes (the others hold zeros and store nothing)
  constexpr int E = HD % 32 == 0 ? HD / 32 : 4;
  constexpr int kLanes = HD / E;
  static_assert(HD % E == 0 && kLanes <= 32, "head_dim");
  constexpr int kTile = kTileSlots<T>;
  constexpr int kPiece = 16 / sizeof(T);     // elements of a 16-byte copy
  constexpr int kPieces = HD / kPiece;       // 16-byte pieces of a row
  static_assert(HD % kPiece == 0, "rows are whole 16-byte pieces");
  static_assert(kTile % (kWarps * kUnroll) == 0, "warps split a tile");
  constexpr int kSumLanes = 32 / (kUnroll * ROWS);  // lanes per score
  const bool lane_on = kLanes == 32 || threadIdx.x % 32 < kLanes;
  extern __shared__ float4 smem4[];
  T* sK = reinterpret_cast<T*>(smem4);  // [kStages][kTile][HD]
  T* sV = sK + kStages * kTile * HD;
  float* s_acc = reinterpret_cast<float*>(smem4);  // after the loop
  __shared__ bool s_valid[kStages][kTile];
  __shared__ float s_m[kWarps][ROWS];
  __shared__ float s_l[kWarps][ROWS];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int zg = blockIdx.z / a.splits;
  const int h0 = kvh * a.group + zg * ROWS;  // first query head
  const int rows = min(ROWS, a.group - zg * ROWS);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_pos = row_position(a, b);
  const int* slot_pos = a.slot_pos + b * a.slot_stride_b;
  const int t_begin = split * a.range;
  const int t_end = min(a.S, t_begin + a.range);

  const T* kb = k + b * a.k_sb + kvh * a.k_sh;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh;

  float qr[ROWS][E], m[ROWS], l[ROWS], acc[ROWS][E];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
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

  const float scale_log2 = a.scale * kLog2e;
  bool any = false;
  for (int t = t_begin + threadIdx.x; t < t_end; t += kThreads)
    any = any || slot_valid(a, slot_pos, t, row_pos);
  any = __syncthreads_or(any);

  if (any) {
    const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
    // tile i of the range into stage i % kStages: the valid rows of K and
    // V by cp.async, the others zero-filled; then one commit group, empty
    // past the last tile so that every thread counts groups alike
    auto issue = [&](int i) {
      if (i < n_tiles) {
        const int stage = i % kStages;
        const int t0 = t_begin + i * kTile;
        for (int idx = threadIdx.x; idx < 2 * kTile * kPieces;
             idx += kThreads) {
          const bool is_v = idx >= kTile * kPieces;
          const int r = (idx % (kTile * kPieces)) / kPieces;
          const int c = (idx % kPieces) * kPiece;
          const int t = t0 + r;
          const bool live = t < t_end && slot_valid(a, slot_pos, t, row_pos);
          const T* base = is_v ? vb : kb;
          const long long ss = is_v ? a.v_ss : a.k_ss;
          T* dst = (is_v ? sV : sK) + (stage * kTile + r) * HD + c;
          attn::cp_async16(dst, live ? base + t * ss + c : base, live);
        }
        if (threadIdx.x < kTile) {
          const int t = t0 + threadIdx.x;
          s_valid[stage][threadIdx.x] =
              t < t_end && slot_valid(a, slot_pos, t, row_pos);
        }
      }
      attn::cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < n_tiles; ++i) {
      // tile i has landed for every thread, and every warp is done with
      // tile i - 1, whose stage tile i + kStages - 1 fills
      attn::cp_async_wait<kStages - 2>();
      __syncthreads();
      issue(i + kStages - 1);
      const int stage = i % kStages;
      const T* tK = sK + stage * kTile * HD + lane * E;
      const T* tV = sV + stage * kTile * HD + lane * E;

      for (int u0 = warp * kUnroll; u0 < kTile; u0 += kWarps * kUnroll) {
        bool live[kUnroll];
        bool some = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          live[u] = s_valid[stage][u0 + u];
          some = some || live[u];
        }
        if (!some) continue;  // the same for every lane of the warp
        // q . k of the group's slots and rows, summed over the warp in
        // one exchange; then every lane takes all the scores, in log2 units
        float dot[kUnroll * ROWS];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float kk[E];
          if (lane_on) {
            attn::load_vec<E>(tK + (u0 + u) * HD, kk);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kk[e] = 0.f;
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            float x = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) x = fmaf(qr[r][e], kk[e], x);
            dot[u * ROWS + r] = x;
          }
        }
        const float mine = warp_sum_many(dot);
        float s[kUnroll][ROWS];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float x =
                __shfl_sync(0xffffffffu, mine, (u * ROWS + r) * kSumLanes);
            s[u][r] = a.softcap > 0.f ? kLog2e * attn::apply_softcap(
                                                     x * a.scale, a.softcap)
                                      : x * scale_log2;
          }
        float vv[kUnroll][E];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (lane_on) {
            attn::load_vec<E>(tV + (u0 + u) * HD, vv[u]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) vv[u][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float mx = kNegInf;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (live[u]) mx = fmaxf(mx, s[u][r]);
          const float m_new = fmaxf(m[r], mx);
          const float corr = exp2f(m[r] - m_new);
          float p[kUnroll], sum = 0.f;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            p[u] = live[u] ? exp2f(s[u][r] - m_new) : 0.f;
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
    }
    attn::cp_async_wait<0>();
  }

  // merge the warps' partial softmax states through the ring's memory
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      s_acc[(warp * ROWS + r) * 32 * E + lane * E + e] = acc[r][e];
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
      const float f = exp2f(s_m[w][r] - mx);
      den = fmaf(s_l[w][r], f, den);
      num = fmaf(s_acc[(w * ROWS + r) * 32 * E + d], f, num);
    }
    const int h = h0 + r;
    if (a.splits == 1) {
      store_out(a, o, b, h, d, finish(num, den, vb + d, a.v_ss, a.S));
    } else {
      const long long slot = (static_cast<long long>(b) * a.H + h) *
                                 a.splits + split;
      float* ml = a.ws + 2 * slot;
      float* wacc = a.ws + 2LL * a.H * a.splits * gridDim.y + slot * HD;
      if (d == 0) {
        ml[0] = mx;
        ml[1] = den;
      }
      wacc[d] = num;
    }
  }
}

// Merges the splits' partial states of one (b, h), as the block merges its
// warps: weights exp(m_s - max m), empty splits (l = 0) skipped.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const T* __restrict__ v, T* __restrict__ o,
                          int B, Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long first = (static_cast<long long>(b) * a.H + h) * a.splits;
  const float* ml = a.ws + 2 * first;
  const float* wacc = a.ws + 2LL * a.H * a.splits * B + first * HD;
  float mx = kNegInf;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < HD; d += kCombineThreads) {
    float den = 0.f, num = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ls = ml[2 * s + 1];
      if (ls == 0.f) continue;  // no valid slot; its acc was not written
      const float f = exp2f(ml[2 * s] - mx);
      den = fmaf(ls, f, den);
      num = fmaf(wacc[s * HD + d], f, num);
    }
    const T* v_col = v + b * a.v_sb + (h / a.group) * a.v_sh + d;
    store_out(a, o, b, h, d, finish(num, den, v_col, a.v_ss, a.S));
  }
}

// The main kernel's grid: (KV head, row, split x group of ROWS query
// heads); decode_attention_geometry reports it for the Python mirror.
inline dim3 main_grid(int K, int B, int splits, int group, int rows) {
  return dim3(K, B, splits * ((group + rows - 1) / rows));
}

template <typename T, int HD, int ROWS>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        void* o, int B, int K, const Args& a,
                        cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD, ROWS>;
  constexpr size_t smem = smem_bytes<T, HD>();
  static unsigned long long opted_in = 0;
  cudaError_t err = attn::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<main_grid(K, B, a.splits, a.group, ROWS), kThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  decode_combine_kernel<T, HD><<<dim3(a.H, B), kCombineThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<T*>(o), B, a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int K, const Args& a, cudaStream_t stream) {
  if (a.group == 1)
    return launch_rows<T, HD, 1>(q, k, v, o, B, K, a, stream);
  return launch_rows<T, HD, kMaxRows>(q, k, v, o, B, K, a, stream);
}

template <typename T, int HD>
int geometry(int B, int H, int K, int splits, long long* out) {
  const int group = H / K;
  const dim3 g = main_grid(K, B, splits, group, group == 1 ? 1 : kMaxRows);
  out[0] = g.x;
  out[1] = g.y;
  out[2] = g.z;
  out[3] = kThreads;
  out[4] = static_cast<long long>(smem_bytes<T, HD>());
  if (splits == 1) return 1;
  out[5] = H;  // the combine kernel
  out[6] = B;
  out[7] = 1;
  out[8] = kCombineThreads;
  out[9] = 0;
  return 2;
}

template <typename T>
int geometry_hd(int hd, int B, int H, int K, int splits, long long* out) {
  switch (hd) {
    case 64:
      return geometry<T, 64>(B, H, K, splits, out);
    case 80:
      return geometry<T, 80>(B, H, K, splits, out);
    case 128:
      return geometry<T, 128>(B, H, K, splits, out);
    case 256:
      return geometry<T, 256>(B, H, K, splits, out);
    default:
      return -1;
  }
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
// by their (b, slot, head) strides, all in elements with hd contiguous and
// k, v rows 16-byte aligned; is_bf16 selects bf16 for all four, else
// float32. slot_pos: int32, row b at slot_pos + b * slot_stride_b. pos:
// int32 at pos + b * pos_stride_b, or null for pos_scalar. hd must be 64,
// 80, 128 or 256. The slots are cut into `splits` ranges of `range` slots
// (a multiple of 32, none empty); with splits > 1, ws holds B * H * splits
// * (hd + 2) floats of scratch.
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, void* o,
    const void* slot_pos, long long slot_stride_b, const void* pos,
    long long pos_stride_b, int pos_scalar, int is_bf16, int B, int H,
    int K, int S, int hd, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, float scale, int window,
    float softcap, int splits, int range, void* ws, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || S <= 0 || splits <= 0 || range <= 0 ||
      (splits - 1) * range >= S || splits * range < S ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  Args a;
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.slot_stride_b = slot_stride_b;
  a.pos = static_cast<const int*>(pos);
  a.pos_stride_b = pos_stride_b;
  a.pos_scalar = pos_scalar;
  a.S = S;
  a.H = H;
  a.group = H / K;
  a.splits = splits;
  a.range = range;
  a.ws = static_cast<float*>(ws);
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

// The launches of a call with B rows, H query heads over K KV heads and
// `splits` ranges: for each, out[5 i .. 5 i + 2] the grid, out[5 i + 3]
// threads a block, out[5 i + 4] bytes of dynamic shared memory a block.
// Returns the number of launches (1, or 2 with the combine kernel), or -1
// for a head_dim the kernels were not compiled for.
extern "C" int decode_attention_geometry(int is_bf16, int B, int H, int K,
                                         int hd, int splits,
                                         long long* out) {
  if (K <= 0 || H % K != 0 || splits <= 0) return -1;
  if (is_bf16)
    return geometry_hd<__nv_bfloat16>(hd, B, H, K, splits, out);
  return geometry_hd<float>(hd, B, H, K, splits, out);
}
