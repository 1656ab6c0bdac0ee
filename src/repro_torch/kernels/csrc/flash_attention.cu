// Flash attention forward (causal or not, optional sliding window and tanh
// logit softcap, grouped-query heads) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _kernel). Same function, not the same blocks:
//     o[b,h,i] = sum_j softmax_j(mask(softcap(scale * q[b,h,i] . k[b,h/G,j])))
//                * v[b,h/G,j]
// with the reference's NEG_INF = -2e38 mask (not -inf), the softcap before
// the mask, float32 m / l / acc, and l clamped to 1e-30 before dividing.
// Both kernels below share what the TPU kernel did: a block owns one
// (batch, query head, 64-row query tile), blocks of the longest (last)
// query tiles are issued first, and the key loop runs from the window's
// first live tile to the causal diagonal, so fully masked tiles are never
// read, as the TPU kernel skipped them with pl.when. GQA is read as KV
// head h / G (K and V are never expanded), a ragged last tile is masked
// (keys past S contribute exactly 0, query rows past S are not stored), and
// inputs come with any (b, head, s) strides whose head_dim axis is
// contiguous, so the model's (B, S, H, hd) activations go in as transposed
// views. head_dim is 64, 80, 128 or 256. The dtype alone picks the kernel.
// The queries may be offset from the keys: q holds Sq rows at positions
// q_offset .. q_offset + Sq - 1 of the Sk keys (one rank's share of a
// sequence split over its queries, the keys whole), and the mask, the
// window and the key tiles a query tile visits all read those positions.
// At q_offset 0 and Sq = Sk it is the reference's function.
//
// Bound. At the serving path's prefill shape (Qwen3-4B: 32 query heads
// over 8 KV heads, hd 128, bf16, S = 512, causal) the function reads q, k,
// v and writes o, 10.5 MB: 3.1 us at 3.35 TB/s. Its products are 2.1
// GFLOP, 2.2 us at 989 TFLOP/s; this kernel does 4.3 GFLOP of tensor-core
// work (P V three times, below), 4.3 us. So the card's bound is bytes and
// the kernel's own floor its tensor-core work, both a few microseconds.
//
// bf16: tensor cores (tc::flash_tc_kernel). A block of eight warps owns
// the 64-row query tile as two halves of four warps, 16 rows a warp; the
// halves take alternate key tiles (lo, lo + 2, .. and lo + 1, lo + 3, ..)
// with an online softmax each, and the second half's (m, l, acc) is merged
// into the first's through shared memory at the end. So the longest query
// tile, which sets the kernel's time under the causal mask, runs on twice
// the warps, and the grid, heads fastest, issues every head's longest tile
// first. Each warp runs mma.sync.m16n8k16 (bf16 operands, float32
// accumulators): S = Q K^T, then O += P V. Operands come from shared
// memory by ldmatrix (.trans for V) out of rows padded by 16 bytes, so the
// 8 rows of one 8x8 matrix fall on distinct banks. At hd <= 128 the Q
// fragments stay in registers for the whole key loop; at hd 256 they are
// re-read from shared memory each tile, since the 16 x 256 float32
// accumulator already takes 128 registers a thread. mma.sync and not wgmma:
// every operand here has an arbitrary row stride from the caller, which
// ldmatrix takes as it is, where wgmma wants TMA descriptors built per call
// on the host from the driver API; at these shapes the tensor-core time
// (above) is already below the memory time. K and V tiles of 64 keys (32
// at hd 256, where the accumulator leaves too few registers for 64) go
// through rings of four stages in separate K and V buffers, loaded by
// 16-byte cp.async (rows past S zero-filled by the src-size operand): the
// pair of tiles j+2, j+3 is in flight while the halves compute tiles j and
// j+1, and one __syncthreads per pair both publishes a pair and frees the
// stages the next one fills. The softmax is the float32 online (m, l) per
// row in registers, in log2 units (log2(e) folded into the scale, exp2f),
// with the row max across the four lanes of a quad by shuffles; the score
// fragments become P's A fragments in registers. P cannot be rounded once
// to bf16 as other flash kernels do: a single bf16 P misses the bf16 bar
// (the float32 function rounded once, rtol 2^-7, atol 1e-6) on most
// inputs, two terms on some. So P enters P V as three bf16 terms, hi =
// bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), whose sum carries
// p to about 2^-24; q, k and v are exact in bf16, and every product is
// summed in float32. That is three MMAs for P V and one for Q K^T.
//
// float32: CUDA cores (simt::flash_attention_kernel), since the tensor
// cores would take float32 only as TF32, which the float32 bar (2e-5) does
// not allow. One block of 256 threads; the query tile stays in shared
// memory as float32; each key tile is read into shared memory for QK^T and
// the value tile then into the same buffer for PV (88 KB for head_dim
// 128, so two blocks share an SM). The 16 x 16 threads each hold a 4 x 4
// patch of the score tile and 4 rows x hd/16 columns of the float32
// accumulator in registers; row max and row sum are shuffles across the 16
// threads of a row group. At hd 80 the value columns 64..79 fall to the
// first four thread columns, and the others skip their second chunk. It
// runs at 67 TFLOP/s at best, with no overlap of loads and compute.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// so that a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using attn::kNegInf;

struct Strides {
  long long b, h, s;
};

namespace simt {

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
                           int group, int Sq, int Sk, int q_off, Strides qs,
                           Strides ks, Strides vs, Strides os, float scale,
                           int causal, int window, float softcap) {
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

  load_tile<T, HD>(sQ, qb, qs.s, q0, Sq);

  // query row r sits at position q_off + r of the keys' sequence
  const int q_last = q_off + min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int hi = causal ? min(n_tiles, q_last / kBK + 1) : n_tiles;
  const int lo = window > 0 ? max(0, q_off + q0 - window + 1) / kBK : 0;

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
    load_tile<T, HD>(sKV, kb, ks.s, k0, Sk);
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
      const int qpos = q_off + q0 + rg + kRG * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kpos = k0 + cg + kCG * j;
        const bool live = (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = live ? attn::apply_softcap(s[i][j] * scale, softcap)
                       : kNegInf;
        if (kpos < Sk) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kpos = k0 + cg + kCG * j;
        const float p = kpos < Sk ? expf(s[i][j] - m_new) : 0.f;
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
    load_tile<T, HD>(sKV, vb, vs.s, k0, Sk);
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
    const int row = q0 + rg + kRG * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], attn::kMinDenominator);
#pragma unroll
    for (int j = 0; j < kDV; ++j) {
      if (!has_chunk_of<HD>(cg, j)) continue;
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][j][e] / denom;
      attn::store_vec<4>(ob + row * os.s + 4 * cg + 64 * j, out);
    }
  }
}


}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;      // query rows per block, 16 per warp of a half
constexpr int kWarps = 8;    // two halves of four warps
constexpr int kThreads = 32 * kWarps;
constexpr int kHalf = kThreads / 2;
constexpr int kStages = 4;   // two tiles in use, two in flight
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int kBK = HD == 256 ? 32 : 64;  // keys per tile
  static constexpr int kStride = HD + 8;  // bf16 per smem row: 16 B of pad
  static constexpr bool kQInRegs = HD <= 128;
  static constexpr int kKSteps = HD / 16;  // k-steps of Q K^T
  static constexpr int kSTiles = kBK / 8;  // n-tiles of the score tile
  static constexpr int kOTiles = HD / 8;   // n-tiles of the output
  static constexpr int kTile = kBK * kStride;  // bf16 of one K or V stage
  // the K and V rings, and Q: in registers at hd <= 128, where it is
  // staged in K's third stage before the loop fills that
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kStages * kTile + (kQInRegs ? 0 : kBQ * kStride));
  // after the loop the rings hold the second half's (m, l, acc)
  static constexpr size_t kExchange = sizeof(float) * kHalf * (HD / 2 + 4);
  static_assert(!kQInRegs || kBK == kBQ, "Q is staged in one K stage");
  static_assert(HD % 16 == 0 && kBK % 16 == 0, "m16n8k16 steps");
  static_assert(kExchange <= kSmem, "the exchange fits in the rings");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) as three packed bf16 pairs whose sum is (x0, x1) to ~2^-24:
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); the
// differences are exact in float32.
__device__ __forceinline__ void split3(float x0, float x1, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// Rows row0 .. row0+ROWS-1 of one (b, head) slice into a padded smem tile
// by cp.async; rows at or past S are zero-filled, not read.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long stride_s, int row0,
                                                int S) {
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool in = row0 + r < S;
    attn::cp_async16(dst + r * Cfg<HD>::kStride + c,
                     in ? src + (row0 + r) * stride_s + c : src, in);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts of m16n8k16 (lane = 4 g + t): a score or output
// fragment c[4] of an n-tile holds rows g (c[0], c[1]) and g + 8 (c[2],
// c[3]) at columns 2t, 2t + 1 of its 8.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int group, int Sq, int Sk, int q_off, Strides qs,
                    Strides ks, Strides vs, Strides os, float scale,
                    int causal, int window, float softcap) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK;
  constexpr int kStride = C::kStride;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // kStages stages
  bf16* sV = sK + kStages * C::kTile;         // kStages stages
  bf16* sQ = C::kQInRegs ? sK + 2 * C::kTile : sV + kStages * C::kTile;

  // heads vary fastest, so the first blocks issued are every head's last
  // (longest) query tile, then the next-longest, and so on
  const int b = blockIdx.z;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kvh = h / group;
  const int half = threadIdx.x / kHalf;  // takes key tiles lo + half, + 2, ..
  const int warp = threadIdx.x % kHalf / 32;  // row group within the half
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  // query row r sits at position q_off + r of the keys' sequence
  const int q_last = q_off + min(q0 + kBQ, Sq) - 1;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int hi = causal ? min(n_tiles, q_last / kBK + 1) : n_tiles;
  const int lo = window > 0 ? max(0, q_off + q0 - window + 1) / kBK : 0;

  // the first two tiles, one for each half, and Q; later pairs are loaded
  // one pair ahead
  auto load_pair = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kt + i >= hi) break;
      const int stage = (kt + i - lo) % kStages;
      load_tile_async<HD, kBK>(sK + stage * C::kTile, kb, ks.s,
                               (kt + i) * kBK, Sk);
      load_tile_async<HD, kBK>(sV + stage * C::kTile, vb, vs.s,
                               (kt + i) * kBK, Sk);
    }
    attn::cp_async_commit();
  };
  load_tile_async<HD, kBQ>(sQ, qb, qs.s, q0, Sq);
  load_pair(lo);

  // ldmatrix row addresses of this lane: Q's A fragment (rows l % 16,
  // column half l / 16), K's B fragments of two n-tiles (keys l % 8 +
  // 8 (l / 16), column half (l / 8) % 2), V's transposed B fragments of
  // two n-tiles (keys l % 8 + 8 ((l / 8) % 2), column half l / 16)
  const int a_row = warp * 16 + lane % 16, a_col = (lane / 16) * 8;
  const int k_row = lane % 8 + (lane / 16) * 8, k_col = (lane / 8 % 2) * 8;
  const int v_row = lane % 8 + (lane / 8 % 2) * 8, v_col = (lane / 16) * 8;

  unsigned qf[C::kQInRegs ? C::kKSteps : 1][4];
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const int pos0 = q_off + row0;        // and their positions
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[C::kOTiles][4];
#pragma unroll
  for (int n = 0; n < C::kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int pair = lo; pair < hi; pair += 2) {
    // this pair has landed for every thread, and every warp is done with
    // the last pair (and with Q's staging), whose stages the next fills
    attn::cp_async_wait<0>();
    __syncthreads();
    if constexpr (C::kQInRegs) {
      if (pair == lo) {
#pragma unroll
        for (int s = 0; s < C::kKSteps; ++s)
          ldmatrix_x4(qf[s], sQ + a_row * kStride + s * 16 + a_col);
        __syncthreads();
      }
    }
    if (pair + 2 < hi) load_pair(pair + 2);
    const int kt = pair + half;
    if (kt >= hi) continue;  // an odd count leaves the second half idle
    const int stage = (kt - lo) % kStages;
    const bf16* tK = sK + stage * C::kTile;
    const bf16* tV = sV + stage * C::kTile;

    // S = Q K^T for this warp's 16 rows and the tile's keys
    float s[C::kSTiles][4];
#pragma unroll
    for (int n = 0; n < C::kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < C::kKSteps; ++d) {
      unsigned a[4];
      if constexpr (C::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[d][i];
      } else {
        ldmatrix_x4(a, sQ + a_row * kStride + d * 16 + a_col);
      }
#pragma unroll
      for (int n = 0; n < C::kSTiles; n += 2) {
        unsigned bk[4];
        ldmatrix_x4(bk, tK + (n * 8 + k_row) * kStride + d * 16 + k_col);
        mma(s[n], a, bk[0], bk[1]);
        mma(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap and mask in log2 units; keys past Sk get -inf, which
    // keeps them out of the row max and gives them p = 0 exactly
    const int k0 = kt * kBK;
    const int p0 = q_off + q0;  // the tile's first query position
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > p0) ||
                      (window > 0 && p0 + kBQ - 1 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < C::kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.f
                      ? attn::apply_softcap(s[n][e] * scale, softcap) * kLog2e
                      : s[n][e] * scale_log2;
        if (edge) {
          const int qpos = pos0 + (e / 2) * 8;
          const int kpos = k0 + n * 8 + 2 * t + e % 2;
          const bool live = (!causal || kpos <= qpos) &&
                            (window <= 0 || qpos - kpos < window);
          x = kpos >= Sk ? -INFINITY : live ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < C::kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int n = 0; n < C::kOTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // O += P V, P as three bf16 terms; score n-tiles 2j, 2j + 1 are the A
    // fragment of keys 16 j .. 16 j + 15
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      unsigned ph[4], pm[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3(s[2 * j + i / 2][i % 2 * 2], s[2 * j + i / 2][i % 2 * 2 + 1],
               ph[i], pm[i], pl[i]);
#pragma unroll
      for (int n = 0; n < C::kOTiles; n += 2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, tV + (j * 16 + v_row) * kStride + n * 8 + v_col);
        mma(acc[n], pl, bv[0], bv[1]);
        mma(acc[n], pm, bv[0], bv[1]);
        mma(acc[n], ph, bv[0], bv[1]);
        mma(acc[n + 1], pl, bv[2], bv[3]);
        mma(acc[n + 1], pm, bv[2], bv[3]);
        mma(acc[n + 1], ph, bv[2], bv[3]);
      }
    }
  }
  attn::cp_async_wait<0>();  // no copy outlives the block

  // the second half's state goes through shared memory to the thread of
  // the first half that holds the same rows and columns, which merges it
  // as a later tile of the online softmax would be merged, and writes o
  float* xch = reinterpret_cast<float*>(smem4) + threadIdx.x % kHalf;
  __syncthreads();  // every warp is done with the rings
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xch[r * kHalf] = m[r];
      xch[(2 + r) * kHalf] = l[r];
    }
#pragma unroll
    for (int n = 0; n < C::kOTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 + 4 * n + e) * kHalf] = acc[n][e];
  }
  __syncthreads();
  if (half == 1) return;
  float f[2][2];  // weights of the first and second half, by row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xch[r * kHalf];
    const float m_new = fmaxf(m[r], m1);
    f[r][0] = exp2f(m[r] - m_new);
    f[r][1] = exp2f(m1 - m_new);
    l[r] = l[r] * f[r][0] + xch[(2 + r) * kHalf] * f[r][1];
  }
#pragma unroll
  for (int n = 0; n < C::kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = acc[n][e] * f[e / 2][0] +
                  xch[(4 + 4 * n + e) * kHalf] * f[e / 2][1];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float denom = fmaxf(quad_sum(l[r]), attn::kMinDenominator);
    if (row >= Sq) continue;
    bf16* dst = ob + row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < C::kOTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
          __fdividef(acc[n][2 * r], denom),
          __fdividef(acc[n][2 * r + 1], denom));
  }
}

}  // namespace tc

// The shape of one call: B rows, H query heads over K KV heads, Sq
// queries at positions q_off .. q_off + Sq - 1 of the Sk keys.
struct Dims {
  int B, H, K, Sq, Sk, q_off;
};

// Each kernel's grid; flash_attention_geometry reports it with the block
// size and the dynamic shared memory, for the port's Python mirror.
inline dim3 simt_grid(const Dims& d) {
  return dim3((d.Sq + simt::kBQ - 1) / simt::kBQ, d.H, d.B);
}

inline dim3 tc_grid(const Dims& d) {
  return dim3(d.H, (d.Sq + tc::kBQ - 1) / tc::kBQ, d.B);
}

template <typename T, int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                        const Dims& d, Strides qs, Strides ks, Strides vs,
                        Strides os, float scale, int causal, int window,
                        float softcap, cudaStream_t stream) {
  auto kernel = simt::flash_attention_kernel<T, HD>;
  constexpr size_t smem = simt::smem_bytes<HD>();
  static unsigned long long opted_in = 0;
  const cudaError_t err = attn::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<simt_grid(d), simt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), d.H / d.K, d.Sq, d.Sk,
      d.q_off, qs, ks, vs, os, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const Dims& d, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, int causal, int window,
                      float softcap, cudaStream_t stream) {
  auto kernel = tc::flash_tc_kernel<HD>;
  constexpr size_t smem = tc::Cfg<HD>::kSmem;
  static unsigned long long opted_in = 0;
  const cudaError_t err = attn::opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<tc_grid(d), tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), d.H / d.K,
      d.Sq, d.Sk, d.q_off, qs, ks, vs, os, scale, causal, window, softcap);
  return cudaGetLastError();
}

// bf16 on the tensor cores, float32 on the CUDA cores, by head_dim
template <int HD>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v,
                   void* o, const Dims& d, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  if (is_bf16)
    return launch_tc<HD>(q, k, v, o, d, qs, ks, vs, os, scale, causal,
                         window, softcap, stream);
  return launch_simt<float, HD>(q, k, v, o, d, qs, ks, vs, os, scale,
                                causal, window, softcap, stream);
}

template <int HD>
int geometry(int is_bf16, const Dims& d, long long* out) {
  const dim3 g = is_bf16 ? tc_grid(d) : simt_grid(d);
  out[0] = g.x;
  out[1] = g.y;
  out[2] = g.z;
  out[3] = is_bf16 ? tc::kThreads : simt::kThreads;
  out[4] = static_cast<long long>(is_bf16 ? tc::Cfg<HD>::kSmem
                                          : simt::smem_bytes<HD>());
  return 1;
}

}  // namespace

// q (B,H,Sq,hd), k and v (B,K,Sk,hd), o (B,H,Sq,hd), each given by its
// (b, head, s) strides in elements with hd contiguous; query row i sits at
// position q_offset + i of the keys' sequence (the causal mask and the
// window read k_pos <= q_offset + i). is_bf16 selects bf16 for all four
// (rows 16-byte aligned), else float32. hd must be 64, 80, 128 or 256.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int K, int Sq, int Sk, int q_offset, int hd, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale, int causal,
    int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || Sk <= 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const Dims d{B, H, K, Sq, Sk, q_offset};
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(is_bf16, q, k, v, o, d, qs, ks, vs, os, scale,
                        causal, window, softcap, s);
    case 80:
      return launch<80>(is_bf16, q, k, v, o, d, qs, ks, vs, os, scale,
                        causal, window, softcap, s);
    case 128:
      return launch<128>(is_bf16, q, k, v, o, d, qs, ks, vs, os, scale,
                         causal, window, softcap, s);
    case 256:
      return launch<256>(is_bf16, q, k, v, o, d, qs, ks, vs, os, scale,
                         causal, window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The one launch of a call with B rows, H query heads and Sq queries:
// out[0..2] the grid, out[3] threads a block, out[4] bytes of dynamic
// shared memory a block. Returns the number of launches (1), or -1 for a
// head_dim the kernels were not compiled for.
extern "C" int flash_attention_geometry(int is_bf16, int B, int H, int Sq,
                                        int hd, long long* out) {
  const Dims d{B, H, 1, Sq, Sq, 0};
  switch (hd) {
    case 64:
      return geometry<64>(is_bf16, d, out);
    case 80:
      return geometry<80>(is_bf16, d, out);
    case 128:
      return geometry<128>(is_bf16, d, out);
    case 256:
      return geometry<256>(is_bf16, d, out);
    default:
      return -1;
  }
}
