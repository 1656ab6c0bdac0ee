// One chunk of the Mamba2 SSD (state-space duality) scan for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk
// (body _kernel). Per (batch, head) slice over one chunk of L positions,
// state size N and head dim P, float32 in and out:
//     acs   = cumsum(da)                                          (da <= 0)
//     y     = ((C B^T) o exp(acs_l - acs_s) [s <= l]) X + (C h^T) o exp(acs)
//     h_new = h exp(acs_{L-1}) + X^T (B o exp(acs_{L-1} - acs))
// for any L >= 1. Entries above the diagonal are never computed, so the
// exponent is always <= 0: a long chunk's decay underflows to exactly 0,
// as the reference's does, and never overflows or turns into NaN.
//
// Design. The TPU kernel did a whole (L, L) tile per slice in one grid
// step; at L = 256 the float32 decay tile alone is 256 KB, more than a
// block's 227 KB of shared memory. Here the grid is (slice, 1 + L/64):
//   * each of the ceil(L/64) row blocks owns 64 positions of y. It keeps
//     its 64 rows of C in shared memory, first adds the incoming state's
//     part (C h^T) o exp(acs), then walks the 64-key tiles of B and X up to
//     the diagonal, as flash attention walks keys, with the weights
//     exp(acs_l - acs_s) where flash attention has a softmax. 16 x 16
//     threads each hold a 4 x 4 patch of the weighted scores and 4 rows x
//     P/16 columns of y in registers. The longest row blocks go first.
//   * one state block per slice computes h_new (P x N): it walks the same
//     key tiles once and accumulates X^T (B o w). A second launch would
//     read the same B and X again and wait for the first; as one more
//     block of the same grid it runs beside the row blocks.
// Every block computes the prefix sum of da itself (L floats, a run per
// thread and a scan of the runs across the block): it is cheaper than a
// pass that writes acs out and a second launch that reads it.
// B and C are read in place, so the single B/C group of a batch row serves
// all H of its heads (slice bh reads group bh / H): the reference repeated
// it H times in device memory. X, da and y are read and written through
// strides, so the model's (batch, L, head, P) activations need no copy.
//
// Bound. At the serving shape (80 slices, L = 256, N = P = 64) the
// lower-triangle work is L(L+1)/2 (2N + 2P) + 4 L N P = 12.6 MFLOP per
// slice, 1.0 GFLOP in all: 15 us at 67 TFLOP/s of float32 outside the
// tensor cores. The bytes (B/C shared) are about 13 MB: 4 us at 3.35 TB/s.
// So in float32 the operations bound it. This first kernel keeps to
// float32 FMAs on the CUDA cores, with no tensor cores (TF32 would lose the
// 3e-5 parity), no wgmma, TMA or overlap of loads with compute: those are
// later work.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// so that a refused launch reaches the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // chunk positions (rows of y) per block
constexpr int kBK = 64;              // key positions per tile
constexpr int kRG = 16;              // thread rows
constexpr int kCG = 16;              // thread columns
constexpr int kThreads = kRG * kCG;  // 256
constexpr int kTM = kBQ / kRG;       // rows per thread
constexpr int kTN = kBK / kCG;       // keys per thread
constexpr int kSStride = kBK + 4;    // weighted-score row stride
static_assert(kBQ == kBK, "load_rows loads 64-row tiles");

struct Args {
  const float* c;      // slice bh reads group bh / H: + g * c_sg + l * c_sl
  const float* b;
  const float* x;      // + (bh / H) * x_sb + (bh % H) * x_sh + l * x_sl
  const float* da;     // likewise, one value per position
  const float* h_prev; // (BH, P, N) contiguous
  float* y;            // like x
  float* h_new;        // (BH, P, N) contiguous
  int H, L, N;
  long long c_sg, c_sl, b_sg, b_sl;
  long long x_sb, x_sh, x_sl;
  long long da_sb, da_sh, da_sl;
  long long y_sb, y_sh, y_sl;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <int P>
constexpr size_t smem_floats(int L, int N) {
  return static_cast<size_t>(round4(L)) + 2 * kBQ * (N + 4) +
         kBK * (P + 4) + kBQ * kSStride;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows row0 .. row0+63 of a slice with W contiguous columns (W % 4 == 0)
// into a tile of row stride W + 4; rows at or past L are zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0, int L,
                                          int W) {
  const int vecs = W / 4;
  for (int idx = threadIdx.x; idx < kBK * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int col = (idx % vecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L) v = ld4(src + (row0 + r) * stride + col);
    *reinterpret_cast<float4*>(dst + r * (W + 4) + col) = v;
  }
}

// s_acs[l] = da[0] + ... + da[l] for l < L: each thread sums a run of
// consecutive positions, then the runs' totals are scanned across the
// block (shuffles within a warp, the 8 warp totals through s_warp).
__device__ void prefix_sum(const float* da, long long stride, int L,
                           float* s_acs, float* s_warp) {
  const int per = (L + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, L);
  const int hi = min(lo + per, L);
  float run = 0.f;
  for (int l = lo; l < hi; ++l) {
    run += da[l * stride];
    s_acs[l] = run;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) base = 0.f;
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  for (int l = lo; l < hi; ++l) s_acs[l] += base;
  __syncthreads();
}

// y for chunk positions q0 .. q0+63 of one slice.
template <int P>
__device__ void row_block(const Args& a, int q0, long long bh, int g, int hd,
                          float* smem) {
  constexpr int kPC = P / kCG;  // columns of y per thread
  const int L = a.L, N = a.N, NS = N + 4;
  float* s_acs = smem;
  float* sC = s_acs + round4(L);
  float* sB = sC + kBQ * NS;
  float* sX = sB + kBK * NS;
  float* sS = sX + kBK * (P + 4);
  float* sH = sB;  // h_prev^T (N, P + 4), before the key loop reuses sB, sX
  const int rg = threadIdx.x / kCG;
  const int cg = threadIdx.x % kCG;

  prefix_sum(a.da + g * a.da_sb + hd * a.da_sh, a.da_sl, L, s_acs, sS);
  load_rows(sC, a.c + g * a.c_sg, a.c_sl, q0, L, N);
  const float* hp = a.h_prev + bh * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += kThreads)
    sH[(idx % N) * (P + 4) + idx / N] = hp[idx];
  __syncthreads();

  // the incoming state's part: (C h^T) o exp(acs)
  float acc[kTM][kPC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < kPC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[kTM], hv[kPC];
#pragma unroll
    for (int i = 0; i < kTM; ++i) cv[i] = sC[(rg + kRG * i) * NS + n];
#pragma unroll
    for (int c = 0; c < kPC; ++c) hv[c] = sH[n * (P + 4) + cg * kPC + c];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < kPC; ++c) acc[i][c] = fmaf(cv[i], hv[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int l = q0 + rg + kRG * i;
    const float e = l < L ? expf(s_acs[l]) : 0.f;
#pragma unroll
    for (int c = 0; c < kPC; ++c) acc[i][c] *= e;
  }

  // the chunk's own part, key tiles up to the diagonal
  const int q_last = min(q0 + kBQ, L) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += kBK) {
    __syncthreads();  // sH, and the last tile's sB, sX and sS, are done
    load_rows(sB, a.b + g * a.b_sg, a.b_sl, k0, L, N);
    load_rows(sX, a.x + g * a.x_sb + hd * a.x_sh, a.x_sl, k0, L, P);
    __syncthreads();

    // C B^T for this thread's patch: rows rg + 16 i, keys cg + 16 j
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < N; d += 4) {
      float4 cv[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) cv[i] = ld4(sC + (rg + kRG * i) * NS + d);
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = ld4(sB + (cg + kCG * j) * NS + d);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          float t = fmaf(cv[i].x, bv[j].x, s[i][j]);
          t = fmaf(cv[i].y, bv[j].y, t);
          t = fmaf(cv[i].z, bv[j].z, t);
          s[i][j] = fmaf(cv[i].w, bv[j].w, t);
        }
    }
    // weights exp(acs_l - acs_s) on and below the diagonal, 0 above it
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int l = q0 + rg + kRG * i;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int key = k0 + cg + kCG * j;
        sS[(rg + kRG * i) * kSStride + cg + kCG * j] =
            key <= l && l < L ? s[i][j] * expf(s_acs[l] - s_acs[key]) : 0.f;
      }
    }
    __syncthreads();

    // y += S X: rows rg + 16 i, columns cg * P/16 .. + P/16 - 1
#pragma unroll 2
    for (int k = 0; k < kBK; k += 4) {
      float4 sv[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        sv[i] = ld4(sS + (rg + kRG * i) * kSStride + k);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float xv[kPC];
#pragma unroll
        for (int c = 0; c < kPC; ++c)
          xv[c] = sX[(k + t) * (P + 4) + cg * kPC + c];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float w = t == 0 ? sv[i].x : t == 1 ? sv[i].y
                        : t == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int c = 0; c < kPC; ++c) acc[i][c] = fmaf(w, xv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int l = q0 + rg + kRG * i;
    if (l >= L) continue;
    float* yr = a.y + g * a.y_sb + hd * a.y_sh + l * a.y_sl + cg * kPC;
#pragma unroll
    for (int c = 0; c < kPC; ++c) yr[c] = acc[i][c];
  }
}

// h_new (P x N) of one slice: state rows rg + 16 i, columns n0 + cg + 16 j
// for each 64-column stretch n0 of N.
template <int P>
__device__ void state_block(const Args& a, long long bh, int g, int hd,
                            float* smem) {
  constexpr int kPR = P / kRG;  // state rows per thread
  const int L = a.L, N = a.N, NS = N + 4;
  float* s_acs = smem;
  float* sB = s_acs + round4(L) + kBQ * NS;
  float* sX = sB + kBK * NS;
  float* sW = sX + kBK * (P + 4);  // exp(acs_{L-1} - acs) of one key tile
  const int rg = threadIdx.x / kCG;
  const int cg = threadIdx.x % kCG;

  prefix_sum(a.da + g * a.da_sb + hd * a.da_sh, a.da_sl, L, s_acs, sW);
  const float last = s_acs[L - 1];
  const float decay = expf(last);
  const float* hp = a.h_prev + bh * P * N;
  float* hn = a.h_new + bh * P * N;

  for (int n0 = 0; n0 < N; n0 += 4 * kCG) {
    float acc[kPR][4];
#pragma unroll
    for (int i = 0; i < kPR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < L; k0 += kBK) {
      __syncthreads();  // the last tile's sB, sX and sW are done
      load_rows(sB, a.b + g * a.b_sg, a.b_sl, k0, L, N);
      load_rows(sX, a.x + g * a.x_sb + hd * a.x_sh, a.x_sl, k0, L, P);
      for (int k = threadIdx.x; k < kBK; k += kThreads)
        sW[k] = k0 + k < L ? expf(last - s_acs[k0 + k]) : 0.f;
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        const float w = sW[k];
        float xv[kPR], bv[4];
#pragma unroll
        for (int i = 0; i < kPR; ++i) xv[i] = sX[k * (P + 4) + rg + kRG * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + cg + kCG * j;
          bv[j] = n < N ? sB[k * NS + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kPR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPR; ++i) {
      const int p = rg + kRG * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + cg + kCG * j;
        if (n < N) hn[p * N + n] = fmaf(hp[p * N + n], decay, acc[i][j]);
      }
    }
  }
}

// blockIdx.x: the slice; blockIdx.y: 0 the state block, then the row
// blocks from the last (longest) to the first.
template <int P>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long bh = blockIdx.x;
  const int g = static_cast<int>(bh / a.H);
  const int hd = static_cast<int>(bh % a.H);
  if (blockIdx.y == 0)
    state_block<P>(a, bh, g, hd, smem);
  else
    row_block<P>(a, (gridDim.y - 1 - blockIdx.y) * kBQ, bh, g, hd, smem);
}

template <int P>
cudaError_t launch(const Args& a, int BH, cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<P>;
  const size_t smem = sizeof(float) * smem_floats<P>(a.L, a.N);
  // above 48 KB of shared memory a kernel must opt in: once per device, to
  // the device's limit
  static unsigned long long opted_in = 0;  // one bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!(opted_in >> device & 1ull)) {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return err;
    opted_in |= 1ull << device;
  }
  const dim3 grid(BH, (a.L + kBQ - 1) / kBQ + 1);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// BH slices; slice bh is (batch bh / H, head bh % H). c and b give their
// group's rows by (group, position) strides; x, da and y by (batch, head,
// position) strides, all in elements with the last axis contiguous (x, y:
// P; c, b: N; da: one value). h_prev and h_new are (BH, P, N) contiguous.
// P must be 16, 32 or 64 and N a multiple of 4; c, b and x rows must be
// 16-byte aligned.
extern "C" int ssd_chunk_forward(
    const float* c, const float* b, const float* x, const float* da,
    const float* h_prev, float* y, float* h_new, int BH, int H, int L, int N,
    int P, long long c_sg, long long c_sl, long long b_sg, long long b_sl,
    long long x_sb, long long x_sh, long long x_sl, long long da_sb,
    long long da_sh, long long da_sl, long long y_sb, long long y_sh,
    long long y_sl, void* stream) {
  if (BH <= 0) return cudaSuccess;
  if (H <= 0 || BH % H != 0 || L <= 0 || N <= 0 || N % 4 != 0)
    return cudaErrorInvalidValue;
  const Args a{c,    b,    x,    da,   h_prev, y,     h_new, H,     L,
               N,    c_sg, c_sl, b_sg, b_sl,   x_sb,  x_sh,  x_sl,  da_sb,
               da_sh, da_sl, y_sb, y_sh, y_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16:
      return launch<16>(a, BH, s);
    case 32:
      return launch<32>(a, BH, s);
    case 64:
      return launch<64>(a, BH, s);
    default:
      return cudaErrorInvalidValue;
  }
}
