// One chunk of the Mamba2 SSD (state-space duality) scan for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk
// (body _kernel). Per (batch, head) slice over one chunk of L positions,
// state size N and head dim P, float32 in and out:
//     acs   = cumsum(da)                                          (da <= 0)
//     y     = ((C B^T) o exp(acs_l - acs_s) [s <= l]) X + (C h^T) o exp(acs)
//     h_new = h exp(acs_{L-1}) + X^T (B o exp(acs_{L-1} - acs))
// for any L >= 1. Entries above the diagonal are never computed, so every
// exponent is <= 0: a long chunk's decay underflows to exactly 0, as the
// reference's does, and never overflows or turns into NaN. Within 64 keys
// the weight is exp(acs_l - acs_s) itself; across them it is a product of
// decays each <= 1, exp(acs_l - acs_e) exp(acs_e - acs_s), never
// exp(acs_l) exp(-acs_s): at full width acs reaches about -70, and
// exp(-acs_s) would overflow.
//
// Grid. The TPU kernel did a whole (L, L) tile per slice in one grid step;
// at L = 256 the float32 decay tile alone is 256 KB, more than a block's
// 227 KB of shared memory. Here each slice has R = ceil(L/64) row blocks
// and one state block, R + 1 blocks of 8 warps:
//   * the state block walks the chunk's 32-key tiles once and carries the
//     state at the end of each 64-key row block,
//         S_{j+1} = S_j exp(acs_{e'} - acs_e) + X_j^T (B_j o exp(acs_{e'} - acs)),
//     e, e' the last keys of row blocks j - 1 and j, S_0 = h_prev; it
//     publishes S_1 .. S_{R-1} and writes S_R as h_new. This is Mamba2's
//     own chunked form, with the chunk cut into 64-key sub-chunks.
//   * row block j owns positions 64 j .. 64 j + 63: the diagonal part over
//     its own 64 keys, ((C B^T) o exp(acs_l - acs_s) [s <= l]) X, then,
//     once the state block has published S_j, the state's part
//     (C S_j^T) o exp(acs_l - acs_{64j-1}). Each exponent is <= 0: every
//     factor is one decay, never a quotient of two.
// A row block reads only its own 64 keys and the state, where a block that
// walked every key up to its diagonal would do the state walk's work again
// (and two products per key tile instead of one). The cost is a dependency
// between blocks of one launch: blocks take their roles from a ticket (an
// atomic counter), state blocks first, so a waiting row block only ever
// waits for a block that is already running; flags in a workspace pass the
// states, and every launch leaves them zero. Every block computes the
// prefix sum of da itself (L floats): cheaper than a pass that writes acs
// out. B and C are read in place, so the single B/C group of a batch row
// serves all H of its heads (slice bh reads group bh / H); X, da and y go
// through strides, so the model's (batch, L, head, P) activations need no
// copy.
//
// Bound. At the serving shape (80 slices, L = 256, N = P = 64) the
// lower-triangle work is L(L+1)/2 (2N + 2P) + 4 L N P = 12.6 MFLOP per
// slice, 1.0 GFLOP in all: 15 us at 67 TFLOP/s of float32 on the CUDA
// cores, 6 us as three TF32 products at 495 TFLOP/s; the state passes do
// about half of that work. The bytes (B/C shared) are about 13 MB: 4 us at
// 3.35 TB/s. So the operations bound it, and this kernel runs them on the
// tensor cores. What holds it back is not that bound but latency: the
// state block's walk over the tiles is serial, and a row block cannot
// finish before its state is published (PERF.md).
//
// Tensor cores, 3xTF32. All four products (C B^T, S X, C S^T, X^T (B o w))
// are mma.sync.m16n8k8 with TF32 operands and float32 accumulators. One
// TF32 rounding of the operands (10-bit mantissa) misses the float32 bar
// (kernels/ref.py::ssd_tolerance) by about 30x at the serving shape, so
// every operand x is split into big = rna(x) and small = rna(x - big)
// (rna: round to nearest, ties away from zero, as cvt.rna.tf32.f32 does;
// done here on the bits, by adding half of the last kept bit and clearing
// the 13 dropped ones), and each product is three MMAs, small.big +
// big.small + big.big (tests/test_torch_ssd_designs.py emulates this on
// the CPU and holds it to the bar). Key tiles are split once per block
// into big and small planes in shared memory, read by ldmatrix; C and S
// are split as their fragments are read. The scores are weighted in
// float32 and split after weighting. They never leave registers: a warp's
// score accumulators become the A fragments of S X directly, by numbering
// the eight keys of an MMA's k-step so that k-index t is key 2t and
// k-index t + 4 is key 2t + 1 (a sum over k does not care about the
// order), and the transposed X planes hold the keys so permuted. X^T
// (B o w) uses the same numbering of its keys.
//
// Loads. Key tiles of B and X go through a two-stage cp.async ring of
// 16-byte pieces: tile j + 2 is in flight while tile j is computed (the
// raw stage is free once it is split). Rows past L and the k-tail of N up
// to a multiple of 8 are zero-filled by the copy's src-size operand. The
// row strides are 4 (mod 8) floats, so that fragment loads fall on
// distinct banks.
//
// The diagonal. A warp computes only the 8-key groups of a tile that lie
// at or before its last row, so the parts of the diagonal tiles wholly
// above the diagonal cost no MMA; the rest of a diagonal tile is masked.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; strides are in elements. Returns cudaGetLastError()
// so that a refused launch reaches the caller. ssd_chunk_smem_bytes gives
// the shared memory a launch needs, for the wrapper's check, and
// ssd_chunk_state_floats / ssd_chunk_flag_words the workspaces.

#include <cuda_runtime.h>

#include "attention_common.cuh"  // cp.async helpers

namespace {

constexpr int kRows = 64;              // chunk positions (rows of y) per block
constexpr int kKeys = 32;              // key positions per tile
constexpr int kWarps = 8;              // 4 row groups x 2 key halves
constexpr int kThreads = 32 * kWarps;  // 256
constexpr int kMinBlocks = 2;          // blocks an SM holds (shared memory)
constexpr int kXT = kKeys + 4;         // row stride of the transposed planes

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
  float* states;       // (BH, R, P, N): the state at each row block's start
  unsigned* flags;     // 2 counters, then (BH, R) flags; zero between calls
  int BH;
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

// Shared memory, in floats; every offset is a multiple of 4 (16 bytes).
struct Layout {
  int ns;      // row stride of C, the state and B: N up to 8, + 4
  int xs;      // row stride of raw X tiles: P + 4
  int scan;    // the warps' run totals of the prefix sum (8)
  int role;    // the block's ticket (1 word)
  int acs;     // acs, zero past L up to a whole row block
  int w;       // state block: exp(acs_e - acs_s), e the end of s's 64-key
               // row block, zero past L
  int c;       // row block: its 64 rows of C
  int state;   // h_prev, then the state at the block's first row (P x ns)
  int planes;  // a key tile's split planes: B's (or (B o w)^T's) and X^T's;
               // at the end, the halves' merge of y
  int ring;    // two raw key tiles (B, X) as cp.async lands them
  int stage;   // floats per stage
  int total;
};

__host__ __device__ inline Layout layout(int L, int N, int P) {
  Layout s;
  const int lp = round_up(L, kRows);
  const int n8 = round_up(N, 8);
  s.ns = n8 + 4;
  s.xs = P + 4;
  s.scan = 0;
  s.role = 8;
  s.acs = 12;
  s.w = s.acs + lp;
  s.c = s.w + lp;
  s.state = s.c + kRows * s.ns;
  s.planes = s.state + P * s.ns;
  // B planes or (B o w)^T planes, then X^T planes; the merge takes four
  // warps' accumulators of up to 32 floats a lane
  s.ring = s.planes + max_int(max_int(2 * kKeys * s.ns, 2 * n8 * kXT) +
                                  2 * P * kXT,
                              4 * 32 * 32);
  s.stage = kKeys * (s.ns + s.xs);
  s.total = s.ring + 2 * s.stage;
  return s;
}

// Rows row0 .. row0+rows-1 of a matrix whose first `width` columns are
// data (a multiple of 4) into a shared tile of `cols` columns (a multiple
// of 4) and row stride `stride`, by 16-byte cp.async; rows at or past
// `valid` and columns past `width` are zero-filled, not read.
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src,
                                          long long src_stride, int row0,
                                          int rows, int valid, int width,
                                          int cols) {
  const int pieces = cols / 4;
#pragma unroll 1
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int r = i / pieces;
    const int col = (i - r * pieces) * 4;
    const bool full = row0 + r < valid && col < width;
    attn::cp_async16(dst + r * stride + col,
                     full ? src + (row0 + r) * src_stride + col : src, full);
  }
}

// s_acs[l] = da[0] + ... + da[l] for l < L, 0 from L to the end of the
// last row block: each thread sums a run of consecutive positions, then
// the runs' totals are scanned across the block (shuffles within a warp,
// the warp totals through s_scan). Ends with a __syncthreads.
__device__ void prefix_sum(const float* da, long long stride, int L,
                           float* s_acs, float* s_scan) {
  const int per = (L + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, L);
  const int hi = min(lo + per, L);
  float run = 0.f;
#pragma unroll 1
  for (int l = lo; l < hi; ++l) {
    run += da[l * stride];
    s_acs[l] = run;
  }
#pragma unroll 1
  for (int l = L + threadIdx.x; l < round_up(L, kRows); l += kThreads)
    s_acs[l] = 0.f;
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
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) base += s_scan[w];
#pragma unroll 1
  for (int l = lo; l < hi; ++l) s_acs[l] += base;
  __syncthreads();
}

// x rounded to TF32 (10-bit mantissa), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite x, in the register's float32 bits.
__device__ __forceinline__ unsigned rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32, to about 2^-22 relative; x - big is exact.
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// A rows x cols tile (cols a multiple of 4, row stride `stride`) split
// into big and small planes of the same layout; big may be the tile itself.
__device__ __forceinline__ void split_rows(const float* src, float* big,
                                           float* small, int rows, int cols,
                                           int stride) {
  const int vecs = cols / 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int off = r * stride + (i - r * vecs) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + off);
    unsigned hi[4], lo[4];
    split(v.x, hi[0], lo[0]);
    split(v.y, hi[1], lo[1]);
    split(v.z, hi[2], lo[2]);
    split(v.w, hi[3], lo[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(hi[0], hi[1], hi[2],
                                                      hi[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(lo[0], lo[1], lo[2],
                                                        lo[3]);
  }
}

// A raw tile of kKeys keys x `cols` columns (row stride `stride`), times
// w[key] when WEIGHTED, transposed and split into planes of `cols` rows x
// kKeys keys (row stride kXT). Within each 8 keys the plane's column for
// key j is j / 2 + 4 (j % 2): the MMAs' k-index t stands for key 2t and
// t + 4 for key 2t + 1, so that a score accumulator (keys 2t, 2t + 1 in
// lane t) is already the A fragment that multiplies these columns. A lane
// moves one column's 8 keys of each 8-key group, its warp 8 columns x 4
// keys at a time: conflict-free both ways. All of a lane's loads go out
// before its first split.
template <bool WEIGHTED>
__device__ __forceinline__ void split_transposed(const float* raw, int stride,
                                                 const float* w, float* big,
                                                 float* small, int cols) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int col = 8 * warp + lane / 4; col < cols; col += 8 * kWarps) {
    float v[kKeys / 4];
#pragma unroll
    for (int part = 0; part < kKeys / 4; ++part) {  // (key group, odd keys)
      const int key = 8 * (part / 2) + 2 * (lane % 4) + part % 2;
      v[part] = raw[key * stride + col];
      if (WEIGHTED) v[part] *= w[key];
    }
#pragma unroll
    for (int part = 0; part < kKeys / 4; ++part) {
      unsigned hi, lo;
      split(v[part], hi, lo);
      const int at = col * kXT + 8 * (part / 2) + lane % 4 + 4 * (part % 2);
      big[at] = __uint_as_float(hi);
      small[at] = __uint_as_float(lo);
    }
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 4 TF32 matrices by ldmatrix (as 8 x 8 b16: lane l receives word
// l % 4 of row l / 4); lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment of m16n8k8 (rows row0 .. +15, k columns col .. col+7 of a
// row-major plane): a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4), lane = 4 g + t.
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4], const float* plane,
                                       int stride, int row0, int col) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, plane + (row0 + lane % 8 + 8 * (lane / 8 % 2)) * stride + col +
                 4 * (lane / 16));
}

// B fragments of two n-tiles (n = rows row0 .. +7 and +8 .. +15 of a plane
// whose rows are n and columns k): b0 of the first, b1 of the second, each
// (k t, n g) and (k t + 4, n g).
__device__ __forceinline__ void ldsm_b2(unsigned (&b0)[2], unsigned (&b1)[2],
                                        const float* plane, int stride,
                                        int row0, int col) {
  const int lane = threadIdx.x % 32;
  unsigned r[4];
  ldsm_x4(r, plane + (row0 + lane % 8 + 8 * (lane / 16)) * stride + col +
                 4 * (lane / 8 % 2));
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate; the
// accumulator d[0], d[1] is (row g, cols 2t, 2t + 1), d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] for the first N of J column tiles, in 3xTF32: the
// small.big terms of every tile, then big.small, then big.big, so that
// the three MMAs into one accumulator lie N MMAs apart.
template <int N, int J>
__device__ __forceinline__ void mma3(float (&d)[J][4], const unsigned (&ab)[4],
                                     const unsigned (&as)[4],
                                     const unsigned (&bb)[J][2],
                                     const unsigned (&bs)[J][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ab, bb[j]);
}

// The A fragment of rows g, g + 8 and columns t, t + 4 of a row-major
// shared tile whose row 0, column 0 is at p, split.
__device__ __forceinline__ void load_a(unsigned (&big)[4],
                                       unsigned (&small)[4], const float* p,
                                       int stride, int g, int t) {
  split(p[g * stride + t], big[0], small[0]);
  split(p[(g + 8) * stride + t], big[1], small[1]);
  split(p[g * stride + t + 4], big[2], small[2]);
  split(p[(g + 8) * stride + t + 4], big[3], small[3]);
}

// X^T (B o w) for 8 keys of a stretch: column tiles i .. i + N - 1 of the
// warp's J (N even).
template <int N, int J>
__device__ __forceinline__ void state_mma(float (&acc)[J][4], int i,
                                          const float* xt_big,
                                          const float* xt_small,
                                          const float* bt_big,
                                          const float* bt_small, int m0,
                                          int n0, int col) {
  unsigned ab[4], as[4], bb[N][2], bs[N][2];
  ldsm_a(ab, xt_big, kXT, m0, col);
  ldsm_a(as, xt_small, kXT, m0, col);
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    ldsm_b2(bb[j], bb[j + 1], bt_big, kXT, n0 + 8 * (i + j), col);
    ldsm_b2(bs[j], bs[j + 1], bt_small, kXT, n0 + 8 * (i + j), col);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[i + j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[i + j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(acc[i + j], ab, bb[j]);
}

// Acquire and release flags between blocks of one launch (device scope).
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One block of the grid, of one of two roles.
//
// The state block of a slice walks every key tile and keeps the state at
// the end of each 64-key row block,
//     S_{j+1} = S_j exp(acs_{e'} - acs_e) + X_j^T (B_j o exp(acs_{e'} - acs)),
// e and e' the last keys of row blocks j - 1 and j (S_0 = h_prev, acs_{-1}
// = 0); it publishes S_1 .. S_{R-1} to the row blocks and writes S_R as
// h_new. Row block j computes y for chunk positions q0 = 64 j .. q0 + 63
// from S_j (waiting for it to be published) and its own 64 keys:
//     y = (C S_j^T) o exp(acs_l - acs_{q0-1}) + ((C B^T) o exp(acs_l - acs_s)) X
// with the second part for s <= l only. Every exponent is <= 0.
//
// Warps: in the state walk, the eight warps split S: warp w takes row tile
// w % (P/16) and its share of a 64-column stretch's column tiles, over all
// keys of each tile. For y, warp w owns rows q0 + 16 (w % 4) .. + 15 and
// the keys 16 (w / 4) .. + 15 of each tile; the two halves' sums meet in
// shared memory at the end. A row block computes its diagonal part first
// and waits for S_j only then.
template <int P>
__device__ void chunk_block(const Args& a, int q0, bool state_only,
                            long long bh, float* smem, const Layout& s) {
  constexpr int kPT = P / 8;    // 8-column tiles of y
  constexpr int kMT = P / 16;   // row tiles of S
  constexpr int kNG = kWarps / kMT;  // warps sharing a row tile of S
  // column tiles of S a warp holds a stretch, in pairs (at P = 16 half
  // of the warps hold none)
  constexpr int kNT = 8 / kNG < 2 ? 2 : 8 / kNG;
  static_assert(kMT * kNG == kWarps, "P is 16, 32 or 64");
  const int L = a.L, N = a.N, NS = s.ns, XS = s.xs, N8 = NS - 4;
  const int R = (L + kRows - 1) / kRows;  // row blocks of the slice
  const int grp = static_cast<int>(bh / a.H), hd = static_cast<int>(bh % a.H);
  float* s_acs = smem + s.acs;
  float* s_w = smem + s.w;
  float* sC = smem + s.c;
  float* sS = smem + s.state;
  float* b_big = smem + s.planes;  // B's planes, or (B o w)^T's
  float* b_small = b_big + max_int(kKeys * NS, N8 * kXT);
  float* xt_big = b_small + max_int(kKeys * NS, N8 * kXT);
  float* xt_small = xt_big + P * kXT;
  float* ring = smem + s.ring;
  const float* b = a.b + grp * a.b_sg;
  const float* x = a.x + grp * a.x_sb + hd * a.x_sh;
  const float* hp = a.h_prev + bh * P * N;
  float* states = a.states + bh * R * P * N;
  unsigned* flags = a.flags + 2 + bh * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int half = warp / 4, w4 = warp % 4;
  const int mt = warp % kMT, ng = warp / kMT;
  const int j_row = q0 / kRows;

  const int ts = state_only ? (L + kKeys - 1) / kKeys : 0;  // state tiles
  const int stretches = (N8 + 63) / 64;
  const int s_steps = stretches * ts;  // (stretch, tile) pairs
  // the row block's own key tiles: up to the diagonal, none past L
  const int steps = state_only
                        ? s_steps
                        : min(q0 + kRows, round_up(L, kKeys)) / kKeys -
                              q0 / kKeys;
  // step i loads the key tile of step i into ring stage i % 2, as one
  // cp.async group (empty past the last step)
  auto load_step = [&](int step) {
    if (step < steps) {
      float* stage = ring + step % 2 * s.stage;
      const int k0 = state_only ? step % ts * kKeys : q0 + step * kKeys;
      load_tile(stage, NS, b, a.b_sl, k0, kKeys, L, N, N8);
      load_tile(stage + kKeys * NS, XS, x, a.x_sl, k0, kKeys, L, P, P);
    }
    attn::cp_async_commit();
  };

  // every load of the prologue at once: C's rows and the incoming state
  // (h_prev, for the state block and row block 0), then the first two key
  // tiles, while the prefix sum reads da
  if (!state_only)
    load_tile(sC, NS, a.c + grp * a.c_sg, a.c_sl, q0, kRows, L, N, N8);
  if (j_row == 0) load_tile(sS, NS, hp, N, 0, P, P, N, N8);
  attn::cp_async_commit();
  load_step(0);
  load_step(1);
  prefix_sum(a.da + grp * a.da_sb + hd * a.da_sh, a.da_sl, L, s_acs,
             smem + s.scan);
  if (state_only) {
#pragma unroll 1
    for (int k = threadIdx.x; k < ts * kKeys; k += kThreads)
      s_w[k] = k < L ? expf(s_acs[min(k / kRows * kRows + kRows, L) - 1] -
                            s_acs[k])
                     : 0.f;
  }
  const float acs_e = q0 > 0 ? s_acs[q0 - 1] : 0.f;  // row block: e = q0 - 1
  const int r0 = 16 * w4;        // the warp's first row in the block
  const int l0 = q0 + r0;        // ... in the chunk
  const bool active = !state_only && l0 < L;  // rows past L: not computed
  const int l_last = min(l0 + 15, L - 1);
  const int la = l0 + g, lb = la + 8;   // this lane's two rows
  const float acs_a = s_acs[min(la, L - 1)], acs_b = s_acs[min(lb, L - 1)];
  const float* cw = sC + r0 * NS;
  float* merge = smem + s.planes + lane;

  float accs[kNT][4];  // the state
  float acc[kPT][4];   // y
#pragma unroll
  for (int i = 0; i < kPT; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.f;
  int publish = 0;     // state block: the row block whose S_j is written
  for (int step = 0; step < steps; ++step) {
    attn::cp_async_wait<1>();
    // the step's tile has landed for every thread, and every warp is done
    // with the planes, the merge and the state
    __syncthreads();
    if (publish && threadIdx.x == 0) {
      // every thread's part of S_j was written before the barrier: the
      // release makes them visible to the reader of the flag
      add_release(flags + publish, 1u);
    }
    publish = 0;
    const float* raw = ring + step % 2 * s.stage;
    if (state_only) {
      // the state: X^T (B o w) over the tile
      const int tile = step % ts, n0 = step / ts * 64, k0 = tile * kKeys;
      split_transposed<true>(raw, NS, s_w + k0, b_big, b_small, N8);
      split_transposed<false>(raw + kKeys * NS, XS, nullptr, xt_big, xt_small, P);
      __syncthreads();  // the planes are there, and the raw stage is free
      load_step(step + 2);
      if (tile % 2 == 0) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) accs[j][v] = 0.f;
      }
      // the warp's column tiles in this stretch inside N8
      const int cols = min(kNT, max(min(8, (N8 - n0) / 8) - ng * kNT, 0));
      const int row = n0 + 8 * ng * kNT;
#pragma unroll
      for (int kg = 0; kg < kKeys / 8; ++kg) {
        const int col = 8 * kg;  // keys k0 + col .. + 7
        if (k0 + col >= L || cols == 0) continue;
        if (cols == kNT) {
          state_mma<kNT>(accs, 0, xt_big, xt_small, b_big, b_small, 16 * mt,
                         row, col);
        } else {  // a stretch narrower than 64 columns: pairs of tiles
#pragma unroll
          for (int i = 0; i < kNT; i += 2)
            if (i < cols)
              state_mma<2>(accs, i, xt_big, xt_small, b_big, b_small,
                           16 * mt, row, col);
        }
      }
      if (tile % 2 == 0 && tile < ts - 1) continue;
      // a row block's keys are done: S = S exp(acs_e' - acs_e) + the sum,
      // in place, then published (or written as h_new)
      const int jr = tile / 2;  // the row block whose keys these were
      const int e_new = min(jr * kRows + kRows, L) - 1;
      const float decay =
          expf(s_acs[e_new] - (jr > 0 ? s_acs[jr * kRows - 1] : 0.f));
      const bool last = jr == R - 1;
      float* out = last ? a.h_new + bh * P * N : states + (jr + 1) * P * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + 8 * (ng * kNT + j) + 2 * t;
        // N is a multiple of 4: so is n + 1 < N
        if (j >= cols || n >= N) continue;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int p = 16 * mt + g + 8 * hi;
          float2* sp = reinterpret_cast<float2*>(sS + p * NS + n);
          const float2 h = *sp;
          const float2 v = make_float2(fmaf(h.x, decay, accs[j][2 * hi]),
                                       fmaf(h.y, decay, accs[j][2 * hi + 1]));
          *sp = v;
          *reinterpret_cast<float2*>(out + p * N + n) = v;
        }
      }
      if (!last) publish = jr + 1;  // after the next barrier
      continue;
    }

    // y: the block's own key tiles
    split_rows(raw, b_big, b_small, kKeys, N8, NS);
    split_transposed<false>(raw + kKeys * NS, XS, nullptr, xt_big, xt_small, P);
    __syncthreads();  // the planes are there, and the raw stage is free
    load_step(step + 2);
    const int kh = q0 + step * kKeys + 16 * half;  // the warp's first key
    // 8-key groups of the warp's 16 at or before its last row
    const int groups = min(2, (l_last - kh + 8) / 8);
    if (!active || groups <= 0) continue;
    // C B^T: n-tile j holds keys kh + 8j .. + 7
    float sc[2][4] = {};
    for (int k = 0; k < N8; k += 8) {
      unsigned ab[4], as[4], bb[2][2], bs[2][2];
      load_a(ab, as, cw + k, NS, g, t);
      ldsm_b2(bb[0], bb[1], b_big, NS, 16 * half, k);
      ldsm_b2(bs[0], bs[1], b_small, NS, 16 * half, k);
      mma3<2>(sc, ab, as, bb, bs);
    }
    // weights exp(acs_l - acs_s) on and below the diagonal, 0 above it;
    // then S X: the score fragment of keys 2t, 2t + 1 is the A fragment
    // of k-indices t, t + 4, and X^T's planes hold the keys so permuted
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < groups) {
        const int key = kh + 8 * j + 2 * t;
        const float acs0 = s_acs[key], acs1 = s_acs[key + 1];
        const float w0a = key <= la && la < L ? expf(acs_a - acs0) : 0.f;
        const float w1a = key < la && la < L ? expf(acs_a - acs1) : 0.f;
        const float w0b = key <= lb && lb < L ? expf(acs_b - acs0) : 0.f;
        const float w1b = key < lb && lb < L ? expf(acs_b - acs1) : 0.f;
        unsigned ab[4], as[4], bb[kPT][2], bs[kPT][2];
        split(sc[j][0] * w0a, ab[0], as[0]);
        split(sc[j][2] * w0b, ab[1], as[1]);
        split(sc[j][1] * w1a, ab[2], as[2]);
        split(sc[j][3] * w1b, ab[3], as[3]);
        const int col = 16 * half + 8 * j;
#pragma unroll
        for (int i = 0; i < kPT; i += 2) {
          ldsm_b2(bb[i], bb[i + 1], xt_big, kXT, 8 * i, col);
          ldsm_b2(bs[i], bs[i + 1], xt_small, kXT, 8 * i, col);
        }
        mma3<kPT>(acc, ab, as, bb, bs);
      }
    }
  }
  attn::cp_async_wait<0>();  // no copy outlives the block
  if (state_only) return;

  // the incoming state's part, last, so that the diagonal part did not
  // wait for S_j: (C S_j^T) o exp(acs_l - acs_e), the halves taking
  // alternate 8-column steps of N
  if (j_row > 0) {
    // S_j, once the state block has published it (all its stretches)
    if (threadIdx.x == 0) {
      unsigned polls = 0;
      while (load_acquire(flags + j_row) < static_cast<unsigned>(stretches)) {
        __nanosleep(100);
        if (++polls == (1u << 24)) __trap();  // never published: fail
      }
      flags[j_row] = 0;  // its only reader: zero for the next launch
    }
    __syncthreads();
    const float* sj = states + j_row * P * N;
#pragma unroll 4
    for (int i = threadIdx.x; i < P * N8 / 4; i += kThreads) {
      const int p = i / (N8 / 4), n = (i - p * (N8 / 4)) * 4;
      attn::cp_async16(sS + p * NS + n, n < N ? sj + p * N + n : sj, n < N);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
  }
  if (active) {
    float off[kPT][4];
#pragma unroll
    for (int i = 0; i < kPT; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) off[i][v] = 0.f;
    for (int k = 8 * half; k < N8; k += 16) {
      unsigned ab[4], as[4], bb[kPT][2], bs[kPT][2];
      load_a(ab, as, cw + k, NS, g, t);
#pragma unroll
      for (int i = 0; i < kPT; ++i) {
        const float* sr = sS + (8 * i + g) * NS + k + t;
        split(sr[0], bb[i][0], bs[i][0]);
        split(sr[4], bb[i][1], bs[i][1]);
      }
      mma3<kPT>(off, ab, as, bb, bs);
    }
    const float ea = la < L ? expf(acs_a - acs_e) : 0.f;
    const float eb = lb < L ? expf(acs_b - acs_e) : 0.f;
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
      acc[i][0] = fmaf(off[i][0], ea, acc[i][0]);
      acc[i][1] = fmaf(off[i][1], ea, acc[i][1]);
      acc[i][2] = fmaf(off[i][2], eb, acc[i][2]);
      acc[i][3] = fmaf(off[i][3], eb, acc[i][3]);
    }
  }

  // the second half's sums of y to the first, lane-fastest so that neither
  // side has bank conflicts
  __syncthreads();  // the planes are done with: the merge takes them
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < kPT; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        merge[((w4 * kPT + i) * 4 + v) * 32] = acc[i][v];
  }
  __syncthreads();
  if (half == 1 || !active) return;
  float* y = a.y + grp * a.y_sb + hd * a.y_sh + 2 * t;
#pragma unroll
  for (int i = 0; i < kPT; ++i) {
    const float* m = merge + (w4 * kPT + i) * 4 * 32;
    if (la < L)
      *reinterpret_cast<float2*>(y + la * a.y_sl + 8 * i) =
          make_float2(acc[i][0] + m[0], acc[i][1] + m[32]);
    if (lb < L)
      *reinterpret_cast<float2*>(y + lb * a.y_sl + 8 * i) =
          make_float2(acc[i][2] + m[64], acc[i][3] + m[96]);
  }
}

// A block's role comes from a ticket taken when it starts, not from
// blockIdx: the first BH tickets are the slices' state blocks, then row
// block 0 of every slice, then row block 1, and so on. A row block waits
// only for its slice's state block, whose smaller ticket was taken by a
// block already running, so the waits cannot deadlock whatever order the
// blocks are scheduled in. The last block to finish zeroes the counters.
template <int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_chunk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout s = layout(a.L, a.N, P);
  unsigned* s_role = reinterpret_cast<unsigned*>(smem + s.role);
  if (threadIdx.x == 0) *s_role = atomicAdd(a.flags, 1u);
  __syncthreads();
  const unsigned ticket = *s_role;
  const bool state_only = ticket < static_cast<unsigned>(a.BH);
  const unsigned r = ticket - (state_only ? 0u : a.BH);
  chunk_block<P>(a, state_only ? 0 : r / a.BH * kRows, state_only,
                 r % a.BH, smem, s);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y;
    if (atomicAdd(a.flags + 1, 1u) == blocks - 1) {
      atomicExch(a.flags, 0u);
      atomicExch(a.flags + 1, 0u);
    }
  }
}

size_t smem_bytes(int L, int N, int P) {
  return sizeof(float) * static_cast<size_t>(layout(L, N, P).total);
}

// (slice, row block or the state block); ssd_chunk_geometry reports it
inline dim3 grid_of(int BH, int L) {
  return dim3(BH, (L + kRows - 1) / kRows + 1);
}

template <int P>
cudaError_t launch(const Args& a, int BH, cudaStream_t stream) {
  auto kernel = ssd_chunk_kernel<P>;
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
  kernel<<<grid_of(BH, a.L), kThreads, smem_bytes(a.L, a.N, P), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a launch at (L, N, P) needs.
extern "C" size_t ssd_chunk_smem_bytes(int L, int N, int P) {
  return smem_bytes(L, N, P);
}

// The one launch of a call of BH slices at (L, N, P): out[0..2] the grid,
// out[3] threads a block, out[4] bytes of dynamic shared memory a block.
// Returns the number of launches (1), or -1 for a P the kernel was not
// compiled for or an N it does not take.
extern "C" int ssd_chunk_geometry(int BH, int L, int N, int P,
                                  long long* out) {
  if ((P != 16 && P != 32 && P != 64) || N <= 0 || N % 4 != 0 || L <= 0)
    return -1;
  const dim3 g = grid_of(BH, L);
  out[0] = g.x;
  out[1] = g.y;
  out[2] = g.z;
  out[3] = kThreads;
  out[4] = static_cast<long long>(smem_bytes(L, N, P));
  return 1;
}

// Floats of the `states` workspace a launch of BH slices needs (any
// contents), and 32-bit words of `flags` (zero before the first launch;
// every launch leaves them zero).
extern "C" long long ssd_chunk_state_floats(int BH, int L, int N, int P) {
  return static_cast<long long>(BH) * ((L + kRows - 1) / kRows) * P * N;
}

extern "C" long long ssd_chunk_flag_words(int BH, int L) {
  return 2 + static_cast<long long>(BH) * ((L + kRows - 1) / kRows);
}

// BH slices; slice bh is (batch bh / H, head bh % H). c and b give their
// group's rows by (group, position) strides; x, da and y by (batch, head,
// position) strides, all in elements with the last axis contiguous (x, y:
// P; c, b: N; da: one value). h_prev and h_new are (BH, P, N) contiguous.
// P must be 16, 32 or 64 and N a multiple of 4; c, b and x rows must be
// 16-byte aligned. states and flags are the workspaces sized above; launches
// that share `flags` must not run at the same time.
extern "C" int ssd_chunk_forward(
    const float* c, const float* b, const float* x, const float* da,
    const float* h_prev, float* y, float* h_new, int BH, int H, int L, int N,
    int P, long long c_sg, long long c_sl, long long b_sg, long long b_sl,
    long long x_sb, long long x_sh, long long x_sl, long long da_sb,
    long long da_sh, long long da_sl, long long y_sb, long long y_sh,
    long long y_sl, float* states, unsigned* flags, void* stream) {
  if (BH <= 0) return cudaSuccess;
  if (H <= 0 || BH % H != 0 || L <= 0 || N <= 0 || N % 4 != 0)
    return cudaErrorInvalidValue;
  const Args a{c,    b,    x,    da,   h_prev, y,     h_new, H,     L,
               N,    c_sg, c_sl, b_sg, b_sl,   x_sb,  x_sh,  x_sl,  da_sb,
               da_sh, da_sl, y_sb, y_sh, y_sl, states, flags, BH};
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
