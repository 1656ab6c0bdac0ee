// V-trace (IMPALA, Espeholt et al. 2018, §4.1) in one launch, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/vtrace.py::vtrace_scan
// (body _kernel) together with the elementwise math of its wrapper
// repro/kernels/ops.py::vtrace_from_importance_weights_kernel: rho/c
// clipping, the TD errors delta_t, the reverse recurrence
//     acc_t = delta_t + discount_t * c_t * acc_{t+1},   acc_T = 0,
// vs_t = values_t + acc_t, and the policy-gradient advantages
//     pg_t = min(rho_pg, rho_t) * (r_t + discount_t * vs_{t+1} - values_t).
// Arrays are row-major (T, B) float32, the bootstrap values (B,); any
// T >= 1 and B >= 1. Both outputs come from the same launch.
//
// What bounds it. 4 reads and 2 writes of (T, B) float32 plus the
// bootstrap: 61 KB at the learner's (80, 32), 18 ns at 3.35 TB/s, and 79 MB
// at (200, 16384), 23.5 us. At B <= 32 one block on one SM does all the
// work, so the time is a launch's latency plus that block's own: its chain
// of dependent steps, and the instructions its warps issue on the SM's
// four schedulers. At large B it is the bytes. The kernel this replaced
// walked t = T-1 .. 0 in one thread per column: T dependent rounds of
// loads, about 0.155 us a row on an H100, and only ceil(B / 128) blocks.
//
// Design: a chunked scan over T. acc_t is an affine function of acc_{t+1}
// (acc_t = delta_t + dc_t acc_{t+1}, dc_t = discount_t c_t), and affine
// maps compose, so a run of rows has one map acc_start = Bc + A acc_after
// with A = prod dc_t. A block owns 32 columns, one per lane, so each row a
// warp reads or writes is one 128-byte line. Its W warps each own a chunk
// of L consecutive rows:
//   1. loads: a thread issues all its chunk's loads (4 arrays x L rows,
//      plus values of the row after the chunk) into registers before any
//      arithmetic: one round of latency, not T. It then computes delta_t
//      and dc_t of its rows and composes its chunk's map (A, Bc), last row
//      first;
//   2. carries: the W maps of each column go to shared memory; after one
//      barrier each thread composes the maps of the chunks after its own,
//      from the last chunk back, to get its carry-in acc_e (0 after the
//      last row): fewer than W dependent FMAs;
//   3. outputs: it walks its L rows again from registers with the carry,
//      writing vs_t and pg_t, with vs at the row after the chunk taken as
//      values_e + acc_e.
// The dependent chain is one round of loads and about 2 L + W register
// steps. Where T > W L (at most 16 x 16 = 256 rows), the block walks
// segments of W L rows from the last, carrying acc across them, with one
// barrier per segment (the maps' shared memory alternates by segment).
// Once the chain is short, what is left at B = 32 is instructions: so a
// chunk that lies wholly below T takes a path with no row checks whose
// addresses advance by one row stride a row, and up to L = 8 delta_t and
// dc_t stay in registers for step 3 rather than being computed again.
// Rows past T take the identity map (A = 1, Bc = 0) and read values as
// the bootstrap, so a ragged end needs no other case. Every load is
// unconditional (rows and columns clamped into the arrays); columns past
// B store nothing. No atomics, and nothing passes between blocks: every
// output is a fixed sequence of float32 operations, so two launches, or
// CUDA-graph replays, give the same bits. Shared memory: 8 KB of maps,
// static (no opt-in above 48 KB is needed).
//
// Precision. The chunked order multiplies the dc_t of a chunk together
// before it meets the carry, where the serial order multiplies one at a
// time. With rho clipped at 1 (dc <= discount <= 1) both orders stay within
// float32 rounding of each other. Unclipped, dc can exceed 1 and A grows
// with L, and so does the rounding of Bc + A acc where the two nearly
// cancel: at (33, 200) chunks of 9 rows miss the 1e-5 bar where chunks of
// 4 meet it. So L is kept short at short T.
//
// The (W, L) rule lives in kernels/ops.py::vtrace_chunks, which the
// wrapper calls and passes in: L is the least of 1, 2, 4, 8, 16 with
// 16 L >= T (16 for T > 256), and W = ceil(T / L), at most 16. So at
// (80, 32) L = 8, W = 10; at (20, 32) L = 2, W = 10; at T = 33 L = 4,
// W = 9; at T = 200 L = 16, W = 13; T = 1000 walks 4 segments of 256
// rows. L is a template parameter so that a thread's 4 L inputs stay in
// registers (launch bounds of 512 threads allow 128 registers a thread;
// L = 16 takes 127 and spills none). tests/test_torch_vtrace_designs.py
// emulates this order of operations on the CPU and holds it to the
// kernel's bar.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers on
// the caller's stream; the function returns cudaGetLastError() so that a
// refused launch is reported to the caller.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;      // columns a block owns, one per lane
constexpr int kMaxWarps = 16;   // W at most
constexpr int kMaxRows = 16;    // L at most

struct Args {
  const float* log_rhos;
  const float* discounts;
  const float* rewards;
  const float* values;
  const float* bootstrap;
  float* vs;
  float* pg_advantages;
  int T, B;
  int segments;                 // ceil(T / (W L))
  float clip_rho, clip_c, clip_pg_rho;
};

// A chunk's L rows, held by one thread in registers: rho (log_rhos until
// the map's walk exponentiates them), discount, reward, value; and up to
// L = 8 also delta_t and dc_t, which at L = 16 would pass the 128
// registers a thread may hold and are computed again instead.
template <int L>
struct Rows {
  static constexpr bool kKeep = L <= 8;
  float rho[L], disc[L], rew[L], val[L];
  float delta[kKeep ? L : 1], dc[kKeep ? L : 1];
};

// delta_t and dc_t of one row, the same operations in both walks
__device__ __forceinline__ void row_terms(const Args& a, float rho,
                                          float discount, float reward,
                                          float value, float v_next,
                                          float& delta, float& dc) {
  delta = fminf(a.clip_rho, rho) * (reward + discount * v_next - value);
  dc = discount * fminf(a.clip_c, rho);
}

// 1a. Every load of the chunk at rows r0 .. r0 + L - 1 of column col,
// unconditional: with kFull all its rows lie below T; otherwise rows past
// T are read at row T - 1 and then take the bootstrap as their value.
// Returns values at row r0 + L, or the bootstrap where that is T or past.
template <int L, bool kFull>
__device__ __forceinline__ float load_rows(const Args& a, Rows<L>& x, int r0,
                                           int col, float boot) {
  if (kFull) {
    const size_t base = static_cast<size_t>(r0) * a.B + col;
    const float* lr = a.log_rhos + base;
    const float* dp = a.discounts + base;
    const float* rp = a.rewards + base;
    const float* vp = a.values + base;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      x.rho[i] = __ldg(lr);
      x.disc[i] = __ldg(dp);
      x.rew[i] = __ldg(rp);
      x.val[i] = __ldg(vp);
      lr += a.B;
      dp += a.B;
      rp += a.B;
      vp += a.B;
    }
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const size_t k = static_cast<size_t>(min(r0 + i, a.T - 1)) * a.B + col;
      x.rho[i] = __ldg(a.log_rhos + k);
      x.disc[i] = __ldg(a.discounts + k);
      x.rew[i] = __ldg(a.rewards + k);
      x.val[i] = __ldg(a.values + k);
    }
  }
  const int re = r0 + L;
  const float after =
      __ldg(a.values + static_cast<size_t>(min(re, a.T - 1)) * a.B + col);
  if (!kFull) {
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (r0 + i >= a.T) x.val[i] = boot;
  }
  return re < a.T ? after : boot;
}

// 1b. The chunk's map acc_{r0} = cb + ca acc_{r0 + L}, last row first;
// rows past T take the identity.
template <int L, bool kFull>
__device__ __forceinline__ void chunk_map(const Args& a, Rows<L>& x, int r0,
                                          float v_after, float& ca,
                                          float& cb) {
  ca = 1.0f;
  cb = 0.0f;
  float v_next = v_after;
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    x.rho[i] = expf(x.rho[i]);
    if (kFull || r0 + i < a.T) {
      float delta, dc;
      row_terms(a, x.rho[i], x.disc[i], x.rew[i], x.val[i], v_next, delta,
                dc);
      if constexpr (Rows<L>::kKeep) {
        x.delta[i] = delta;
        x.dc[i] = dc;
      }
      cb = delta + dc * cb;
      ca = dc * ca;
    }
    v_next = x.val[i];
  }
}

// 3. The rows again from the carry acc_{r0 + L}, writing vs_t and pg_t
// (live columns only); vs at row r0 + L is values there plus the carry.
template <int L, bool kFull>
__device__ __forceinline__ void write_rows(const Args& a, const Rows<L>& x,
                                           int r0, int col, bool live,
                                           float v_after, float carry) {
  const size_t last = static_cast<size_t>(r0 + L - 1) * a.B + col;
  float* vsp = a.vs + last;
  float* pgp = a.pg_advantages + last;
  float acc = carry;
  float vs_next = v_after + carry;
  float v_next = v_after;
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    if (kFull || r0 + i < a.T) {
      float delta, dc;
      if constexpr (Rows<L>::kKeep) {
        delta = x.delta[i];
        dc = x.dc[i];
      } else {
        row_terms(a, x.rho[i], x.disc[i], x.rew[i], x.val[i], v_next, delta,
                  dc);
      }
      acc = delta + dc * acc;
      const float vs_t = x.val[i] + acc;
      const float pg_t = fminf(a.clip_pg_rho, x.rho[i]) *
                         (x.rew[i] + x.disc[i] * vs_next - x.val[i]);
      if (live) {
        *vsp = vs_t;
        *pgp = pg_t;
      }
      vs_next = vs_t;
    }
    v_next = x.val[i];
    vsp -= a.B;
    pgp -= a.B;
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
    vtrace_chunked(const Args a) {
  // (A, Bc) of every chunk of a segment, by segment parity
  __shared__ float map_a[2][kMaxWarps][kLanes];
  __shared__ float map_b[2][kMaxWarps][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < a.B;
  const int col = live ? b : a.B - 1;   // dead lanes read a live column
  const float boot = __ldg(a.bootstrap + col);
  float seg_carry = 0.0f;               // acc at the row after the segment
  for (int seg = a.segments - 1; seg >= 0; --seg) {
    const int r0 = (seg * warps + warp) * L;   // the chunk's first row
    const bool full = r0 + L <= a.T;

    // 1. loads, then the chunk's map
    Rows<L> x;
    float v_after, ca, cb;
    if (full) {
      v_after = load_rows<L, true>(a, x, r0, col, boot);
      chunk_map<L, true>(a, x, r0, v_after, ca, cb);
    } else {
      v_after = load_rows<L, false>(a, x, r0, col, boot);
      chunk_map<L, false>(a, x, r0, v_after, ca, cb);
    }

    // 2. carries: compose the maps of later chunks, the last first; the
    // maps of this and earlier chunks only where another segment follows
    const int p = seg & 1;
    map_a[p][warp][lane] = ca;
    map_b[p][warp][lane] = cb;
    __syncthreads();
    float carry = seg_carry;   // acc at row r0 + L
    for (int w = warps - 1; w > warp; --w)
      carry = map_b[p][w][lane] + map_a[p][w][lane] * carry;
    if (seg > 0) {
      seg_carry = cb + ca * carry;
      for (int w = warp - 1; w >= 0; --w)
        seg_carry = map_b[p][w][lane] + map_a[p][w][lane] * seg_carry;
    }

    // 3. outputs
    if (full)
      write_rows<L, true>(a, x, r0, col, live, v_after, carry);
    else
      write_rows<L, false>(a, x, r0, col, live, v_after, carry);
  }
}

// a block owns kLanes columns, one a lane of each of its W warps
inline int blocks_of(int B) { return (B + kLanes - 1) / kLanes; }

template <int L>
int launch(const Args& a, int warps, cudaStream_t stream) {
  vtrace_chunked<L><<<blocks_of(a.B), warps * kLanes, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (T, B) inputs as above; warps, rows: (W, L) from ops.vtrace_chunks.
extern "C" int vtrace_from_importance_weights(
    const void* log_rhos, const void* discounts, const void* rewards,
    const void* values, const void* bootstrap, void* vs, void* pg_advantages,
    int T, int B, float clip_rho, float clip_c, float clip_pg_rho, int warps,
    int rows, void* stream) {
  if (T <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (warps < 1 || warps > kMaxWarps || rows < 1 || rows > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(log_rhos),
               static_cast<const float*>(discounts),
               static_cast<const float*>(rewards),
               static_cast<const float*>(values),
               static_cast<const float*>(bootstrap),
               static_cast<float*>(vs),
               static_cast<float*>(pg_advantages),
               T,
               B,
               (T + warps * rows - 1) / (warps * rows),
               clip_rho,
               clip_c,
               clip_pg_rho};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(kMaxRows == 16, "the switch below covers L = 1 .. 16");
  switch (rows) {
    case 1:
      return launch<1>(a, warps, s);
    case 2:
      return launch<2>(a, warps, s);
    case 4:
      return launch<4>(a, warps, s);
    case 8:
      return launch<8>(a, warps, s);
    case 16:
      return launch<16>(a, warps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The one launch of a call of B columns with W = warps: out[0..2] the
// grid, out[3] threads a block, out[4] bytes of dynamic shared memory a
// block (none: the carries' maps are static). Returns the number of
// launches (1), or -1 for a W the kernel does not take.
extern "C" int vtrace_geometry(int B, int warps, long long* out) {
  if (warps < 1 || warps > kMaxWarps) return -1;
  out[0] = blocks_of(B);
  out[1] = 1;
  out[2] = 1;
  out[3] = warps * kLanes;
  out[4] = 0;
  return 1;
}
