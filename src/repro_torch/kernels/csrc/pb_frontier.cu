// Poisson-binomial parity frontier over every (item, suffix start), for Hopper.
//
// Replaces the in-jit dynamic programme of the JAX package's decision
// programs: the masked DP over all suffix starts in D-Rex SC's window
// scorer (src/repro/core/sc_kernel.py:133, `_score_windows`) and the
// start-0 DP of the greedy scorers (src/repro/core/greedy_kernel.py:125,
// `_prefix_frontier`).  Its numpy twin is ParityFrontier.upto_many
// (src/repro/core/reliability.py:214).
//
//   probs (B, L) f64, targets (B,) f64  ->  out (B, S, L) int64
//
// out[b, s, i] is the smallest parity j whose availability CDF over the
// window probs[b, s..i] reaches targets[b], or -1 where no j <= i - s does,
// where i < s, or where i >= L_live.  The DP row is `W` entries wide (mass
// shifted past W - 1 is dropped, as in the JAX programme).
//
// Exactness.  Each decision compares a CDF with the target at ulp distance,
// so the arithmetic is the oracle's, operation for operation:
//   * dp'[j] = dp[j] * (1 - p) + dp[j-1] * p with separately rounded
//     products and sum (__dmul_rn / __dadd_rn, and the file is built with
//     -fmad=false so nothing is contracted into an FMA), as numpy does;
//     (1 - p) is one __dsub_rn per step;
//   * the CDF is np.cumsum's left-to-right running sum, dp[0], dp[0] +
//     dp[1], ..., stopping at the first term that reaches the target.  A
//     running sum of non-negative terms is monotone, so that first term is
//     argmax(cumsum(dp) >= target).  A parallel scan would re-associate.
//   Mass only moves up the row, so entries at or above W (which the
//   layouts below may hold) never reach an entry below W and are never
//   scanned.
//
// What bounds it.  Bytes: probs and targets read once and out written
// once, 8 * (B * L + B + B * S * L).  Operations: 3 f64 operations per
// updated DP entry plus one add per scanned CDF term, at the FP64 vector
// rate.  Neither is reached by a step-at-a-time design: the fixed summation
// order leaves each (row, step) a serial chain of mp + 1 dependent adds (mp
// the step's minimum parity, ~70 on the 10,000-node scale lane), and only
// the DP update carries from one step to the next.
//
// Design.  One warp per (item, start) row, up to four rows per block; no
// step waits on a barrier wider than its warp (no __syncthreads).
//   * `pb_frontier_regs<C>` (W <= 32 * C, C up to 36, so W <= 1152): the
//     row lives in registers, lane l owning the contiguous entries
//     [l*C, l*C + C); an update is one __shfl_up_sync of the neighbour's
//     top entry and C register updates.  The chains of different steps are
//     independent, so they run side by side: the warp advances 32 steps,
//     staging the first K entries of each step's row in its own
//     shared-memory slot, then lane t scans step t's slot in order (a
//     chain of __dadd_rn on values loaded ahead of it).  32 chains cost
//     about the time of one.  K covers every admissible parity where that
//     fits; otherwise the block stages only while the previous parity sits
//     `guard` below K (a parity grows by at most one a step), and a lane
//     that finds no hit within K replays the row from its start (the same
//     arithmetic, the same bits); a block that cannot stage scans each step
//     in lane order, the lane holding the running sum adding its registers
//     and handing the sum on by shuffle.  Since mass only moves up the row,
//     the first 32 * kNarrow entries of a row are those of the full row: a
//     first pass keeps only those (a ninth of the update work at C = 36)
//     and settles every step whose parity lies below that; a row with a
//     step it cannot settle runs again at full width.
//   * `pb_frontier_smem` (wider rows, up to the shared-memory opt-in): the
//     row lives in shared memory as two alternating rows of W doubles per
//     warp.  The update is spread over the lanes entry by entry (only the
//     entries that can be non-zero), one __syncwarp orders it before the
//     scan, and the scan loads 32 terms at once, one a lane, and every lane
//     adds them in order by shuffle broadcast, checking for an exit every
//     8 terms from the previous step's parity on.
// The wrapper (pb_frontier.py) picks the variant, C, rows per block and the
// staging from the width and the row count; the launch goes on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRowsPerBlock = 4;
constexpr int kGroup = 8;  // scan terms between two early-exit checks
constexpr int kNarrow = 4;  // entries a lane in a register row's first pass

struct RowCtx {
  const double* p_row;
  long long* o_row;
  double target;
  int s, live, W;
};

// The warp's row (b, s), or false past the last row.  Entries outside the
// row's steps are -1.
__device__ __forceinline__ bool row_ctx(const double* probs, const double* targets,
                                        long long* out, int B, int L, int S,
                                        int L_live, int W, int lane, RowCtx* r) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)B * S) return false;
  const int b = (int)(row / S);
  r->s = (int)(row - (long long)b * S);
  r->p_row = probs + (size_t)b * L;
  r->o_row = out + (size_t)row * L;
  r->target = targets[b];
  r->live = L_live < L ? L_live : L;
  r->W = W;
  for (int i = lane; i < L; i += 32) {
    if (i < r->s || i >= r->live) r->o_row[i] = -1;
  }
  return true;
}

// Keeps step i's result in lane (i - s) % 32 and stores 32 steps at once.
__device__ __forceinline__ void emit(const RowCtx& r, int i, int lane, int found,
                                     long long* res) {
  const int slot = (i - r.s) & 31;
  if (lane == slot) *res = found;
  if (slot == 31 || i == r.live - 1) {
    if (lane <= slot) r.o_row[i - slot + lane] = *res;
  }
}

// One DP step of a register row, in place and top down: dp[j] = dp[j] *
// (1 - p) + dp[j-1] * p, dp[j-1] of the lane below taken by one shuffle.
template <int C>
__device__ __forceinline__ void update_regs(double (&x)[C], double p, int lane) {
  const double q = __dsub_rn(1.0, p);
  double below = __shfl_up_sync(kFull, x[C - 1], 1);
  if (lane == 0) below = 0.0;
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    x[k] = __dadd_rn(__dmul_rn(x[k], q), __dmul_rn(k > 0 ? x[k - 1] : below, p));
  }
}

// One step's scan of a register row in lane order: the lane holding the
// running sum adds its registers in order and hands the sum on by shuffle.
// Exits are checked every kGroup terms from `hint` on.  Warp-uniform result.
template <int C>
__device__ __forceinline__ int scan_regs(const double (&x)[C], int lane, int jmax,
                                         double target, int hint) {
  int found = -1;
  double run = 0.0;
  for (int h = 0; h <= jmax / C; ++h) {
    if (lane == h) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        run = __dadd_rn(run, x[k]);
        const int j = h * C + k;
        if (found < 0 && run >= target && j <= jmax) found = j;
        if (k % kGroup == kGroup - 1 && k + 1 < C && j >= hint) {
          if (found >= 0 || j >= jmax) break;
        }
      }
    }
    found = __shfl_sync(kFull, found, h);
    run = __shfl_sync(kFull, run, h);
    if (found >= 0) break;
  }
  return found;
}

// One pass over a register row of `Wp` <= 32 * C entries (the first Wp of
// the row's W), steps in blocks of 32.  A block either stages the first K
// entries of each step's row in shared memory (one slot of `stage_k`
// doubles a step) and then scans its 32 steps at once, lane t running step
// t's in-order chain from its slot, or scans each step in lane order as it
// goes.  Staging is exact where K covers every admissible parity of the
// block, and otherwise taken only while the previous step's parity plus
// `guard` stays below K; a lane whose hit lies past K replays the row from
// its start through the block (the same arithmetic, so the same bits) and
// scans its step in lane order.  Entries below Wp are those of the full
// row, so every parity below Wp is the full row's; returns false, before
// storing the block, at the first step whose parity may lie at or above Wp.
template <int C>
__device__ __forceinline__ bool row_pass(const RowCtx& r, int lane, double* stage,
                                         int stage_k, int guard, int Wp) {
  double x[C];  // dp[lane * C + k]
#pragma unroll
  for (int k = 0; k < C; ++k) x[k] = 0.0;
  if (lane == 0) x[0] = 1.0;
  int prev = -1;  // the parity of the block's previous step
  for (int i0 = r.s; i0 < r.live; i0 += 32) {
    const int n = min(32, r.live - i0);
    const double pv = lane < n ? __ldg(r.p_row + i0 + lane) : 0.0;
    const int jmax_end = min(i0 + n - 1 - r.s, Wp - 1);
    int K = 0;  // staged entries a step; 0 scans each step as it goes
    if (jmax_end < stage_k) {
      K = jmax_end + 1;
    } else if (prev >= 0 && prev + guard < stage_k) {
      K = stage_k;
    }
    int mine = -1;  // lane t: the parity of step i0 + t
    if (K > 0) {
      for (int t = 0; t < n; ++t) {
        update_regs<C>(x, __shfl_sync(kFull, pv, t), lane);
        double* slot = stage + t * stage_k;
#pragma unroll
        for (int k = 0; k < C; ++k) {
          if (lane * C + k < K) slot[lane * C + k] = x[k];
        }
      }
      __syncwarp();
      const int jmax = min(i0 + lane - r.s, Wp - 1);
      const int lim = min(jmax, K - 1);
      const double* slot = stage + lane * stage_k;
      double run = 0.0;
      bool active = lane < n;
      for (int j0 = 0; __any_sync(kFull, active); j0 += 4) {
        if (active) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + u;
            run = __dadd_rn(run, j <= lim ? slot[j] : 0.0);
            if (mine < 0 && run >= r.target && j <= lim) mine = j;
          }
          active = mine < 0 && j0 + 4 <= lim;
        }
      }
      __syncwarp();  // the slots are rewritten by the next block
      const unsigned redo = __ballot_sync(kFull, lane < n && mine < 0 && lim < jmax);
      if (redo) {  // through the block's end, which leaves x as it was
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = 0.0;
        if (lane == 0) x[0] = 1.0;
        for (int i = r.s; i < i0 + n; ++i) {
          update_regs<C>(x, __ldg(r.p_row + i), lane);
          if (i >= i0 && ((redo >> (i - i0)) & 1u)) {
            const int f = scan_regs<C>(x, lane, min(i - r.s, Wp - 1), r.target, 0);
            if (lane == i - i0) mine = f;
          }
        }
      }
    } else {
      int hint = max(prev, 0);
      for (int t = 0; t < n; ++t) {
        update_regs<C>(x, __shfl_sync(kFull, pv, t), lane);
        const int f = scan_regs<C>(x, lane, min(i0 + t - r.s, Wp - 1), r.target, hint);
        if (lane == t) mine = f;
        hint = max(f, 0);
      }
    }
    const int i = i0 + lane;
    if (__any_sync(kFull, lane < n && mine < 0 && min(i - r.s, Wp - 1) < min(i - r.s, r.W - 1))) {
      return false;
    }
    if (lane < n) r.o_row[i] = mine;
    prev = __shfl_sync(kFull, mine, n - 1);
  }
  return true;
}

// Rows of up to 32 * C entries, in registers.  Parities are small next to
// the row (~70 of 1,097 on the scale lane), and mass only moves up the
// row, so a first pass keeps only the first 32 * kNarrow entries, a ninth
// of the work at C = 36; a row with a step it cannot settle runs again at
// full width.
template <int C>
__global__ void __launch_bounds__(32 * kMaxRowsPerBlock, 1)
pb_frontier_regs(const double* __restrict__ probs,
                 const double* __restrict__ targets, long long* __restrict__ out,
                 int B, int L, int S, int L_live, int W, int stage_k, int guard) {
  extern __shared__ double stages[];  // per warp: 32 slots of stage_k doubles
  const int lane = threadIdx.x & 31;
  RowCtx r;
  if (!row_ctx(probs, targets, out, B, L, S, L_live, W, lane, &r)) return;
  double* stage = stages + (size_t)(threadIdx.x >> 5) * 32 * stage_k;
  constexpr int kN = C < kNarrow ? C : kNarrow;
  if (kN < C && row_pass<kN>(r, lane, stage, stage_k, guard, min(W, 32 * kN))) return;
  row_pass<C>(r, lane, stage, stage_k, guard, W);
}

__global__ void __launch_bounds__(32 * kMaxRowsPerBlock, 1)
pb_frontier_smem(const double* __restrict__ probs,
                 const double* __restrict__ targets, long long* __restrict__ out,
                 int B, int L, int S, int L_live, int W) {
  extern __shared__ double rows[];  // per warp: two rows of W doubles
  const int lane = threadIdx.x & 31;
  RowCtx r;
  if (!row_ctx(probs, targets, out, B, L, S, L_live, W, lane, &r)) return;

  double* cur = rows + (size_t)(threadIdx.x >> 5) * 2 * W;
  double* nxt = cur + W;
  for (int j = lane; j < 2 * W; j += 32) cur[j] = j == 0 ? 1.0 : 0.0;
  __syncwarp();
  long long res = -1;
  int hint = 0;
  double p_next = r.s < r.live ? __ldg(r.p_row + r.s) : 0.0;
  for (int i = r.s; i < r.live; ++i) {
    const double p = p_next;
    if (i + 1 < r.live) p_next = __ldg(r.p_row + i + 1);
    const double q = __dsub_rn(1.0, p);
    const int n_len = i - r.s + 1;
    const int top = min(n_len, W - 1);  // highest entry that can be non-zero
    for (int j = lane; j <= top; j += 32) {
      const double lower = j > 0 ? cur[j - 1] : 0.0;
      nxt[j] = __dadd_rn(__dmul_rn(cur[j], q), __dmul_rn(lower, p));
    }
    __syncwarp();

    const int jmax = min(n_len - 1, W - 1);
    int found = -1;
    double run = 0.0;
    for (int base = 0; base <= jmax && found < 0; base += 32) {
      const double v = base + lane <= jmax ? nxt[base + lane] : 0.0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        run = __dadd_rn(run, __shfl_sync(kFull, v, k));
        const int j = base + k;
        if (found < 0 && run >= r.target && j <= jmax) found = j;
        if (k % kGroup == kGroup - 1 && j >= hint && (found >= 0 || j >= jmax)) break;
      }
    }
    emit(r, i, lane, found, &res);
    hint = max(found, 0);
    double* t = cur;
    cur = nxt;
    nxt = t;
  }
}

struct Launch {
  unsigned blocks;
  int threads, shared_bytes, stage_k, guard;
  cudaStream_t stream;
};

template <int C>
cudaError_t launch_regs(const Launch& g, const double* probs, const double* targets,
                        long long* out, int B, int L, int S, int L_live, int W) {
  cudaError_t err = cudaFuncSetAttribute(
      pb_frontier_regs<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.shared_bytes);
  if (err != cudaSuccess) return err;
  pb_frontier_regs<C><<<g.blocks, g.threads, g.shared_bytes, g.stream>>>(
      probs, targets, out, B, L, S, L_live, W, g.stage_k, g.guard);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block may opt in to on the current device, in bytes.
int pb_frontier_max_shared() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// probs: (B, L) f64; targets: (B,) f64; out: (B, S, L) int64; all contiguous
// on the current device.  variant 0 runs pb_frontier_regs<chunk> with
// `stage_k` doubles a staged step and the staging `guard`, variant 1
// pb_frontier_smem; `shared_bytes` of dynamic shared memory either way.
// The launch plan (pb_frontier.py, `plan`) chooses them.  Returns a
// cudaError_t.
int pb_frontier(const void* probs, const void* targets, void* out, int B, int L,
                int S, int L_live, int W, int variant, int chunk,
                int rows_per_block, int shared_bytes, int stage_k, int guard,
                void* stream) {
  if (B < 0 || L < 0 || S < 1 || W < 1 || rows_per_block < 1 ||
      rows_per_block > kMaxRowsPerBlock || shared_bytes > pb_frontier_max_shared()) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || L == 0) return (int)cudaSuccess;
  const long long n_rows = (long long)B * S;
  const Launch g{(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                 32 * rows_per_block, shared_bytes, stage_k, guard,
                 static_cast<cudaStream_t>(stream)};
  const double* p = static_cast<const double*>(probs);
  const double* t = static_cast<const double*>(targets);
  long long* o = static_cast<long long*>(out);
  if (variant == 1) {
    if ((long long)shared_bytes < 16LL * W * rows_per_block) {
      return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaFuncSetAttribute(
        pb_frontier_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    pb_frontier_smem<<<g.blocks, g.threads, shared_bytes, g.stream>>>(p, t, o, B, L, S,
                                                                      L_live, W);
    return (int)cudaGetLastError();
  }
  if (variant != 0 || W > 32 * chunk || stage_k < 1 || guard < 0 ||
      (long long)shared_bytes < 256LL * stage_k * rows_per_block) {
    return (int)cudaErrorInvalidValue;
  }
  switch (chunk) {
    case 1: return (int)launch_regs<1>(g, p, t, o, B, L, S, L_live, W);
    case 2: return (int)launch_regs<2>(g, p, t, o, B, L, S, L_live, W);
    case 3: return (int)launch_regs<3>(g, p, t, o, B, L, S, L_live, W);
    case 4: return (int)launch_regs<4>(g, p, t, o, B, L, S, L_live, W);
    case 6: return (int)launch_regs<6>(g, p, t, o, B, L, S, L_live, W);
    case 8: return (int)launch_regs<8>(g, p, t, o, B, L, S, L_live, W);
    case 12: return (int)launch_regs<12>(g, p, t, o, B, L, S, L_live, W);
    case 16: return (int)launch_regs<16>(g, p, t, o, B, L, S, L_live, W);
    case 24: return (int)launch_regs<24>(g, p, t, o, B, L, S, L_live, W);
    case 36: return (int)launch_regs<36>(g, p, t, o, B, L, S, L_live, W);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
