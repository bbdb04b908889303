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
//   * the CDF is np.cumsum's left-to-right running sum; one thread adds
//     dp[0], dp[1], ... until the sum reaches the target.  A running sum of
//     non-negative terms is monotone, so the first j it reaches is
//     argmax(cumsum(dp) >= target).  A parallel scan would re-associate.
//
// Design.  One block per (item, start) row; the row's DP lives in shared
// memory as two alternating buffers of W doubles (the dynamic-shared-memory
// opt-in above 48 KB; wider rows are refused).  Step i updates only the
// entries that can be non-zero (j <= i - s + 1), in parallel across the
// block; one barrier per step separates a step's writes from the next
// step's reads, and the serial scan of the row just written overlaps the
// next step's update, which reads the same buffer and writes the other.
//
// Bound on the card: the work is data-dependent.  Bytes: probs and targets
// read once and out written once, 8 * (B * L + B + B * S * L).  Operations:
// 3 f64 operations per updated DP entry plus one add per scanned CDF term,
// at the FP64 vector rate.  Per step the block also pays a barrier and the
// serial scan, so at small widths the kernel is latency-bound; it is right
// first, fast later.  The launch goes on the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
pb_frontier_kernel(const double* __restrict__ probs,
                   const double* __restrict__ targets,
                   long long* __restrict__ out, int L, int S, int L_live,
                   int W) {
  extern __shared__ double dp[];  // two rows of W doubles, alternating
  const int row = blockIdx.x;     // b * S + s
  const int b = row / S;
  const int s = row - b * S;
  const double* p_row = probs + (size_t)b * L;
  long long* o_row = out + (size_t)row * L;
  const double target = targets[b];
  const int live = L_live < L ? L_live : L;

  for (int j = threadIdx.x; j < 2 * W; j += blockDim.x) {
    dp[j] = (j == 0) ? 1.0 : 0.0;
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    if (i < s || i >= live) o_row[i] = -1;
  }
  __syncthreads();

  double* cur = dp;
  double* nxt = dp + W;
  // The next step's probability is loaded a step ahead, so its
  // device-memory latency overlaps the current step's work.
  double p_next = s < live ? p_row[s] : 0.0;
  for (int i = s; i < live; ++i) {
    const double p = p_next;
    if (i + 1 < live) p_next = p_row[i + 1];
    const double q = __dsub_rn(1.0, p);
    const int n_len = i - s + 1;
    const int top = n_len < W - 1 ? n_len : W - 1;  // highest non-zero entry
    for (int j = threadIdx.x; j <= top; j += blockDim.x) {
      const double shifted = j > 0 ? cur[j - 1] : 0.0;
      nxt[j] = __dadd_rn(__dmul_rn(cur[j], q), __dmul_rn(shifted, p));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int jmax = (n_len - 1) < (W - 1) ? (n_len - 1) : (W - 1);
      long long found = -1;
      double run = 0.0;
      for (int j = 0; j <= jmax; ++j) {
        run = (j == 0) ? nxt[0] : __dadd_rn(run, nxt[j]);
        if (run >= target) {
          found = j;
          break;
        }
      }
      o_row[i] = found;
    }
    double* t = cur;
    cur = nxt;
    nxt = t;
  }
}

int max_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

}  // namespace

extern "C" {

// Widest DP row one block can hold: two rows of doubles in the shared
// memory a block may opt in to on the current device.
int pb_frontier_max_width() { return max_optin_bytes() / (2 * (int)sizeof(double)); }

// probs: (B, L) f64; targets: (B,) f64; out: (B, S, L) int64; all contiguous
// on the current device.  Returns a cudaError_t.
int pb_frontier(const void* probs, const void* targets, void* out, int B,
                int L, int S, int L_live, int W, void* stream) {
  if (B < 0 || L < 0 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || L == 0) return (int)cudaSuccess;
  if (W > pb_frontier_max_width()) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)W * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      pb_frontier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((W + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  pb_frontier_kernel<<<(unsigned)((long long)B * S), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(probs), static_cast<const double*>(targets),
      static_cast<long long*>(out), L, S, L_live, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
