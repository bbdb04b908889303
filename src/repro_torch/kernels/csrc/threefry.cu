// jax.random's threefry2x32 draws for Hopper: normal fills and Gumbel-max
// sampling, bit for bit the values the JAX package draws.
//
// Replaces what XLA compiles for the JAX package's two seeded draws (neither
// is a Pallas kernel):
//   * jax.random.normal in dense_init (src/repro/models/layers.py:32), once
//     per stacked leaf of init_params;
//   * jax.random.categorical in the serving engine's _sample
//     (src/repro/serve/engine.py:51).
//
// Both use jax's partitionable threefry2x32: draw i of a leaf hashes the
// counter (i >> 32, i & 0xffffffff) under the leaf's key and keeps
// bits1 ^ bits2.  A stacked leaf has one key per slice (vmap of the init over
// split keys), each slice counting from 0.  The f32 arithmetic that follows is
// XLA's CPU expansion, operation for operation: uniform from the top 23 bits,
// log1p (Cephes' rational form below sqrt(2) - 1, else log(1 + x) with XLA's
// polynomial log), Giles' erf_inv, times sqrt(2)f, then times std (a second
// multiply: XLA does not reassociate).  Where XLA's code generator fuses a
// multiply into the add that follows, this code calls __fmaf_rn; every other
// add and multiply is __fadd_rn / __fmul_rn, so nvcc fuses nothing else, and
// division and square root are the correctly rounded __fdiv_rn / __fsqrt_rn.
// The plain versions in kernels/ref.py do the same operations in torch.
//
// Bound on the card: by operations.  A normal draw is 70 int32 operations
// (20 rounds of add, funnel-shift, xor; the key injections, those into x0
// folded into the next round's add) and ~40-50 f32 operations, and writes 2
// or 4 bytes.  The design keeps everything in
// registers: one thread per draw in a grid-stride loop, the key table's row
// in blockIdx.y, the bf16 or f32 store written once.
//
// Gumbel-max is bound the same way: a vocabulary entry is the hash, two of
// XLA's logs and a compare, on 4 bytes of logit.  So it has to fill the card
// even at a decode batch of 4.  Pass 1 runs a (slices, rows) grid: a block of
// kSliceThreads threads takes kSlice consecutive entries of one row (4 a
// thread, unrolled, so four hash chains are in flight), keeps a running
// (value, index) a thread, reduces them in warp shuffles and shared memory,
// and writes the slice's best to a (rows, slices) scratch buffer.  Rows past
// the grid's 65,535 loop in blockIdx.y.  Pass 2, one warp a row, reduces the
// row's slices and writes the token.  It is launched as a programmatic
// dependent of pass 1 (Hopper): its launch is processed while pass 1 runs,
// and griddepcontrol.wait holds each warp until pass 1 has finished and its
// writes are visible (about 1 us less a call at (4, 151,936) on an H100;
// PERF.md).  Grids: (64, 4) = 256 blocks at (4, 65,536), (149, 4) = 596 at
// (4, 151,936), (149, 64) = 9,536 at (64, 151,936), on 132 SMs.  Both passes
// compare with beats (the lowest index on a tie, NaN as the maximum, as
// jnp.argmax), a strict total order on (value, index) pairs, so the result is
// the same in every reduction order and from run to run.  Launches go on the
// caller's stream, allocate nothing (the caller passes the scratch), and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNormalThreads = 256;
constexpr int kNormalMaxBlocksX = 4096;
constexpr int kSliceThreads = 256;
constexpr int kSlice = 1024;  // entries a pass-1 block
constexpr int kNoIndex = 0x7FFFFFFF;  // an empty slot: (-inf, kNoIndex) loses to every entry
constexpr int kMaxRowsY = 65535;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r)               \
  x0 += x1;                       \
  x1 = __funnelshift_l(x1, x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

// The 32-bit word of draw n (a flat index) under key (k0, k1).
__device__ __forceinline__ uint32_t draw_bits(uint32_t k0, uint32_t k1,
                                              unsigned long long n) {
  uint32_t x0 = (uint32_t)(n >> 32), x1 = (uint32_t)n;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// f32 in [0, 1): the word's top 23 bits as a mantissa over 1.0, minus 1.
__device__ __forceinline__ float uniform01(uint32_t b) {
  return __fadd_rn(__uint_as_float((b >> 9) | 0x3F800000u), -1.0f);
}

// XLA's f32 log on the CPU (Cephes): 0 -> -inf, inf -> inf, else NaN below 0.
__device__ __forceinline__ float xla_log(float v) {
  const float tiny = 0x1p-126f;
  const float vv = v > tiny ? v : tiny;
  const uint32_t b = __float_as_uint(vv);
  const float m = __uint_as_float((b & 0x7FFFFFu) | 0x3F000000u);
  float e = __fadd_rn(__int2float_rn((int)(b >> 23) - 127), 1.0f);
  const bool lt = m < 0x1.6a09e6p-1f;
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), lt ? m : 0.0f);
  e = __fsub_rn(e, lt ? 1.0f : 0.0f);
  const float z = __fmul_rn(x, x);
  const float z3 = __fmul_rn(z, x);
  const float q0 = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x, 0x1.de4a34p-4f);
  const float q1 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x, -0x1.555cap-3f);
  const float q2 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x, 0x1.555554p-2f);
  const float r = __fmaf_rn(__fmaf_rn(__fmaf_rn(q0, z3, q1), z3, q2), z3,
                            __fmul_rn(e, -0x1.bd0106p-13f));
  const float out = __fmaf_rn(e, 0x1.63p-1f,
                              __fadd_rn(__fsub_rn(x, __fmul_rn(z, 0.5f)), r));
  if (v == 0.0f) return -__int_as_float(0x7F800000);
  if (v == __int_as_float(0x7F800000)) return __int_as_float(0x7F800000);
  return v > 0.0f ? out : __uint_as_float(0xFFFFFFFFu);
}

// XLA's f32 log1p on the CPU.
__device__ __forceinline__ float xla_log1p(float y) {
  if (!(fabsf(y) < 0x1.a8279ap-2f)) return xla_log(__fadd_rn(y, 1.0f));
  const float y2 = __fmul_rn(y, y);
  float den = 1.0f;
  den = __fmaf_rn(den, y, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, y, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, y, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, y, 0x1.351946p+8f);
  den = __fmaf_rn(den, y, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, y, 0x1.e0f304p+5f);
  float num = 0x1.7bc096p-15f;
  num = __fmaf_rn(num, y, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, y, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, y, 0x1.de9738p+4f);
  num = __fmaf_rn(num, y, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, y, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, y, 0x1.40a202p+4f);
  const float ratio = __fdiv_rn(num, den);
  return __fadd_rn(y, __fmaf_rn(y2, -0.5f, __fmul_rn(__fmul_rn(y, y2), ratio)));
}

// XLA's f32 erf_inv (Giles): a 9-term Horner polynomial in w - 2.5 (w < 5) or
// sqrt(w) - 3, w = -log1p(-u*u), times u.
__device__ __forceinline__ float xla_erf_inv(float u) {
  const float lg = xla_log1p(__fmul_rn(u, -u));
  float w, p;
  if (lg > -5.0f) {
    w = __fsub_rn(-2.5f, lg);
    p = 0x1.e2cb1p-26f;
    p = __fmaf_rn(p, w, 0x1.70966cp-22f);
    p = __fmaf_rn(p, w, -0x1.d8e6aep-19f);
    p = __fmaf_rn(p, w, -0x1.26b582p-18f);
    p = __fmaf_rn(p, w, 0x1.ca65b6p-13f);
    p = __fmaf_rn(p, w, -0x1.48a81p-10f);
    p = __fmaf_rn(p, w, -0x1.11c9dep-8f);
    p = __fmaf_rn(p, w, 0x1.f91ec6p-3f);
    p = __fmaf_rn(p, w, 0x1.805c5ep+0f);
  } else {
    w = __fsub_rn(__fsqrt_rn(-lg), 3.0f);
    p = -0x1.a3e136p-13f;
    p = __fmaf_rn(p, w, 0x1.a76ad6p-14f);
    p = __fmaf_rn(p, w, 0x1.61b8e4p-10f);
    p = __fmaf_rn(p, w, -0x1.e17bcep-9f);
    p = __fmaf_rn(p, w, 0x1.7824f6p-8f);
    p = __fmaf_rn(p, w, -0x1.f38baep-8f);
    p = __fmaf_rn(p, w, 0x1.354afcp-7f);
    p = __fmaf_rn(p, w, 0x1.006db6p+0f);
    p = __fmaf_rn(p, w, 0x1.6a9efcp+1f);
  }
  if (fabsf(u) == 1.0f) p = __int_as_float(0x7F800000);
  return __fmul_rn(u, p);
}

__device__ __forceinline__ float normal_draw(uint32_t b) {
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  const float u = fmaxf(__fmaf_rn(uniform01(b), 2.0f, lo), lo);
  return __fmul_rn(xla_erf_inv(u), 0x1.6a09e6p+0f);
}

__device__ __forceinline__ void store(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// out (n_keys, count): row k = draws offset .. offset + count - 1 under key k.
template <typename T>
__global__ void __launch_bounds__(kNormalThreads)
threefry_normal_kernel(const uint32_t* __restrict__ keys, long long count,
                       long long offset, float std, int has_std,
                       T* __restrict__ out) {
  const int k = blockIdx.y;
  const uint32_t k0 = keys[2 * k], k1 = keys[2 * k + 1];
  T* row = out + (long long)k * count;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    float z = normal_draw(draw_bits(k0, k1, (unsigned long long)(offset + i)));
    if (has_std) z = __fmul_rn(z, std);
    store(row, i, z);
  }
}

// a beats b: NaN first (the lower index among NaNs), then the larger value,
// then the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The warp's best (value, index) into lane 0.
__device__ __forceinline__ void warp_best(float& best, int& best_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
    if (beats(ov, oi, best, best_i)) { best = ov; best_i = oi; }
  }
}

// Pass 1: part_val/part_idx (rows, slices) = the best of
// gumbel(key, (rows, V))[r, v] + logits[r, v] over the slice's v.
__global__ void __launch_bounds__(kSliceThreads)
gumbel_slice_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ logits,
                    int rows, int vocab, float* __restrict__ part_val,
                    int* __restrict__ part_idx) {
  __shared__ float s_val[kSliceThreads / 32];
  __shared__ int s_idx[kSliceThreads / 32];
  const int slices = gridDim.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = blockIdx.x * kSlice + threadIdx.x;
  asm volatile("griddepcontrol.launch_dependents;");  // pass 2 may launch now
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const unsigned long long base = (unsigned long long)r * vocab;
    float best = -__int_as_float(0x7F800000);
    int best_i = kNoIndex;
#pragma unroll
    for (int k = 0; k < kSlice / kSliceThreads; ++k) {
      const int j = lo + k * kSliceThreads;
      if (j < vocab) {
        const uint32_t b = draw_bits(k0, k1, base + j);
        const float u = fmaxf(uniform01(b), 0x1p-126f);
        const float g = -xla_log(-xla_log(u));
        const float v = __fadd_rn(g, logits[base + j]);
        if (beats(v, j, best, best_i)) { best = v; best_i = j; }
      }
    }
    warp_best(best, best_i);
    if (lane == 0) { s_val[warp] = best; s_idx[warp] = best_i; }
    __syncthreads();
    if (warp == 0) {
      best = lane < kSliceThreads / 32 ? s_val[lane] : -__int_as_float(0x7F800000);
      best_i = lane < kSliceThreads / 32 ? s_idx[lane] : kNoIndex;
      warp_best(best, best_i);
      if (lane == 0) {
        part_val[(long long)r * slices + blockIdx.x] = best;
        part_idx[(long long)r * slices + blockIdx.x] = best_i;
      }
    }
    __syncthreads();  // s_val/s_idx are read before the next row writes them
  }
}

// Pass 2, one warp a row: tokens[r] = the index of the best of the row's slices.
__global__ void __launch_bounds__(32)
gumbel_combine_kernel(const float* __restrict__ part_val,
                      const int* __restrict__ part_idx, int slices,
                      long long* __restrict__ tokens) {
  const long long row = (long long)blockIdx.x * slices;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 1 done and visible
  float best = -__int_as_float(0x7F800000);
  int best_i = kNoIndex;
  for (int s = threadIdx.x; s < slices; s += 32) {
    const float v = part_val[row + s];
    const int i = part_idx[row + s];
    if (beats(v, i, best, best_i)) { best = v; best_i = i; }
  }
  warp_best(best, best_i);
  if (threadIdx.x == 0) tokens[blockIdx.x] = best_i;
}

}  // namespace

extern "C" {

// keys: (n_keys, 2) uint32 on the device; out: (n_keys, count) f32 (out_bf16
// = 0) or bf16, contiguous.  Returns a cudaError_t.
int threefry_normal(const void* keys, int n_keys, long long count, long long offset,
                    float std, int has_std, int out_bf16, void* out, void* stream) {
  if (n_keys <= 0 || n_keys > 65535 || count < 0 || offset < 0)
    return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  long long bx = (count + kNormalThreads - 1) / kNormalThreads;
  if (bx > kNormalMaxBlocksX) bx = kNormalMaxBlocksX;
  const dim3 grid((unsigned)bx, (unsigned)n_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  if (out_bf16) {
    threefry_normal_kernel<__nv_bfloat16><<<grid, kNormalThreads, 0, s>>>(
        k, count, offset, std, has_std, static_cast<__nv_bfloat16*>(out));
  } else {
    threefry_normal_kernel<float><<<grid, kNormalThreads, 0, s>>>(
        k, count, offset, std, has_std, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// logits: (rows, vocab) f32 contiguous; tokens: (rows,) int64; scratch:
// scratch_bytes >= 8 * rows * ceil(vocab / kSlice) on the device, which the
// launch overwrites (f32 values, then int32 indices).
int gumbel_argmax(unsigned int k0, unsigned int k1, const void* logits, int rows,
                  long long vocab, void* scratch, long long scratch_bytes,
                  void* tokens, void* stream) {
  // int indices: the last slice's threads must not pass INT_MAX
  if (rows <= 0 || vocab <= 0 || vocab > kNoIndex - kSlice)
    return (int)cudaErrorInvalidValue;
  const int slices = (int)((vocab + kSlice - 1) / kSlice);
  const long long parts = (long long)rows * slices;
  if (scratch_bytes < 8 * parts) return (int)cudaErrorInvalidValue;
  float* part_val = static_cast<float*>(scratch);
  int* part_idx = reinterpret_cast<int*>(part_val + parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)slices, (unsigned)(rows < kMaxRowsY ? rows : kMaxRowsY));
  gumbel_slice_kernel<<<grid, kSliceThreads, 0, s>>>(
      k0, k1, static_cast<const float*>(logits), rows, (int)vocab, part_val, part_idx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // pass 2 as a programmatic dependent of pass 1 (it waits in the kernel)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows);
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, gumbel_combine_kernel, (const float*)part_val,
                     (const int*)part_idx, slices, static_cast<long long*>(tokens));
  return (int)cudaGetLastError();
}

}  // extern "C"
