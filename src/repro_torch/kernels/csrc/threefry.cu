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
// in blockIdx.y, the bf16 or f32 store written once.  Gumbel-max runs one
// block per row: each thread hashes and scores a strided share of the
// vocabulary, then a warp-shuffle and shared-memory argmax (lowest index on a
// tie, NaN as the maximum, as jnp.argmax).  Launches go on the caller's
// stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNormalThreads = 256;
constexpr int kNormalMaxBlocksX = 4096;
constexpr int kArgmaxThreads = 1024;

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
__device__ __forceinline__ bool beats(float a, long long ia, float b, long long ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// tokens (rows,) = argmax over v of gumbel(key, (rows, V))[r, v] + logits[r, v].
__global__ void __launch_bounds__(kArgmaxThreads)
gumbel_argmax_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ logits,
                     long long vocab, long long* __restrict__ tokens) {
  __shared__ float s_val[kArgmaxThreads / 32];
  __shared__ long long s_idx[kArgmaxThreads / 32];
  const long long base = (long long)blockIdx.x * vocab;
  float best = -__int_as_float(0x7F800000);
  long long best_i = vocab;  // beaten by any finite or infinite value
  for (long long j = threadIdx.x; j < vocab; j += blockDim.x) {
    const uint32_t b = draw_bits(k0, k1, (unsigned long long)(base + j));
    const float u = fmaxf(uniform01(b), 0x1p-126f);
    const float g = -xla_log(-xla_log(u));
    const float v = __fadd_rn(g, logits[base + j]);
    if (best_i == vocab || beats(v, j, best, best_i)) { best = v; best_i = j; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
    const long long oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
    if (oi != vocab && (best_i == vocab || beats(ov, oi, best, best_i))) {
      best = ov; best_i = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { s_val[warp] = best; s_idx[warp] = best_i; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
    best = lane < n_warps ? s_val[lane] : 0.0f;
    best_i = lane < n_warps ? s_idx[lane] : vocab;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xFFFFFFFFu, best, off);
      const long long oi = __shfl_down_sync(0xFFFFFFFFu, best_i, off);
      if (oi != vocab && (best_i == vocab || beats(ov, oi, best, best_i))) {
        best = ov; best_i = oi;
      }
    }
    if (lane == 0) tokens[blockIdx.x] = best_i;
  }
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

// logits: (rows, vocab) f32 contiguous; tokens: (rows,) int64.
int gumbel_argmax(unsigned int k0, unsigned int k1, const void* logits, int rows,
                  long long vocab, void* tokens, void* stream) {
  if (rows <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  gumbel_argmax_kernel<<<rows, kArgmaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<const float*>(logits), vocab, static_cast<long long*>(tokens));
  return (int)cudaGetLastError();
}

}  // extern "C"
