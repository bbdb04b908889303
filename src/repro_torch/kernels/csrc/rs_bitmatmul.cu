// Cauchy-RS coding over GF(2^8) as a mod-2 bit-matrix product, for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel gf_bitmatmul
// (src/repro/kernels/rs_bitmatmul.py): out (R, B) u8 = M (R, K) x data (K, B)
// over GF(2^8), with M given as its (8R, 8K) GF(2) bit matrix
// (out_bits[8r+i, 8k+j] = bit i of M[r,k] * 2^j).  R = P with the Cauchy
// matrix encodes; R = K with the inverted generator submatrix decodes.
//
// The TPU kernel unpacks bytes into f32 bit planes for the MXU.  Here the
// same function is computed with integer XOR, which is exact by construction:
//
//   * Each block stages the coefficient bytes c[r][k][j] = M[r,k] * 2^j
//     (column 8k+j of rows 8r..8r+7 of the bit matrix, packed LSB-first),
//     replicated into all four bytes of a 32-bit word, in shared memory.
//   * Each thread owns 16 contiguous byte columns: one 16-byte load per input
//     row (neighbouring threads on neighbouring addresses).
//   * For every input bit plane j, mask = ((w >> j) & 0x01010101) * 0xFF
//     turns the bits of four bytes into four byte masks, and
//     acc ^= mask & c[r][k][j] accumulates into RT output rows at once.
//   * One 16-byte store per output row.
//
// Bound on the card: every input byte is read once and every output byte
// written once, (K + R) * B bytes of HBM traffic; the XOR work is about
// 8 * K * (R + 1) integer operations per 4 byte columns, which takes over only
// at large K * R.  Output rows are processed in tiles of RT <= 8 accumulators
// (32 registers); larger R loops over tiles in grid.y, re-reading the data
// through L2.  Any B is handled: the ragged tail (and unaligned rows) take a
// byte-wise path.  The launch goes on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
// Coefficient words a block may stage: 48 KiB, the dynamic shared memory a
// launch gets without opting in.
constexpr int kMaxCoefWords = 12288;

__device__ __forceinline__ uint4 load16(const uint8_t* row, long long col,
                                        long long b, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + col);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    if (col + i < b) w[i >> 2] |= uint32_t(row[col + i]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* row, long long col,
                                        long long b, bool vec, uint4 v) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + col) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    if (col + i < b) row[col + i] = uint8_t(w[i >> 2] >> (8 * (i & 3)));
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
rs_bitmatmul_kernel(const uint8_t* __restrict__ bitm,
                    const uint8_t* __restrict__ data,
                    uint8_t* __restrict__ out, int r, int k, long long b,
                    int aligned) {
  // coef[(rr * k + kk) * 8 + j]: coefficient byte of output row r0 + rr,
  // input row kk, bit plane j, replicated x4.
  extern __shared__ uint32_t coef[];
  const int r0 = blockIdx.y * RT;
  const int k8 = 8 * k;
  const int n_coef = RT * k8;
  for (int idx = threadIdx.x; idx < n_coef; idx += blockDim.x) {
    const int rr = idx / k8;
    const int col = idx - rr * k8;  // bit-matrix column 8kk + j
    const int row = r0 + rr;
    uint32_t byte = 0u;
    if (row < r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        byte |= uint32_t(bitm[(size_t)(8 * row + i) * k8 + col] & 1u) << i;
      }
    }
    coef[idx] = byte * 0x01010101u;
  }
  __syncthreads();

  const long long c0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kBytesPerThread;
  if (c0 >= b) return;
  const bool vec = aligned && (c0 + kBytesPerThread <= b);

  uint4 acc[RT];
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) acc[rr] = make_uint4(0u, 0u, 0u, 0u);

  for (int kk = 0; kk < k; ++kk) {
    const uint4 w = load16(data + (size_t)kk * b, c0, b, vec);
    const uint32_t* c = coef + kk * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t mx = ((w.x >> j) & 0x01010101u) * 0xFFu;
      const uint32_t my = ((w.y >> j) & 0x01010101u) * 0xFFu;
      const uint32_t mz = ((w.z >> j) & 0x01010101u) * 0xFFu;
      const uint32_t mw = ((w.w >> j) & 0x01010101u) * 0xFFu;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const uint32_t cj = c[rr * k8 + j];
        acc[rr].x ^= mx & cj;
        acc[rr].y ^= my & cj;
        acc[rr].z ^= mz & cj;
        acc[rr].w ^= mw & cj;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    if (r0 + rr < r) store16(out + (size_t)(r0 + rr) * b, c0, b, vec, acc[rr]);
  }
}

template <int RT>
cudaError_t launch(const uint8_t* bitm, const uint8_t* data, uint8_t* out,
                   int r, int k, long long b, int aligned,
                   cudaStream_t stream) {
  const long long threads = (b + kBytesPerThread - 1) / kBytesPerThread;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads),
                  (unsigned)((r + RT - 1) / RT));
  const size_t smem = (size_t)RT * k * 8 * sizeof(uint32_t);
  rs_bitmatmul_kernel<RT><<<grid, kThreads, smem, stream>>>(
      bitm, data, out, r, k, b, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest K one launch takes: RT * K * 8 coefficient words must fit the
// shared memory a block reserves (the wrapper checks before launching).
int rs_bitmatmul_max_coef_words() { return kMaxCoefWords; }

// Row tile the launch uses for R output rows (1, 2, 4 or 8).
int rs_bitmatmul_row_tile(int r) {
  return r >= 5 ? 8 : (r >= 3 ? 4 : (r == 2 ? 2 : 1));
}

// bitm: (8R, 8K) uint8 in {0, 1}; data: (K, B) uint8; out: (R, B) uint8;
// all contiguous on the current device.  Returns a cudaError_t.
int rs_bitmatmul(const void* bitm, const void* data, void* out, int r, int k,
                 long long b, void* stream) {
  if (r <= 0 || k <= 0 || b < 0) return (int)cudaErrorInvalidValue;
  const int rt = rs_bitmatmul_row_tile(r);
  if ((long long)rt * k * 8 > kMaxCoefWords) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const int aligned = (b % kBytesPerThread == 0) &&
                      ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const uint8_t* bm = static_cast<const uint8_t*>(bitm);
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rt) {
    case 1: err = launch<1>(bm, d, o, r, k, b, aligned, s); break;
    case 2: err = launch<2>(bm, d, o, r, k, b, aligned, s); break;
    case 4: err = launch<4>(bm, d, o, r, k, b, aligned, s); break;
    default: err = launch<8>(bm, d, o, r, k, b, aligned, s); break;
  }
  return (int)err;
}

}  // extern "C"
