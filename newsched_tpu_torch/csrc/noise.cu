// Position-pure Gaussian noise rows for Hopper (sm_90a).
//
// Replaces the TPU kernel newsched_tpu/ops/pallas/noise.py
// `gaussian_rows` (with `_noise_kernel`, `gen_rows`, `_group_normal`).
// The TPU version re-seeds the chip's hardware PRNG per 64-row group; a
// GPU has no such engine, so each element runs a counter-based
// Philox4x32-10 instead:
//   key     = the stream seed (low, high 32 bits),
//   counter = (element index within its 64-row group, group lo, group hi, 0),
// and the first 3 output words feed the same Irwin-Hall N=6 transform
// (sum of the six uint16 halves, then (S - mean) * (1/std)). One group's
// rows therefore depend only on (seed, absolute group), the contract that
// makes the stream batch-split and tile invariant. The bits differ from the
// TPU's stream; the distribution is the same.
//
// Bound on the H100: the write of n_rows*width floats (16.8 MB for the
// flagship batch, ~5 us at 3.35 TB/s) against ~10 rounds x 2 32-bit
// multiplies per element (4.2 M elements): both are far below a
// millisecond, so the kernel is simple: one thread per element, a
// grid-stride loop, coalesced stores. The sum is an exact integer and the
// transform is one correctly rounded subtract and one multiply, so the
// plain PyTorch version (ops/cuda/noise.py) reproduces it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kGroupRows = 64;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c[0]), lo0 = kPhiloxM0 * c[0];
    const uint32_t hi1 = __umulhi(kPhiloxM1, c[2]), lo1 = kPhiloxM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__global__ void gaussian_rows_kernel(float* __restrict__ out, long long n_rows,
                                     int width, uint64_t g0, uint32_t k0,
                                     uint32_t k1, float mean, float inv_std) {
  const long long total = n_rows * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / width;
    const uint64_t g = g0 + (uint64_t)(row / kGroupRows);
    uint32_t c[4] = {(uint32_t)((row % kGroupRows) * width + i % width),
                     (uint32_t)g, (uint32_t)(g >> 32), 0u};
    philox4x32_10(c, k0, k1);
    uint32_t s = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) s += (c[d] & 0xFFFFu) + (c[d] >> 16);
    out[i] = __fmul_rn(__fsub_rn((float)s, mean), inv_std);
  }
}

}  // namespace

extern "C" int gaussian_rows_launch(float* out, long long n_rows, int width,
                                    uint32_t g_lo, uint32_t g_hi, uint32_t k0,
                                    uint32_t k1, float mean, float inv_std,
                                    void* stream) {
  const long long total = n_rows * width;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  const uint64_t g0 = ((uint64_t)g_hi << 32) | g_lo;
  gaussian_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out, n_rows, width, g0, k0, k1, mean, inv_std);
  return (int)cudaGetLastError();
}
