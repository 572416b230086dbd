// Position-pure Gaussian noise rows for Hopper (sm_90a).
//
// Replaces the TPU kernel newsched_tpu/ops/pallas/noise.py
// `gaussian_rows` (with `_noise_kernel`, `gen_rows`, `_group_normal`).
// The TPU version re-seeds the chip's hardware PRNG per 64-row group; a
// GPU has no such engine, so each element runs a counter-based
// Philox4x32-10 instead (philox.cuh): keyed by the stream seed, counted by
// (element index within its 64-row group, group lo, group hi, 0), and its
// first `draws` (2 or 3) words feed the same Irwin-Hall N = 2*draws
// transform. One group's rows therefore depend only on (seed, absolute
// group, draws), the contract that makes the stream batch-split and tile
// invariant. The bits differ from the TPU's stream; the distribution is the
// same.
//
// Bound on the H100: the write of n_rows*width floats (16.8 MB for the
// flagship batch, ~5 us at 3.35 TB/s) against ~10 rounds x 2 32-bit
// multiplies per element (4.2 M elements): both are far below a
// millisecond, so the kernel is simple: one thread per element, a
// grid-stride loop, coalesced stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

// The base group is read from the card (the stream state a captured graph
// replays with): s.g0 is filled in from `group`.
__global__ void gaussian_rows_kernel(float* __restrict__ out, long long n_rows,
                                     int width, philox::Stream s,
                                     const long long* __restrict__ group) {
  s.g0 = philox::group_at(group, 0);
  const long long total = n_rows * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride)
    out[i] = philox::gauss(s, i / width, (int)(i % width), width);
}

}  // namespace

extern "C" int gaussian_rows_launch(float* out, long long n_rows, int width,
                                    const long long* group, uint32_t k0,
                                    uint32_t k1, int draws, float mean,
                                    float inv_std, int mask_pre,
                                    void* stream) {
  if (draws != 2 && draws != 3) return (int)cudaErrorInvalidValue;
  const long long total = n_rows * width;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, mask_pre};
  gaussian_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      out, n_rows, width, s, group);
  return (int)cudaGetLastError();
}
