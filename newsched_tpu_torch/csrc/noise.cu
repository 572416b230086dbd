// Position-pure Gaussian noise rows for Hopper (sm_90a), optionally scaled
// by the source block's amplitude and written as its interleaved complex
// stream.
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
// same. The reference leaves the amplitude to XLA to fuse into the
// consumer; here the kernel writes __fmul_rn(g, amp), the one correctly
// rounded product the blocks' `r * amp` computes, with amp read from the
// card (the block's parameter tensor, so a captured graph replays a changed
// amplitude), and in the cf32 layout item i of row r is (lane k, lane
// width/2 + k) as re and im, the stream the blocks' torch.complex builds.
//
// Bound on the H100 at the flagship (32768 x 128): 16.8 MB written, 5.0 us
// at 3.35 TB/s, against Philox's ~114 integer operations an element, 7.1 us
// at the FP32 rate (Hopper's INT32 issue is half as wide: ~14 us). So the
// kernel issues little beside the rounds: a 2-D launch in which a block's
// ry rows (a power of 2 dividing 64) lie in one group, so the group's words
// are computed once a block and the counter's row part once a row, with no
// division; the ten round keys once a thread, over 8 elements at the
// flagship; `draws` a template parameter; 16-byte stores of VEC = 4 lanes
// where the row (or its half) allows; one block per ry rows, 2048 blocks
// at the flagship, no grid-stride loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

// Rows [blockIdx.x * ry, +ry), ry = blockDim.y: row threadIdx.y of them.
// Thread x takes the units x, x + blockDim.x, ... of `units`: VEC lanes
// each, of the row (CPLX false) or of each of its halves (CPLX true). The
// base group is read from the card (the stream state a captured graph
// replays with); amp, when given, too.
template <int DRAWS, int VEC, bool CPLX>
__global__ void __launch_bounds__(256)
gaussian_rows_kernel(float* __restrict__ out, int width, int units,
                     philox::Stream s, const long long* __restrict__ group,
                     const float* __restrict__ amp) {
  const long long row0 = (long long)blockIdx.x * blockDim.y;
  const long long row = row0 + threadIdx.y;
  const uint64_t g = philox::group_at(group, row0 >> 6);
  const bool masked = s.mask_pre && (long long)g < 0;
  const uint32_t glo = (uint32_t)g, ghi = (uint32_t)(g >> 32);
  const uint32_t crow = (uint32_t)(row & 63) * (uint32_t)width;  // row mod 64
  const float a = amp ? amp[0] : 1.f;  // x * 1 is x, bit for bit
  const philox::Keys keys = philox::round_keys(s.k0, s.k1);
  const int half = width >> 1;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int k = u * VEC;
    float v[VEC], w[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = masked ? 0.f
                    : philox::gauss_at<DRAWS>(crow + k + j, glo, ghi, keys,
                                              s.mean, s.inv_std);
      v[j] = __fmul_rn(v[j], a);
      if constexpr (CPLX) {
        w[j] = masked ? 0.f
                      : philox::gauss_at<DRAWS>(crow + half + k + j, glo, ghi,
                                                keys, s.mean, s.inv_std);
        w[j] = __fmul_rn(w[j], a);
      }
    }
    if constexpr (CPLX) {
      float* o = out + 2 * (row * half + k);
      if constexpr (VEC == 4) {
        reinterpret_cast<float4*>(o)[0] = make_float4(v[0], w[0], v[1], w[1]);
        reinterpret_cast<float4*>(o)[1] = make_float4(v[2], w[2], v[3], w[3]);
      } else {
        *reinterpret_cast<float2*>(o) = make_float2(v[0], w[0]);
      }
    } else {
      float* o = out + row * width + k;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      else
        o[0] = v[0];
    }
  }
}

template <int DRAWS, int VEC, bool CPLX>
int launch(float* out, long long n_rows, int width, int units, int bx, int ry,
           const philox::Stream& s, const long long* group, const float* amp,
           cudaStream_t stream) {
  gaussian_rows_kernel<DRAWS, VEC, CPLX>
      <<<(unsigned)(n_rows / ry), dim3(bx, ry), 0, stream>>>(out, width, units,
                                                             s, group, amp);
  return (int)cudaGetLastError();
}

template <int DRAWS>
int launch_layout(float* out, long long n_rows, int width, int units, int vec,
                  int cplx, int bx, int ry, const philox::Stream& s,
                  const long long* group, const float* amp,
                  cudaStream_t stream) {
  if (cplx)
    return vec == 4 ? launch<DRAWS, 4, true>(out, n_rows, width, units, bx, ry,
                                             s, group, amp, stream)
                    : launch<DRAWS, 1, true>(out, n_rows, width, units, bx, ry,
                                             s, group, amp, stream);
  return vec == 4 ? launch<DRAWS, 4, false>(out, n_rows, width, units, bx, ry,
                                            s, group, amp, stream)
                  : launch<DRAWS, 1, false>(out, n_rows, width, units, bx, ry,
                                            s, group, amp, stream);
}

}  // namespace

// amp: a float on the card, or null (no scaling); cplx: the interleaved
// complex layout; vec, bx, ry: the launch shape of ops/cuda/noise.py
// launch_shape.
extern "C" int gaussian_rows_launch(float* out, long long n_rows, int width,
                                    const long long* group, uint32_t k0,
                                    uint32_t k1, int draws, float mean,
                                    float inv_std, int mask_pre,
                                    const float* amp, int cplx, int vec,
                                    int bx, int ry, void* stream) {
  const int lanes = cplx ? width / 2 : width;
  if ((draws != 2 && draws != 3) || (vec != 1 && vec != 4) || width <= 0 ||
      (cplx && width % 2) || lanes % vec || bx <= 0 || ry <= 0 ||
      64 % ry || bx * ry > 256 || n_rows < 0 || n_rows % 64)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const int units = lanes / vec;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, mask_pre};
  const cudaStream_t st = (cudaStream_t)stream;
  return draws == 3 ? launch_layout<3>(out, n_rows, width, units, vec, cplx,
                                       bx, ry, s, group, amp, st)
                    : launch_layout<2>(out, n_rows, width, units, vec, cplx,
                                       bx, ry, s, group, amp, st);
}
