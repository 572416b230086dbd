// The polyphase channelizer front end for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/channelizer.py
// `arm_fold` (`_kernel`; K7 here) and `arm_fold_dft` (`_fused_kernel`;
// K1 here). On the interleaved [re, im] float32 view of the commutator
// matrix v (rows of 2M lanes):
//
//   acc[t] = c2[0]*v[t] + c2[1]*v[t+1] + ... + c2[L-1]*v[t+L-1]   (K7)
//   Y[t]   = acc[t] @ W2                                          (K1)
//
// with W2 the (2M x 2M) interleaved DFT matrix (phase combine and
// twiddle in one real product). Rows of v past its end read as 0, so the
// caller pads nothing.
//
// The TPU kernels DMA one overlapping (T+H8)-row window per grid step and
// carry nothing between steps; here each block reads its own window through
// the read-only cache (the L-fold reuse is served by L1), so there is no
// junction to recompute. Every output is computed by the same code in
// whichever block holds it, so results do not depend on the tile size.
//
// Bounds on the H100 at the flagship shape (32768 x 128 rows): K7 moves
// 16.8 MB in and 16.8 MB out, ~10 us at 3.35 TB/s, against 2*L flops a
// lane (~2 flops/byte): memory-bound. K1 adds the DFT, 2*128^2 flops per
// row (1.07 GFLOP a batch, ~64 flops/byte): compute-bound in FP32 on the
// CUDA cores, like K3 but without K3's junction rows. K1 folds the tile
// into shared memory (T x W floats, 64 KB at T=128, W=128) and writes the
// product straight from registers, 128 columns at a time (tile_mm.cuh), so
// it takes any W that is a multiple of 128, as the TPU kernel does (M = 64,
// 128, 192, 256 channels). The FP32 product keeps the TPU kernel's HIGHEST
// accuracy: bf16 passes left its DFT at 22 dB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mm.cuh"

namespace {

constexpr int kThreads = tile_mm::kThreads;
constexpr int kPassRows = tile_mm::kPassRows;
constexpr int kW = tile_mm::kW;

// Lane k of row t of the fold, rows at or past n_in read as 0.
__device__ __forceinline__ float fold_lane(const float* __restrict__ v,
                                           long long n_in,
                                           const float* __restrict__ c2,
                                           int W, int L, long long t, int k) {
  float acc = 0.f;
  for (int q = 0; q < L; ++q) {
    const long long r = t + q;
    const float x = r < n_in ? __ldg(v + r * W + k) : 0.f;
    acc = q ? fmaf(__ldg(c2 + q * W + k), x, acc) : __ldg(c2 + k) * x;
  }
  return acc;
}

// K7: one block per tile of T output rows, any lane count W.
__global__ void __launch_bounds__(kThreads)
arm_fold_kernel(const float* __restrict__ v, long long n_in,
                const float* __restrict__ c2, float* __restrict__ out,
                long long n_out, int W, int L, int T) {
  const long long t0 = (long long)blockIdx.x * T;
  for (int idx = threadIdx.x; idx < T * W; idx += kThreads) {
    const long long t = t0 + idx / W;
    const int k = idx % W;
    if (t < n_out) out[t * W + k] = fold_lane(v, n_in, c2, W, L, t, k);
  }
}

// K1: fold T rows into shared memory, then Y = acc @ W2 in passes of 32
// rows by 128 columns. W is a multiple of 128: the template's kWidth when
// that is nonzero (a constant, so the index arithmetic and the product's
// loops compile as for K3), else the argument w.
template <int kWidth>
__global__ void __launch_bounds__(kThreads)
arm_fold_dft_kernel(const float* __restrict__ v, long long n_in,
                    const float* __restrict__ c2, const float* __restrict__ w2,
                    float* __restrict__ out, long long n_out, int w, int L,
                    int T) {
  const int W = kWidth ? kWidth : w;
  extern __shared__ __align__(16) float buf[];  // (T_pad, W)
  const long long t0 = (long long)blockIdx.x * T;
  const int T_pad = (T + kPassRows - 1) / kPassRows * kPassRows;
  for (int idx = threadIdx.x; idx < T_pad * W; idx += kThreads) {
    const int jj = idx / W, k = idx % W;
    const long long t = t0 + jj;
    buf[idx] = jj < T && t < n_out ? fold_lane(v, n_in, c2, W, L, t, k) : 0.f;
  }
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < T_pad; r0 += kPassRows) {
    for (int c0 = 0; c0 < W; c0 += kW) {
      float o[4][4];
      tile_mm::pass(buf + r0 * W, W, w2 + c0, W, W, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = r0 + 4 * ty + i;
        const long long t = t0 + jj;
        if (jj < T && t < n_out)
          *reinterpret_cast<float4*>(out + t * W + c0 + 4 * tx) =
              make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      }
    }
  }
}

unsigned n_blocks(long long n_out, int T) {
  return (unsigned)((n_out + T - 1) / T);
}

template <int kWidth>
int launch_fold_dft(const float* v, long long n_in, const float* c2,
                    const float* w2, float* out, long long n_out, int W, int L,
                    int T, cudaStream_t stream) {
  const size_t smem =
      (size_t)((T + kPassRows - 1) / kPassRows * kPassRows) * W * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      arm_fold_dft_kernel<kWidth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  arm_fold_dft_kernel<kWidth><<<n_blocks(n_out, T), kThreads, smem, stream>>>(
      v, n_in, c2, w2, out, n_out, W, L, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int arm_fold_dft_launch(const float* v, long long n_in,
                                   const float* c2, const float* w2,
                                   float* out, long long n_out, int W, int L,
                                   int T, void* stream) {
  if (W < kW || W % kW != 0 || T < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (W) {  // the widths of the repo's channelizers (M = 64 .. 256)
    case 128: return launch_fold_dft<128>(v, n_in, c2, w2, out, n_out, W, L, T, s);
    case 256: return launch_fold_dft<256>(v, n_in, c2, w2, out, n_out, W, L, T, s);
    case 512: return launch_fold_dft<512>(v, n_in, c2, w2, out, n_out, W, L, T, s);
    default: return launch_fold_dft<0>(v, n_in, c2, w2, out, n_out, W, L, T, s);
  }
}

extern "C" int arm_fold_launch(const float* v, long long n_in, const float* c2,
                               float* out, long long n_out, int W, int L,
                               int T, void* stream) {
  if (T < 1 || W < 1 || L < 1) return (int)cudaErrorInvalidValue;
  arm_fold_kernel<<<n_blocks(n_out, T), kThreads, 0, (cudaStream_t)stream>>>(
      v, n_in, c2, out, n_out, W, L, T);
  return (int)cudaGetLastError();
}
