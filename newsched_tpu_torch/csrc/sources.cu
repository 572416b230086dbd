// The fixed-point NCO tone sources, for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/sources.py
// `nco_planes` (`_nco_kernel`; K8 here) and `nco_folded`
// (`_nco_folded_kernel`; K11 here). Sample k of a batch has the phase
// phase0 + k * dphase (uint32, wrapping: the exact modulo-2^32 fixed-point
// accumulator) and the value amp * e^{j 2 pi phase / 2^32}, evaluated by
// mathfns.cuh nco_sample (signed-phase turns, quarter-wave sin/cos).
//
//   K8  re[k], im[k] for k < n: the (n/128, 128) planes of the reference,
//       flattened; any n (the ragged last block is masked).
//   K11 out[r, s] = re(sample s*R + r), out[r, 64 + s] = im(the same):
//       the time-folded-lanes layout of the wideband-FM chain (wbfm_chain.cu).
//
// Bound on the H100: memory. Each sample is written once (8 bytes) and
// nothing is read: 16.7 MB a batch of 2,088,960 samples, ~5 us at
// 3.35 TB/s, against ~40 flops a sample (~80 MFLOP, ~1.3 us at 67 TFLOP/s
// FP32). So one thread per sample, with neighbouring threads on
// neighbouring words of each output row (K11 writes a row's two halves
// from the same 64 threads), and no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mathfns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSegs = 64;  // K11's fold width: segments = lane pairs

__global__ void __launch_bounds__(kThreads)
nco_planes_kernel(const long long* __restrict__ phase,
                  const long long* __restrict__ dphase,
                  const float* __restrict__ amp, long long n,
                  float* __restrict__ re, float* __restrict__ im,
                  mathfns::SinCosCoeffs co) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const mathfns::NcoPos pos = mathfns::nco_pos(phase, dphase, 0);
  float r, i;
  mathfns::nco_sample(pos.ph0 + (uint32_t)k * pos.dp, amp[0], co, &r, &i);
  re[k] = r;
  im[k] = i;
}

__global__ void __launch_bounds__(kThreads)
nco_folded_kernel(const long long* __restrict__ phase,
                  const long long* __restrict__ dphase,
                  const float* __restrict__ amp, int R, float* __restrict__ out,
                  mathfns::SinCosCoeffs co) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)R * kSegs) return;
  const int row = (int)(e / kSegs), s = (int)(e % kSegs);
  const mathfns::NcoPos pos = mathfns::nco_pos(phase, dphase, 0);
  float r, i;
  mathfns::nco_folded_sample(pos.ph0, pos.dp, amp[0], false, R, s, row, co,
                             &r, &i);
  out[(long long)row * 2 * kSegs + s] = r;
  out[(long long)row * 2 * kSegs + kSegs + s] = i;
}

}  // namespace

extern "C" int nco_planes_launch(const long long* phase,
                                 const long long* dphase, const float* amp,
                                 long long n, float* re, float* im,
                                 const float* sincos_coeffs, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  nco_planes_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      phase, dphase, amp, n, re, im, mathfns::load_sincos(sincos_coeffs));
  return (int)cudaGetLastError();
}

extern "C" int nco_folded_launch(const long long* phase,
                                 const long long* dphase, const float* amp,
                                 int R, float* out, const float* sincos_coeffs,
                                 void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)R * kSegs + kThreads - 1) / kThreads;
  nco_folded_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      phase, dphase, amp, R, out, mathfns::load_sincos(sincos_coeffs));
  return (int)cudaGetLastError();
}
