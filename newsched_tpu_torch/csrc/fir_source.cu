// Config #0's live chain, the fixed-point NCO tone through a real-tap FIR,
// as one kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel newsched_tpu/ops/pallas/fir_source.py
// `fir_tone_step` (`_kernel`, its window from wbfm_chain.py `_gen_window`;
// K9 here).
//
// Layout (time-folded lanes, as the wideband-FM chain's): a batch of 64*R
// samples is R rows of 128 lanes; lane s holds re and lane 64+s im of
// segment s, samples s*R .. s*R+R-1. With x[k] segment s's k-th sample
// (k < 0: the samples before it in the stream) and D the decimation,
//
//   out[o, s] + j out[o, 64+s] = sum_t taps[t] * x[o*D - t],  o < R/D.
//
// The samples are generated, never read: mathfns.cuh nco_folded_sample,
// the values of the NCO sources K8/K11 (sources.cu) and of K12's loader,
// with the previous batch's samples by the uint32 wrap and 0 before the
// stream on the first batch. A FIR has no recursive state, so there are no
// carries and no junction: each block owns a range of output rows of a
// group of GS segments and generates the look-back window it needs into
// shared memory, CU outputs at a time (ntaps-1 + CU*D rows). Each thread
// computes kJ consecutive outputs of one segment, re and im, with a sliding
// window of samples in registers, the taps summed phase by phase
// (t mod D outer, t / D inner) in one fixed order: every output comes from
// the same routine with the same summation order whichever block or thread
// computes it, so the outputs are bit-identical for every geometry and
// every batch split. The FIR runs in direct form, ntaps multiply-adds per
// output and plane: the TPU's banded Toeplitz products (fir_toeplitz and
// the group picker, a band of W8 + T/G window rows per group of outputs)
// are the MXU's form of this loop and have no user here.
//
// Bound on the H100 at config #0 (128 taps, D = 1, 2^21 samples a batch):
// 16.8 MB of output written and nothing read, 5.0 us at 3.35 TB/s. The
// function's least arithmetic is the NCO (~36 operations a sample) and an
// FFT convolution (~120 flops a complex output at a 1024-point FFT),
// ~0.33 GFLOP, 5 us at 67 TFLOP/s FP32: the bound is the bytes. The direct
// form does 4 flops a tap and sample, 1.07 GFLOP, at least 16 us on the
// FP32 cores, so this kernel reaches at most ~31% of its bound; an FFT
// form is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mathfns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // samples a thread stages per pass
// consecutive outputs a thread computes: odd, so that the kJ*D rows
// between neighbouring threads' windows can avoid a multiple of 32 banks
constexpr int kJ = 9;
constexpr int kSegs = 64;  // fold width: segments = lane pairs
constexpr int kW = 2 * kSegs;

struct Fir {
  const float* taps;  // (ntaps,) real taps
  float* out;         // (R / D, 128)
  int R, ntaps, D;
  int T;              // batch rows per block (T / D output rows)
  int GS;             // segments per block
  int P;              // shared row stride of the sample planes (>= GS)
  int CU;             // outputs per chunk: kThreads / GS * kJ
};

// Rows of a block's staged window: the largest chunk, rounded up to whole
// kJ-output groups, and its ntaps-1 rows of look-back.
__host__ __device__ __forceinline__ int stage_rows(const Fir& p) {
  const int To = p.T / p.D;
  const int cu = To < p.CU ? To : p.CU;
  return ((cu + kJ - 1) / kJ * kJ - 1) * p.D + p.ntaps;
}

// Shared floats: taps, then the re and im sample planes.
__host__ __device__ __forceinline__ int smem_floats(const Fir& p) {
  return p.ntaps + 2 * stage_rows(p) * p.P;
}

// kJ consecutive outputs of one segment, j < kJ, from its staged samples
// (xr, xi: the segment's column, row stride P; row rb holds sample m0*D of
// the first output m0). Along phase ph the FIR is a kJ-wide sliding window
// over y[i] = x[i*D - ph]: each y value is read from shared memory once and
// used by every output that needs it, held in registers in slot
// (i - m0) mod kJ, so the unrolled loop needs no register moves.
__device__ __forceinline__ void fir_outputs(const float* xr, const float* xi,
                                            const float* taps, int P, int D,
                                            int nt, int rb, float ar[kJ],
                                            float ai[kJ]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) ar[j] = ai[j] = 0.f;
  for (int ph = 0; ph < D; ++ph) {
    const int K = (nt - ph + D - 1) / D;  // taps of this phase
    float wr[kJ], wi[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int r = (rb + j * D - ph) * P;
      wr[j] = xr[r];
      wi[j] = xi[r];
    }
    for (int kb = 0; kb < K; kb += kJ) {
#pragma unroll
      for (int kk = 0; kk < kJ; ++kk) {
        const int k = kb + kk;
        if (k < K) {
          const float c = taps[ph + k * D];
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int sl = (j - kk + kJ) % kJ;  // y[m0 + j - k]
            ar[j] = fmaf(c, wr[sl], ar[j]);
            ai[j] = fmaf(c, wi[sl], ai[j]);
          }
          if (k + 1 < K) {  // y[m0 - k - 1] replaces y[m0 - k + kJ - 1]
            const int r = (rb - (k + 1) * D - ph) * P;
            wr[kJ - 1 - kk] = xr[r];
            wi[kJ - 1 - kk] = xi[r];
          }
        }
      }
    }
  }
}

// One block: segments [blockIdx.y*GS, +GS), output rows [o0, o0+T/D) with
// o0 = blockIdx.x * T/D, CU outputs a chunk: stage the chunk's samples (0
// past the block's last), then each thread sums kJ consecutive outputs of
// one segment and writes them to both planes.
// The phase counter, its increment and the first-batch flag are read from
// the card (the stream state of the runner's captured graph); time shard
// `shard` starts shard * 64 * R samples into the batch, and only shard 0
// has samples before the stream.
__global__ void __launch_bounds__(kThreads)
fir_tone_kernel(const long long* __restrict__ phase,
                const long long* __restrict__ dphase,
                const float* __restrict__ amp,
                const unsigned char* __restrict__ first, int shard,
                mathfns::SinCosCoeffs sc, Fir p) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int GS = p.GS, P = p.P, D = p.D, nt = p.ntaps;
  const int To = p.T / D;
  const int o0 = blockIdx.x * To;
  const int s0 = blockIdx.y * GS;
  const int gs_shift = __ffs(GS) - 1;  // GS divides 64: a power of 2
  const float a = amp[0];
  const mathfns::NcoPos pos =
      mathfns::nco_pos(phase, dphase, (long long)shard * kSegs * p.R);
  const uint32_t ph0 = pos.ph0, dp = pos.dp;
  const bool b0 = shard == 0 && first[0] != 0;

  float* taps = sm;
  float* xre = sm + nt;
  float* xim = xre + stage_rows(p) * P;
  for (int t = tid; t < nt; t += kThreads) taps[t] = p.taps[t];

  const int k_hi = (o0 + To - 1) * D;  // the block's last sample
  for (int c0 = 0; c0 < To; c0 += p.CU) {
    const int cu = min(p.CU, To - c0);
    const int rows = ((cu + kJ - 1) / kJ * kJ - 1) * D + nt;
    const int k0 = (o0 + c0) * D - (nt - 1);
    __syncthreads();  // the previous chunk's reads are done
    // kLoads samples a thread in flight before any is stored
    for (int e0 = tid; e0 < rows * GS; e0 += kLoads * kThreads) {
      float re[kLoads], im[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, k = k0 + (e >> gs_shift);
        re[u] = im[u] = 0.f;
        if (e < rows * GS && k <= k_hi)
          mathfns::nco_folded_sample(ph0, dp, a, b0, p.R, s0 + (e & (GS - 1)),
                                     k, sc, &re[u], &im[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads;
        if (e < rows * GS) {
          const int at = (e >> gs_shift) * P + (e & (GS - 1));
          xre[at] = re[u];
          xim[at] = im[u];
        }
      }
    }
    __syncthreads();
    const int mm0 = (tid >> gs_shift) * kJ, sl = tid & (GS - 1);
    if (mm0 < cu) {
      float ar[kJ], ai[kJ];
      fir_outputs(xre + sl, xim + sl, taps, P, D, nt, mm0 * D + nt - 1, ar, ai);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (mm0 + j < cu) {
          float* row = p.out + (long long)(o0 + c0 + mm0 + j) * kW;
          row[s0 + sl] = ar[j];
          row[kSegs + s0 + sl] = ai[j];
        }
    }
  }
}

}  // namespace

extern "C" int fir_tone_launch(const long long* phase, const long long* dphase,
                               const float* amp, const unsigned char* first,
                               int shard, const float* taps, float* out, int R,
                               int ntaps, int D, int T, int GS, int P, int CU,
                               const float* sincos_coeffs, void* stream) {
  const Fir p{taps, out, R, ntaps, D, T, GS, P, CU};
  if (D <= 0 || T <= 0 || T % D || R % T || GS <= 0 || kSegs % GS ||
      (GS & (GS - 1)) || P < GS || CU != kThreads / GS * kJ || ntaps <= 0 ||
      shard < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(p) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_tone_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R / T, kSegs / GS);
  fir_tone_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      phase, dphase, amp, first, shard, mathfns::load_sincos(sincos_coeffs),
      p);
  return (int)cudaGetLastError();
}
