// The wideband-FM receive chain on time-folded lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/wbfm_chain.py
// `wbfm_chain_step` (`_kernel`, `_xlate_demod`; K10 here) and
// `wbfm_chain_live_step` (`_kernel_live`, `_gen_window`; K12 here).
//
// Layout: a batch of 64*R samples is folded into R rows of 128 lanes;
// lane s holds re and lane 64+s im of segment s, samples s*R .. s*R+R-1.
// Per segment, with x[k] its k-th sample (k < 0: the samples before it in
// the stream) and c the channel taps rotated by the xlate frequency:
//
//   U[m]  = sum_t c[t] * x[m*D - t]                  complex xlate FIR
//   P[m]  = conj(U[m-1]) * U[m] * e^{-j theta}       demod product, with
//                                                    the NCO folded in
//   d[m]  = atan2(Im P, Re P) * gain
//   y[o]  = sum_k r[k] * d[o*Rd - k]                 decimating resampler
//
// y is written to both halves of the output row (lanes s and 64+s).
//
// The TPU grid walks the row tiles of a batch in order, with one warm-up
// step first, and carries the demod's U[m-1] and the resampler's A-1-row
// tail from tile to tile. CUDA blocks run in no order, so each block
// rebuilds its own junction: the block for output rows [o0, o0+To) of a
// group of GS segments computes U over [o0*Rd - A, (o0+To-1)*Rd] (A+1
// values more than its own To*Rd) from its own window of raw samples.
// Samples before row 0 of the batch come from the previous segment's last
// rows of this batch, and for segment 0 from `carry`, the previous batch's
// last B8 rows (zeros at stream start). Every U, d and y value is computed
// by the same code with the same summation order whichever block computes
// it, so the outputs are bit-identical for every tile size, segment group
// and batch split. The segments are independent through the whole chain,
// so splitting them over blocks adds blocks without adding junction work.
//
// The two kernels differ only in where a block's samples come from: K10
// reads them from xp (and carry); K12 generates them from the phase
// counter, mathfns.cuh nco_folded_sample, the values of the NCO source K11
// (sources.cu), so K12's outputs equal K11 -> K10's bit for bit. Before
// the stream (first batch, sample index < 0) the samples are 0.
//
// Bound on the H100 at config #1 (81 channel taps, D = 4, 121 resampler
// taps, Rd = 5, R = 32640): this formulation does 8 flops per complex tap,
// 522,240 xlate outputs, and 2 per resampler tap, 104,448 outputs: 0.36
// GFLOP, 5.4 us at 67 TFLOP/s FP32, more by the junction (A+1 = 122 extra
// U rows for every To*Rd own rows: +24% at To = 102). That is more work
// than the function needs: in the staged order (rotate each input sample
// by the NCO, ~42 flops, then real taps, 4 flops a tap) it is ~0.30 GFLOP,
// under the 17.8 MB K10 moves (5.3 us at 3.35 TB/s); K12 reads nothing and
// its least is ~0.29 GFLOP, 4.3 us (chip_smoke.py kernel_bounds). The
// rotated taps are the TPU kernel's form, kept so that K10 matches it and
// its plain version term for term. The FIR runs in direct form,
// ntaps multiply-adds per output: the TPU's banded Toeplitz products (a
// band of W8 + T/G rows per group of outputs) are the MXU's form of this
// loop, and the direct form has no structural zeros at all. A block
// stages its samples in shared memory in chunks of CU xlate outputs, as
// [row][segment] planes with a row stride P chosen on the host against
// bank conflicts; each thread computes kJ consecutive outputs of one
// segment with a sliding window of samples in registers, so a shared load
// feeds kJ complex multiply-adds (xlate_outputs). The block keeps U and d
// of its whole range in shared memory and writes only the audio rows.
// Tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mathfns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // samples a thread stages per pass
// consecutive xlate outputs a thread computes: odd, so that the kJ*D rows
// between neighbouring threads' windows can avoid a multiple of 32 banks
constexpr int kJ = 5;
constexpr int kSegs = 64;  // fold width: segments = lane pairs
constexpr int kW = 2 * kSegs;

struct Wbfm {
  const float2* crot;   // (ntaps,) rotated channel taps (re, im)
  const float* rtaps;   // (A,) resampler taps
  float* aud;           // (R / (D*Rd), 128) audio, duplicated halves
  int R, ntaps, D, Rd, A;
  int T;                // batch rows per block tile (To = T / (D*Rd))
  int GS;               // segments per block
  int P;                // shared row stride of the sample planes (>= GS)
  int CU;               // xlate outputs per chunk
  float cos_t, sin_t, gain;
  mathfns::AtanCoeffs co;
};

__host__ __device__ __forceinline__ int n_u(const Wbfm& p) {
  return (p.T / (p.D * p.Rd) - 1) * p.Rd + p.A + 1;
}

__host__ __device__ __forceinline__ int chunk_rows(const Wbfm& p) {
  return (p.CU - 1) * p.D + p.ntaps;
}

// Shared floats: taps (2*ntaps), sample planes (2 * chunk_rows * P),
// U planes (2 * NU * GS), d (NU * GS).
__host__ __device__ __forceinline__ int smem_floats(const Wbfm& p) {
  return 2 * p.ntaps + 2 * chunk_rows(p) * p.P + 3 * n_u(p) * p.GS;
}

// kJ consecutive xlate outputs U[m0 + j] of one segment, j < kJ, from
// its staged samples (xr, xi: the segment's column, row stride P; row rb
// holds sample m0*D). Per output the taps are summed in one fixed order,
// phase ph = t mod D outer, k = t / D inner, whichever block or thread
// computes it. Along phase ph the FIR is a kJ-wide sliding window over
// y[i] = x[i*D - ph]: each y value is read from shared memory once and
// used by every output that needs it, held in registers in slot
// (i - m0) mod kJ, so the unrolled loop needs no register moves.
__device__ __forceinline__ void xlate_outputs(const float* xr,
                                              const float* xi,
                                              const float2* taps, int P,
                                              int D, int nt, int rb,
                                              float ar[kJ], float ai[kJ]) {
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
          const float2 c = taps[ph + k * D];
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
            const int sl = (j - kk + kJ) % kJ;  // y[m0 + j - k]
            ar[j] = fmaf(c.x, wr[sl], ar[j]);
            ar[j] = fmaf(-c.y, wi[sl], ar[j]);
            ai[j] = fmaf(c.x, wi[sl], ai[j]);
            ai[j] = fmaf(c.y, wr[sl], ai[j]);
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

// One block: segments [blockIdx.y*GS, +GS), audio rows [o0, o0+To) with
// o0 = blockIdx.x * To. `sample(s, k, &re, &im)` gives segment s's k-th
// sample of the batch (k >= -B8).
template <class Sample>
__device__ __forceinline__ void wbfm_tile(float* sm, const Wbfm& p,
                                          Sample sample) {
  const int tid = threadIdx.x;
  const int GS = p.GS, P = p.P, D = p.D, nt = p.ntaps;
  const int To = p.T / (D * p.Rd);
  const int o0 = blockIdx.x * To;
  const int s0 = blockIdx.y * GS;
  const int NU = n_u(p);
  const int mlo = o0 * p.Rd - p.A;  // first U of the block
  const int gs_shift = __ffs(GS) - 1;  // GS divides 64: a power of 2

  float2* taps = reinterpret_cast<float2*>(sm);
  float* xre = sm + 2 * nt;
  float* xim = xre + chunk_rows(p) * P;
  float* ure = xim + chunk_rows(p) * P;
  float* uim = ure + NU * GS;
  float* dd = uim + NU * GS;
  for (int t = tid; t < nt; t += kThreads) taps[t] = p.crot[t];

  // 1. U[mlo + i], i < NU, CU at a time: stage the chunk's samples (0
  //    past the block's last), then each thread sums kJ consecutive
  //    outputs of one segment (xlate_outputs).
  const int k_hi = (mlo + NU - 1) * D;  // the block's last sample
  for (int c0 = 0; c0 < NU; c0 += p.CU) {
    const int cu = min(p.CU, NU - c0);
    const int rows = ((cu + kJ - 1) / kJ * kJ - 1) * D + nt;
    const int k0 = (mlo + c0) * D - (nt - 1);
    __syncthreads();  // the previous chunk's reads are done
    // kLoads samples a thread in flight before any is stored
    for (int e0 = tid; e0 < rows * GS; e0 += kLoads * kThreads) {
      float re[kLoads], im[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads, k = k0 + (e >> gs_shift);
        re[u] = im[u] = 0.f;
        if (e < rows * GS && k <= k_hi)
          sample(s0 + (e & (GS - 1)), k, &re[u], &im[u]);
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
      xlate_outputs(xre + sl, xim + sl, taps, P, D, nt, mm0 * D + nt - 1, ar,
                    ai);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (mm0 + j < cu) {
          ure[(c0 + mm0 + j) * GS + sl] = ar[j];
          uim[(c0 + mm0 + j) * GS + sl] = ai[j];
        }
    }
  }
  __syncthreads();

  // 2. d[mlo + i], 1 <= i < NU: demod product against U[m-1], the
  //    constant rotation e^{-j theta}, atan2 * gain. Every product and sum
  //    rounded on its own.
  for (int e = tid; e < (NU - 1) * GS; e += kThreads) {
    const int i = 1 + e / GS, sl = e % GS;
    const float ar = ure[(i - 1) * GS + sl], ai = uim[(i - 1) * GS + sl];
    const float yr = ure[i * GS + sl], yi = uim[i * GS + sl];
    const float pr0 = __fadd_rn(__fmul_rn(ar, yr), __fmul_rn(ai, yi));
    const float pi0 = __fsub_rn(__fmul_rn(ar, yi), __fmul_rn(ai, yr));
    const float pr = __fadd_rn(__fmul_rn(p.cos_t, pr0), __fmul_rn(p.sin_t, pi0));
    const float pi = __fsub_rn(__fmul_rn(p.cos_t, pi0), __fmul_rn(p.sin_t, pr0));
    dd[i * GS + sl] = __fmul_rn(mathfns::atan2_poly(pi, pr, p.co), p.gain);
  }
  __syncthreads();

  // 3. y[o0 + o] = sum_k r[k] * d[(o0+o)*Rd - k], to both halves.
  for (int e = tid; e < To * GS; e += kThreads) {
    const int o = e / GS, sl = e % GS;
    const float* col = dd + (o * p.Rd + p.A) * GS + sl;
    float acc = 0.f;
    for (int k = 0; k < p.A; ++k) acc = fmaf(__ldg(p.rtaps + k), col[-k * GS], acc);
    float* row = p.aud + (long long)(o0 + o) * kW;
    row[s0 + sl] = acc;
    row[kSegs + s0 + sl] = acc;
  }
}

// K10: samples read from the folded batch xp (R, 128); before row 0, from
// the previous segment's last rows, or for segment 0 from carry (B8, 128),
// the previous batch's last rows.
__global__ void __launch_bounds__(kThreads)
wbfm_chain_kernel(const float* __restrict__ xp, const float* __restrict__ carry,
                  int B8, Wbfm p) {
  extern __shared__ __align__(16) float sm[];
  const int R = p.R;
  wbfm_tile(sm, p, [&](int s, int k, float* re, float* im) {
    const float* row;
    int lane = s;
    if (k >= 0) {
      row = xp + (long long)k * kW;
    } else if (s > 0) {
      row = xp + (long long)(R + k) * kW;
      lane = s - 1;
    } else {
      row = carry + (long long)(B8 + k) * kW;
      lane = kSegs - 1;
    }
    *re = __ldg(row + lane);
    *im = __ldg(row + kSegs + lane);
  });
}

// K12: samples generated from the NCO's phase counter (on the card): sample
// index s*R + k of the batch (negative: the previous batch, by the uint32
// wrap; 0 before the stream on the stream's first batch, the flag `first`
// on the card, which only time shard 0 of a batch reads).
__global__ void __launch_bounds__(kThreads)
wbfm_live_kernel(const long long* __restrict__ phase,
                 const long long* __restrict__ dphase,
                 const float* __restrict__ amp,
                 const unsigned char* __restrict__ first, int shard,
                 mathfns::SinCosCoeffs sc, Wbfm p) {
  extern __shared__ __align__(16) float sm[];
  const float a = amp[0];
  const int R = p.R;
  const mathfns::NcoPos pos =
      mathfns::nco_pos(phase, dphase, (long long)shard * kSegs * R);
  const bool b0 = shard == 0 && first[0] != 0;
  wbfm_tile(sm, p, [&](int s, int k, float* re, float* im) {
    mathfns::nco_folded_sample(pos.ph0, pos.dp, a, b0, R, s, k, sc, re, im);
  });
}

Wbfm make(const float* crot, const float* rtaps, float* aud, int R, int ntaps,
          int D, int Rd, int A, int T, int GS, int P, int CU, float cos_t,
          float sin_t, float gain, const float* atan_coeffs) {
  return Wbfm{reinterpret_cast<const float2*>(crot), rtaps, aud, R, ntaps, D,
              Rd, A, T, GS, P, CU, cos_t, sin_t, gain,
              mathfns::load_atan(atan_coeffs)};
}

bool bad_geometry(const Wbfm& p) {
  const int step = p.D * p.Rd;
  return p.T <= 0 || p.T % step || p.R % p.T || p.GS <= 0 || kSegs % p.GS ||
         p.P < p.GS || p.CU != kThreads / p.GS * kJ || p.ntaps <= 0 ||
         p.A <= 0;
}

template <class Kernel>
int set_smem(Kernel kernel, const Wbfm& p, size_t* smem) {
  *smem = (size_t)smem_floats(p) * sizeof(float);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" int wbfm_chain_launch(const float* xp, const float* carry,
                                 const float* crot, const float* rtaps,
                                 float* aud, int R, int ntaps, int D, int Rd,
                                 int A, int B8, int T, int GS, int P, int CU,
                                 float cos_t, float sin_t, float gain,
                                 const float* atan_coeffs, void* stream) {
  const Wbfm p = make(crot, rtaps, aud, R, ntaps, D, Rd, A, T, GS, P, CU,
                      cos_t, sin_t, gain, atan_coeffs);
  if (bad_geometry(p) || R < B8) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = set_smem(wbfm_chain_kernel, p, &smem);
  if (err) return err;
  const dim3 grid(R / T, kSegs / GS);
  wbfm_chain_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(xp, carry,
                                                                    B8, p);
  return (int)cudaGetLastError();
}

extern "C" int wbfm_live_launch(const long long* phase,
                                const long long* dphase, const float* amp,
                                const unsigned char* first, int shard,
                                const float* crot,
                                const float* rtaps, float* aud, int R,
                                int ntaps, int D, int Rd, int A, int B8, int T,
                                int GS, int P, int CU, float cos_t,
                                float sin_t, float gain,
                                const float* atan_coeffs,
                                const float* sincos_coeffs, void* stream) {
  const Wbfm p = make(crot, rtaps, aud, R, ntaps, D, Rd, A, T, GS, P, CU,
                      cos_t, sin_t, gain, atan_coeffs);
  if (bad_geometry(p) || R < B8 || shard < 0) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = set_smem(wbfm_live_kernel, p, &smem);
  if (err) return err;
  const dim3 grid(R / T, kSegs / GS);
  wbfm_live_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      phase, dphase, amp, first, shard, mathfns::load_sincos(sincos_coeffs),
      p);
  return (int)cudaGetLastError();
}
