// The polynomial math functions of the fused kernels, shared by the FM
// channelizer chain (fm_chain.cu, K3/K5), the NCO sources (sources.cu,
// K8/K11), the wideband-FM chain (wbfm_chain.cu, K10/K12) and the live
// FIR source (fir_source.cu, K9).
//
// Replaces the TPU device functions newsched_tpu/ops/pallas/mathfns.py
// `atan2` (K2) and `sin_cos_turns`. Their coefficients come from the host
// (ops/cuda/mathfns.py ATAN_COEFFS, SINCOS_COEFFS), so kernels and plain
// versions use identical float32 values.

#pragma once

#include <stdint.h>

namespace mathfns {

constexpr int kAtanDeg = 9;
constexpr int kQwDeg = 5;

struct AtanCoeffs {
  float c[kAtanDeg + 1];
};

struct SinCosCoeffs {
  float s[kQwDeg + 1];  // sin(pi/2 f) ~ f * sum_k s[k] (f^2)^k
  float c[kQwDeg + 1];  // cos(pi/2 f) ~ sum_k c[k] (f^2)^k
};

inline AtanCoeffs load_atan(const float* host) {
  AtanCoeffs co;
  for (int i = 0; i <= kAtanDeg; ++i) co.c[i] = host[i];
  return co;
}

// host: (2, kQwDeg+1) float32, row 0 sin, row 1 cos.
inline SinCosCoeffs load_sincos(const float* host) {
  SinCosCoeffs co;
  for (int i = 0; i <= kQwDeg; ++i) {
    co.s[i] = host[i];
    co.c[i] = host[kQwDeg + 1 + i];
  }
  return co;
}

// atan2 by argument reduction to [0, 1] and an odd polynomial of degree
// 2*kAtanDeg+1 (the reference's mathfns.atan2, deg=9). (+-0, +-0) -> 0:
// the zero-history demod emits exactly 0, whatever the signs of the zeros.
// Every rounding is fixed: each Horner step one fused multiply-add, every
// other operation rounded on its own, the form nvcc chose for it in every
// kernel before the roundings were written out, whose bits they keep
// (left to the compiler, its contraction can differ between callers).
__device__ __forceinline__ float atan2_poly(float y, float x,
                                            const AtanCoeffs& co) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float z = __fdiv_rn(lo, fmaxf(hi, 1e-37f));
  const float w = __fmul_rn(z, z);
  float acc = co.c[kAtanDeg];
#pragma unroll
  for (int k = kAtanDeg - 1; k >= 0; --k) acc = __fmaf_rn(acc, w, co.c[k]);
  float a = __fmul_rn(z, acc);
  const float pi = 3.14159265358979f;
  if (ay > ax) a = __fsub_rn(pi * 0.5f, a);
  if (x < 0.f) a = __fsub_rn(pi, a);
  if (y < 0.f) a = -a;
  if (x == 0.f && y == 0.f) a = 0.f;
  return a;
}

// (sin, cos)(2 pi t) of float32 turns t, any range: the quarter-wave
// polynomials with the quadrant logic of the reference's sin_cos_turns.
// Every multiply and add is rounded on its own (no FMA contraction), as
// torch's elementwise ops round them, so the plain version is bit-equal.
__device__ __forceinline__ void sin_cos_turns(float t, const SinCosCoeffs& co,
                                              float* sn, float* cs) {
  t = __fsub_rn(t, floorf(t));
  const float u = __fmul_rn(t, 4.f);
  float q = floorf(u);
  const float f = __fsub_rn(u, q);
  // a t a hair below a whole turn rounds t - floor(t) to exactly 1.0,
  // which would put u = 4 in a fifth quadrant: wrap it to 0
  if (q >= 4.f) q = __fsub_rn(q, 4.f);
  const float w = __fmul_rn(f, f);
  float as = co.s[kQwDeg], ac = co.c[kQwDeg];
#pragma unroll
  for (int k = kQwDeg - 1; k >= 0; --k) {
    as = __fadd_rn(__fmul_rn(as, w), co.s[k]);
    ac = __fadd_rn(__fmul_rn(ac, w), co.c[k]);
  }
  const float s1 = __fmul_rn(as, f), c1 = ac;
  // quadrant 0 (s1, c1), 1 (c1, -s1), 2 (-s1, -c1), 3 (-c1, s1), by
  // selects rather than branches, so that a thread's samples interleave
  const bool odd = q == 1.f || q == 3.f;
  const float a = odd ? c1 : s1, b = odd ? s1 : c1;
  *sn = q >= 2.f ? -a : a;
  *cs = q == 1.f || q == 2.f ? -b : b;
}

// The NCO sample of the fixed-point phase accumulator: the uint32 phase
// read as a SIGNED int32, converted to float32 and scaled by 2^-32 (turns
// in [-0.5, 0.5), as the reference's sources), then sin_cos_turns times
// amp: re = cos * amp, im = sin * amp.
__device__ __forceinline__ void nco_sample(uint32_t phase, float amp,
                                           const SinCosCoeffs& co, float* re,
                                           float* im) {
  const float t = __fmul_rn(__int2float_rn((int)phase), 2.3283064365386963e-10f);
  float sn, cs;
  sin_cos_turns(t, co, &sn, &cs);
  *re = __fmul_rn(cs, amp);
  *im = __fmul_rn(sn, amp);
}

// The NCO's stream position as the kernels read it: the phase counter and
// its increment live on the card as int64 tensors holding uint32 values
// (the runner's captured graph replays the step, so nothing of the stream
// may be a launch argument), and a time shard starts `off` samples into
// its batch.
struct NcoPos {
  uint32_t ph0, dp;
};

__device__ __forceinline__ NcoPos nco_pos(const long long* phase,
                                          const long long* dphase,
                                          long long off) {
  const uint32_t dp = (uint32_t)dphase[0];
  return NcoPos{(uint32_t)phase[0] + dp * (uint32_t)off, dp};
}

// Sample k of segment s of a batch folded into R rows (time-folded lanes:
// batch sample s*R + k), the tone of the NCO with phase ph0 + idx * dp at
// idx = s*R + k. A negative idx is the previous batch's sample by the
// uint32 wrap, and 0 on the stream's first batch (``first``). The sample
// loader of the live chains K9 and K12; K11 writes the same values.
__device__ __forceinline__ void nco_folded_sample(uint32_t ph0, uint32_t dp,
                                                  float amp, bool first, int R,
                                                  int s, int k,
                                                  const SinCosCoeffs& co,
                                                  float* re, float* im) {
  const int idx = s * R + k;
  float r, i;
  nco_sample(ph0 + (uint32_t)idx * dp, amp, co, &r, &i);
  const bool pre = first && idx < 0;  // selected, not branched around
  *re = pre ? 0.f : r;
  *im = pre ? 0.f : i;
}

}  // namespace mathfns
