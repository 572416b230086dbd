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
// Time shards (a sharded graph's batch): one launch takes every shard,
// the shard the grid's z dimension. Shard z is a batch of R rows of its
// own, folded on its own and written to its own R/(D*Rd) audio rows. K10's
// shard z reads its rows at xp + z R rows and, before them, shard z-1's
// last B8 rows where they lie in xp (shard 0: carry), which is what a
// launch a shard from the previous shard's bottom rows read; K12's is
// shard `shard` + z, at its phase offset. So the audio equals the
// per-shard launches' bit for bit. K10 keeps a one-shard instance for
// nd = 1, the unsharded graphs' (BatchRows<false>).
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
// its plain version term for term. The FIR runs in direct form, ntaps
// multiply-adds per output: the TPU's banded Toeplitz products (a band of
// W8 + T/G rows per group of outputs) are the MXU's form of this loop, and
// the direct form has no structural zeros at all.
//
// Measured on the card (PERF.md, probes/stages.py), the xlate FIR and the
// staging of its samples took 45% and 38% of the routine, the staging as
// 4-byte loads of 4-segment rows (half a 32-byte sector a plane), a few in
// flight a thread. So a block now takes 8 segments, a row's re and im
// lanes whole sectors, and 512 threads: at config #1's 2040-row tiles
// that is 128 blocks, one an SM (211 KB of shared memory), 16 warps. K10
// stages a chunk's samples by asynchronous 8-byte copies (cp.async), all
// in flight at once; K12 generates them. The samples sit in shared memory
// as [row][segment] planes with a row stride P chosen on the host against
// bank conflicts; each thread computes kJ = 7 consecutive outputs of one
// segment with a sliding window of samples in registers, so a shared load
// feeds 7 complex multiply-adds (xlate_outputs), 7 taps at a time with no
// branch between them (the window's next loads issue a tap ahead), and a
// chunk is 448 outputs of 8 segments. The block keeps U and d of its whole
// range in shared memory and writes only the audio rows; the resampler
// takes its taps from shared memory and 4 segments a thread from 16-byte
// reads of d, each segment's sum in the same ascending order. A
// double-buffered form (the next chunk staged while this one computes)
// left room for only half the computing threads and ran slower; so did
// staging each phase's rows apart, and tensor copies of the rows (their
// 32-byte swizzle costs the xlate's reads). Tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mathfns.cuh"

namespace {

constexpr int kMaxThreads = 512;  // a block: 256 or 512 threads (host)
// consecutive xlate outputs a thread computes: odd, so that the kJ*D rows
// between neighbouring threads' windows can avoid a multiple of 32 banks
constexpr int kJ = 7;
constexpr int kSegs = 64;  // fold width: segments = lane pairs
constexpr int kW = 2 * kSegs;

struct Wbfm {
  const float2* crot;   // (ntaps,) rotated channel taps (re, im)
  const float* rtaps;   // (A,) resampler taps
  float* aud;           // (nd R / (D*Rd), 128) audio, duplicated halves
  int R, ntaps, D, Rd, A;  // R: rows a shard
  int T;                // batch rows per block tile (To = T / (D*Rd))
  int GS;               // segments per block
  int P;                // shared row stride of the sample planes (>= GS)
  int NT;               // threads a block
  int CU;               // xlate outputs per chunk: NT / GS * kJ
  float cos_t, sin_t, gain;
  mathfns::AtanCoeffs co;
};

__host__ __device__ __forceinline__ int n_u(const Wbfm& p) {
  return (p.T / (p.D * p.Rd) - 1) * p.Rd + p.A + 1;
}

__host__ __device__ __forceinline__ int chunk_rows(const Wbfm& p) {
  return (p.CU - 1) * p.D + p.ntaps;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Shared floats, each part from a 16-byte boundary: taps (2*ntaps),
// resampler taps (A), the two sample planes (chunk_rows * P each), U planes
// (2 * NU * GS), d (NU * GS).
__host__ __device__ __forceinline__ int smem_floats(const Wbfm& p) {
  return round4(2 * p.ntaps) + round4(p.A) + 2 * round4(chunk_rows(p) * p.P) +
         3 * n_u(p) * p.GS;
}

// Tap k of phase ph (k = kk mod kJ) for the kJ outputs: y[m0 + j - k]
// sits in slot (j - k) mod kJ; then y[m0 - k - 1] replaces y[m0 - k + kJ
// - 1], which no later tap needs. kk is a constant once unrolled.
__device__ __forceinline__ void xlate_step(const float* xr, const float* xi,
                                           const float2* taps, int P, int D,
                                           int rb, int ph, int k, int kk,
                                           float* wr, float* wi, float* ar,
                                           float* ai) {
  const float2 c = taps[ph + k * D];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int sl = (j - kk + kJ) % kJ;
    ar[j] = fmaf(c.x, wr[sl], ar[j]);
    ar[j] = fmaf(-c.y, wi[sl], ar[j]);
    ai[j] = fmaf(c.x, wi[sl], ai[j]);
    ai[j] = fmaf(c.y, wr[sl], ai[j]);
  }
  const int r = (rb - (k + 1) * D - ph) * P;
  wr[kJ - 1 - kk] = xr[r];
  wi[kJ - 1 - kk] = xi[r];
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
    // kJ taps at a time with no branch between them, so that the window's
    // next loads can be issued a step ahead; the phase's last K % kJ taps
    // one by one. Past the phase's last tap the window reads a row below
    // the staged ones (inside shared memory) and never uses it.
    int kb = 0;
    for (; kb + kJ <= K; kb += kJ) {
#pragma unroll
      for (int kk = 0; kk < kJ; ++kk)
        xlate_step(xr, xi, taps, P, D, rb, ph, kb + kk, kk, wr, wi, ar, ai);
    }
#pragma unroll
    for (int kk = 0; kk < kJ; ++kk)
      if (kb + kk < K)
        xlate_step(xr, xi, taps, P, D, rb, ph, kb + kk, kk, wr, wi, ar, ai);
  }
}

// One block: segments [blockIdx.y*GS, +GS), audio rows [o0, o0+To) with
// o0 = blockIdx.x * To, of shard blockIdx.z. `ld` stages the block's
// samples: ld.stage(xre, xim, at, s, k) puts segment s's k-th sample of
// the shard (k >= -B8) at xre[at], xim[at], now or by an asynchronous copy
// that ld.finish() waits for (each thread its own).
template <class Loader>
__device__ __forceinline__ void wbfm_tile(float* sm, const Wbfm& p,
                                          const Loader& ld) {
  const int tid = threadIdx.x;
  const int GS = p.GS, P = p.P, D = p.D, nt = p.ntaps;
  const int To = p.T / (D * p.Rd);
  const int o0 = blockIdx.x * To;
  const int s0 = blockIdx.y * GS;
  const int NU = n_u(p);
  const int mlo = o0 * p.Rd - p.A;  // first U of the block
  const int gs_shift = __ffs(GS) - 1;  // GS divides 64: a power of 2
  const int nth = blockDim.x;

  float2* taps = reinterpret_cast<float2*>(sm);
  float* rt = sm + round4(2 * nt);
  float* xbuf = rt + round4(p.A);
  float* ure = xbuf + 2 * round4(chunk_rows(p) * P);
  float* uim = ure + NU * GS;
  float* dd = uim + NU * GS;
  for (int t = tid; t < nt; t += nth) taps[t] = p.crot[t];
  for (int t = tid; t < p.A; t += nth) rt[t] = p.rtaps[t];

  // 1. U[mlo + i], i < NU, CU at a time: stage the chunk's samples (0
  //    past the block's last; K10 by asynchronous copies, all in flight
  //    at once), then each thread sums kJ consecutive outputs of one
  //    segment (xlate_outputs).
  const int k_hi = (mlo + NU - 1) * D;  // the block's last sample
  float* xre = xbuf;
  float* xim = xbuf + round4(chunk_rows(p) * P);
  const int mm0 = (tid >> gs_shift) * kJ, sl = tid & (GS - 1);
  for (int c0 = 0; c0 < NU; c0 += p.CU) {
    const int cu = min(p.CU, NU - c0);
    const int rows = ((cu + kJ - 1) / kJ * kJ - 1) * D + nt;
    const int k0 = (mlo + c0) * D - (nt - 1);
    __syncthreads();  // the previous chunk's reads are done
    // two segments at a time where the rows keep pairs 8-byte aligned
    const int w_shift = (P % 2 == 0 && GS % 2 == 0) ? 1 : 0;
    const int ps = gs_shift - w_shift;  // pairs (or segments) a row
#pragma unroll 2
    for (int e = tid; e < rows << ps; e += nth) {
      const int k = k0 + (e >> ps), sl_e = (e & ((1 << ps) - 1)) << w_shift;
      const int at = (e >> ps) * P + sl_e;
      if (k > k_hi) {
        for (int u = 0; u <= w_shift; ++u) xre[at + u] = xim[at + u] = 0.f;
      } else if (w_shift) {
        ld.stage2(xre, xim, at, s0 + sl_e, k);
      } else {
        ld.stage(xre, xim, at, s0 + sl_e, k);
      }
    }
    ld.finish();
    __syncthreads();
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
  for (int e = tid; e < (NU - 1) * GS; e += nth) {
    const int i = 1 + (e >> gs_shift), sl = e & (GS - 1);
    const float ar = ure[(i - 1) * GS + sl], ai = uim[(i - 1) * GS + sl];
    const float yr = ure[i * GS + sl], yi = uim[i * GS + sl];
    const float pr0 = __fadd_rn(__fmul_rn(ar, yr), __fmul_rn(ai, yi));
    const float pi0 = __fsub_rn(__fmul_rn(ar, yi), __fmul_rn(ai, yr));
    const float pr = __fadd_rn(__fmul_rn(p.cos_t, pr0), __fmul_rn(p.sin_t, pi0));
    const float pi = __fsub_rn(__fmul_rn(p.cos_t, pi0), __fmul_rn(p.sin_t, pr0));
    dd[i * GS + sl] = __fmul_rn(mathfns::atan2_poly(pi, pr, p.co), p.gain);
  }
  __syncthreads();

  // 3. y[o0 + o] = sum_k r[k] * d[(o0+o)*Rd - k], to both halves: 4
  //    segments a thread where GS allows (16-byte reads of d), each summed
  //    on its own in ascending k. The shard's audio rows follow the shards
  //    before it (its pointer made here, not live through stages 1-2).
  float* const aud =
      p.aud + (long long)ld.shard() * (p.R / (D * p.Rd)) * kW;
  if (GS % 4 == 0) {
    const int q_shift = gs_shift - 2;
    for (int e = tid; e < To << q_shift; e += nth) {
      const int o = e >> q_shift, c = 4 * (e & ((GS >> 2) - 1));
      const float4* col =
          reinterpret_cast<const float4*>(dd + (o * p.Rd + p.A) * GS + c);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < p.A; ++k) {
        const float r = rt[k];
        const float4 v = col[-k * (GS >> 2)];
        acc.x = fmaf(r, v.x, acc.x);
        acc.y = fmaf(r, v.y, acc.y);
        acc.z = fmaf(r, v.z, acc.z);
        acc.w = fmaf(r, v.w, acc.w);
      }
      float* row = aud + (long long)(o0 + o) * kW + s0 + c;
      *reinterpret_cast<float4*>(row) = acc;
      *reinterpret_cast<float4*>(row + kSegs) = acc;
    }
  } else {
    for (int e = tid; e < To * GS; e += nth) {
      const int o = e >> gs_shift, sl = e & (GS - 1);
      const float* col = dd + (o * p.Rd + p.A) * GS + sl;
      float acc = 0.f;
      for (int k = 0; k < p.A; ++k) acc = fmaf(rt[k], col[-k * GS], acc);
      float* row = aud + (long long)(o0 + o) * kW;
      row[s0 + sl] = acc;
      row[kSegs + s0 + sl] = acc;
    }
  }
}

// K10: samples read from the folded batch xp (nd R, 128), shard z's R
// rows from row z R, by asynchronous 8-byte copies of two segments (4-byte
// ones where the row stride is odd); before the shard's row 0, from the
// previous segment's last rows, or for segment 0 from the previous shard's
// last B8 rows (shard 0: carry (B8, 128), the previous batch's). The
// shard's rows are offsets from the kernel's arguments, made where they are
// read, so no pointer of the shard stays live in registers (one that did
// made the kernel spill). !kShards (nd = 1, the unsharded graphs) leaves
// the shard's offsets out, which cost the one-shard launch ~3% on the
// card (PERF.md).
template <bool kShards>
struct BatchRows {
  const float* xp;
  const float* carry;
  int B8, R;
  __device__ __forceinline__ static int shard() {
    return kShards ? (int)blockIdx.z : 0;
  }
  // row k of shard z (k < 0: the shard before's row R + k)
  __device__ __forceinline__ const float* batch_row(long long k) const {
    return xp + ((long long)shard() * R + k) * kW;
  }
  template <int B>
  __device__ __forceinline__ static void copy(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src), "n"(B) : "memory");
  }
  // segments s and s+1 (s even)
  __device__ __forceinline__ void stage2(float* xre, float* xim, int at, int s,
                                         int k) const {
    if (k >= 0) {
      const float* row = batch_row(k) + s;
      copy<8>(xre + at, row);
      copy<8>(xim + at, row + kSegs);
    } else {
      stage(xre, xim, at, s, k);
      stage(xre, xim, at + 1, s + 1, k);
    }
  }
  __device__ __forceinline__ void stage(float* xre, float* xim, int at, int s,
                                        int k) const {
    if (k >= 0) {
      const float* row = batch_row(k) + s;
      copy<4>(xre + at, row);
      copy<4>(xim + at, row + kSegs);
      return;
    }
    const float* row;
    int lane = s;
    if (s > 0) {
      row = batch_row(R + k);
      lane = s - 1;
    } else {
      row = shard() ? batch_row(k) : carry + (long long)(B8 + k) * kW;
      lane = kSegs - 1;
    }
    xre[at] = __ldg(row + lane);
    xim[at] = __ldg(row + kSegs + lane);
  }
  __device__ __forceinline__ void finish() const {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

template <bool kShards>
__global__ void __launch_bounds__(kMaxThreads)
wbfm_chain_kernel(const float* __restrict__ xp, const float* __restrict__ carry,
                  int B8, Wbfm p) {
  extern __shared__ __align__(16) float sm[];
  wbfm_tile(sm, p, BatchRows<kShards>{xp, carry, B8, p.R});
}

// K12: samples generated from the NCO's phase counter (on the card): sample
// index s*R + k of the shard (negative: the previous shard or batch, by the
// uint32 wrap; 0 before the stream on the stream's first batch, the flag
// `first` on the card, which only time shard 0 of a batch reads). Block
// z's shard is `shard` + z.
struct ToneRows {
  mathfns::NcoPos pos;
  float a;
  bool b0;
  int R;
  mathfns::SinCosCoeffs sc;
  __device__ __forceinline__ static int shard() { return blockIdx.z; }
  __device__ __forceinline__ void stage(float* xre, float* xim, int at, int s,
                                        int k) const {
    mathfns::nco_folded_sample(pos.ph0, pos.dp, a, b0, R, s, k, sc, xre + at,
                               xim + at);
  }
  __device__ __forceinline__ void stage2(float* xre, float* xim, int at, int s,
                                         int k) const {
    stage(xre, xim, at, s, k);
    stage(xre, xim, at + 1, s + 1, k);
  }
  __device__ __forceinline__ void finish() const {}
};

__global__ void __launch_bounds__(kMaxThreads)
wbfm_live_kernel(const long long* __restrict__ phase,
                 const long long* __restrict__ dphase,
                 const float* __restrict__ amp,
                 const unsigned char* __restrict__ first, int shard0,
                 mathfns::SinCosCoeffs sc, Wbfm p) {
  extern __shared__ __align__(16) float sm[];
  const int shard = shard0 + blockIdx.z;
  const mathfns::NcoPos pos =
      mathfns::nco_pos(phase, dphase, (long long)shard * kSegs * p.R);
  wbfm_tile(sm, p,
            ToneRows{pos, amp[0], shard == 0 && first[0] != 0, p.R, sc});
}

Wbfm make(const float* crot, const float* rtaps, float* aud, int R, int ntaps,
          int D, int Rd, int A, int T, int GS, int P, int NT, int CU,
          float cos_t, float sin_t, float gain, const float* atan_coeffs) {
  return Wbfm{reinterpret_cast<const float2*>(crot), rtaps, aud, R, ntaps, D,
              Rd, A, T, GS, P, NT, CU, cos_t, sin_t, gain,
              mathfns::load_atan(atan_coeffs)};
}

bool bad_geometry(const Wbfm& p) {
  const int step = p.D * p.Rd;
  return p.T <= 0 || p.T % step || p.R % p.T || p.GS <= 0 || kSegs % p.GS ||
         p.P < p.GS || p.NT <= 0 || p.NT > kMaxThreads || p.NT % 32 ||
         p.NT % p.GS || p.CU != p.NT / p.GS * kJ || p.ntaps <= 0 || p.A <= 0;
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
                                 float* aud, int R, int nd, int ntaps, int D,
                                 int Rd,
                                 int A, int B8, int T, int GS, int P, int NT,
                                 int CU, float cos_t, float sin_t, float gain,
                                 const float* atan_coeffs, void* stream) {
  const Wbfm p = make(crot, rtaps, aud, R, ntaps, D, Rd, A, T, GS, P, NT, CU,
                      cos_t, sin_t, gain, atan_coeffs);
  if (bad_geometry(p) || R < B8 || nd < 1 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  const auto kernel =
      nd > 1 ? wbfm_chain_kernel<true> : wbfm_chain_kernel<false>;
  size_t smem;
  const int err = set_smem(kernel, p, &smem);
  if (err) return err;
  const dim3 grid(R / T, kSegs / GS, nd);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(xp, carry, B8, p);
  return (int)cudaGetLastError();
}

extern "C" int wbfm_live_launch(const long long* phase,
                                const long long* dphase, const float* amp,
                                const unsigned char* first, int shard,
                                const float* crot,
                                const float* rtaps, float* aud, int R, int nd,
                                int ntaps, int D, int Rd, int A, int B8, int T,
                                int GS, int P, int NT, int CU, float cos_t,
                                float sin_t, float gain,
                                const float* atan_coeffs,
                                const float* sincos_coeffs, void* stream) {
  const Wbfm p = make(crot, rtaps, aud, R, ntaps, D, Rd, A, T, GS, P, NT, CU,
                      cos_t, sin_t, gain, atan_coeffs);
  if (bad_geometry(p) || R < B8 || shard < 0 || nd < 1 || nd > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem;
  const int err = set_smem(wbfm_live_kernel, p, &smem);
  if (err) return err;
  const dim3 grid(R / T, kSegs / GS, nd);
  wbfm_live_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      phase, dphase, amp, first, shard, mathfns::load_sincos(sincos_coeffs),
      p);
  return (int)cudaGetLastError();
}
