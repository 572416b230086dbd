// Config #0's live chain past 513 taps, the fixed-point NCO tone through a
// long real-tap FIR, as a uniformly partitioned overlap-save FFT
// convolution: K9's instance for the tap counts fir_source.cu's single
// spectrum cannot take (its largest transform, 1024 points, keeps 512
// outputs, so 513 taps). For Hopper (sm_90a).
//
// Replaces, with fir_source.cu, the TPU kernel
// newsched_tpu/ops/pallas/fir_source.py `fir_tone_step` (`_kernel`, its
// window from wbfm_chain.py `_gen_window`; K9 here), whose only limit on the
// taps is its window. The wrapper (ops/cuda/fir_source.py) picks the
// instance from the tap count alone.
//
// Layout and samples as fir_source.cu: a batch of 64*R samples is R rows of
// 128 lanes, lane s the re and lane 64+s the im of segment s; with x[j] the
// batch's j-th sample and D the decimation,
//
//   out[o, s] + j out[o, 64+s] = sum_t taps[t] * x[s*R + o*D - t],  o < R/D,
//
// the samples generated (mathfns.cuh nco_folded_sample), never read.
//
// Bound on the H100: the output's bytes, and the function's least
// arithmetic, an FFT convolution at its most economical length; at 1024
// taps and 2^21 samples 6.0 us, bound by the operations. The direct form
// costs 4 flops a tap and sample (8.6 GFLOP at 1024 taps, at least 0.13 ms
// on the FP32 cores). This instance cuts the taps into P = ceil(ntaps/512)
// partitions of L = 512 taps, partition p with the 1024-point spectrum
// H_p / N of taps [p*L, p*L + L) (the host's, float64 rounded once). Output
// block q, the batch indices [q*L, q*L + L), is
//
//   the last L points of IFFT( sum_p X_{q-p} H_p ),
//
// X_m the transform of the samples [m*L - L, m*L + L), aligned to the batch
// index j = 64*R*shard + s*R + row as fir_source.cu's transforms are. The
// partitions are summed in one fixed order, p = 0 .. P-1, each product and
// add rounded on its own, and the transform is fir_fft.cuh's, unchanged.
// So an output's value depends only on the samples and on j mod L: it is
// bit-identical for every tile and segment group, and for every batch split
// and time shard whose boundaries fall on multiples of L. At D > 1 the
// transforms run at the full rate and the rows o*D are kept.
//
// A block owns the output rows of a tile of T batch rows of GS segments and
// walks the output blocks that touch them in rounds of 8, one a warp
// (Q = 32 threads a transform). Each output block recomputes its P forward
// transforms, the samples generated straight into the thread's registers
// (thread t holds x[t + 32n]; the half X_{q-p-1} shares with X_{q-p} is
// kept in registers from one partition to the next, so an output block
// generates (P + 1) * L samples), so no window is staged and nothing bounds
// the partitions but the cost, P + 1 transforms an output block: the spectra
// sum in a shared buffer private to the thread, then the inverse transform
// of the conjugate, whose kept half waits in the exchange buffer. Where a
// round's output blocks are whole rows of the tile (R and T multiples of L,
// the default), the block gathers them into a [row][8 segments] tile and
// writes it by 2-D tensor copies (the TMA), which run while the next round
// computes; else 16-byte stores of 4 segments. The spectra are read through
// the L2 (__ldg; 8 KB a partition). The default block takes 16 segments,
// two rounds a tile. probes/stages.py times the stages (PERF.md).

#include "fir_fft.cuh"
#include "mathfns.cuh"

namespace {

using namespace firfft;

constexpr int kThreads = 256;
constexpr int kSegs = 64;  // fold width: segments = lane pairs
constexpr int kW = 2 * kSegs;
constexpr int kQ = 32;                 // N = 1024-point transforms
constexpr int kN = kQ * kQ;
constexpr int kL = kN / 2;             // outputs a transform, taps a partition
constexpr int kLgL = log2i(kL);
constexpr int kG = kThreads / kQ;      // transforms a round: one a warp
constexpr int kXS = kQ * (kQ + 1) + 1; // exchange buffer a transform
constexpr int kBox = 256;              // rows of a tensor copy, at most

struct Part {
  const float* tab;  // (2 + 2P, N): W_N^j (re, im), then H_p / N (re, im)
  float* out;        // (R / D, 128)
  int R, D;
  int T;             // batch rows per block (T / D output rows)
  int GS;            // segments per block: a power of 2, >= 8
  int NQ;            // output blocks a segment per block, at most
  int P;             // partitions of the taps
  int BR;            // > 0: output rows a round (L / D), written by tensor copies
};

// Shared memory in float2: the output tile of a round (BR rows of 8
// segments, re then im), the exchange buffers, the spectra's sums (a
// thread's own [k][t] slots), the twiddles W_N^(t*k) at [k][t], then one
// int a segment.
__host__ __device__ __forceinline__ int smem_float2(const Part& p) {
  return kG * p.BR + kG * kXS + kG * kN + kQ * kQ + (p.GS + 1) / 2;
}

// One block: segments [blockIdx.y*GS, +GS), batch rows [r0, r0+T) with r0 =
// blockIdx.x * T. The phase counter, its increment and the first-batch flag
// are read from the card; time shard `shard` starts shard * 64 * R samples
// into the batch, and only shard 0 has samples before the stream.
__global__ void __launch_bounds__(kThreads, 1)
fir_part_kernel(const long long* __restrict__ phase,
                const long long* __restrict__ dphase,
                const float* __restrict__ amp,
                const unsigned char* __restrict__ first, int shard,
                mathfns::SinCosCoeffs sc, Part p,
                const __grid_constant__ CUtensorMap omap) {
  extern __shared__ __align__(128) float2 sm2[];
  const int tid = threadIdx.x;
  const int GS = p.GS, D = p.D, T = p.T;
  const int gs_shift = __ffs(GS) - 1;
  const int r0 = blockIdx.x * T;
  const int s0 = blockIdx.y * GS;
  const float a = amp[0];
  const mathfns::NcoPos pos =
      mathfns::nco_pos(phase, dphase, (long long)shard * kSegs * p.R);
  const bool b0 = shard == 0 && first[0] != 0;
  // batch index of segment s's row r0
  const long long jb = ((long long)shard * kSegs + s0) * p.R + r0;

  float* ot = reinterpret_cast<float*>(sm2);  // p.BR > 0: the round's tile
  float2* xbuf = sm2 + kG * p.BR;
  float2* acc = xbuf + kG * kXS;
  float2* tw = acc + kG * kN;
  // where segment sl's row r0 sits in its output block: (jb + sl*R) mod L
  int* dl = reinterpret_cast<int*>(tw + kQ * kQ);
  for (int sl = tid; sl < GS; sl += kThreads)
    dl[sl] = (int)((jb + (long long)sl * p.R) & (kL - 1));
  for (int e = tid; e < kQ * kQ; e += kThreads) {
    const int k = e / kQ, t = e % kQ;
    tw[e] = make_float2(__ldg(p.tab + t * k), __ldg(p.tab + kN + t * k));
  }
  float wr[kQ / 2], wi[kQ / 2];  // W_Q^m = W_N^(m Q)
#pragma unroll
  for (int m = 0; m < kQ / 2; ++m) {
    wr[m] = __ldg(p.tab + m * kQ);
    wi[m] = __ldg(p.tab + kN + m * kQ);
  }
  __syncthreads();

  const int g = tid / kQ, t = tid % kQ;
  float2* xb = xbuf + g * kXS;
  float2* ac = acc + g * kN;
  const int n_slots = GS * p.NQ;
  // the largest offset of a segment's first output block before the tile
  int dmax = 0;
  for (int sl = 0; sl < GS; ++sl) dmax = max(dmax, dl[sl]);
  for (int r = 0; r * kG < n_slots; ++r) {
    // slot i: segment sl = i % GS, its iq-th output block touching the tile;
    // a warp's slot, so the test is uniform across the transform's threads
    const int i = r * kG + g, sl = i & (GS - 1), iq = i >> gs_shift;
    if (i < n_slots && iq <= ((dl[sl] + T - 1) >> kLgL)) {
      // segment row of X_q's first sample, j = q*L - L; X_{q-p} starts p*L
      // rows before it
      const int base = r0 + iq * kL - dl[sl] - kL;
      // X_{q-p-1}'s last L samples are X_{q-p}'s first L: a thread's n >= Q/2
      // are its n - Q/2 of the partition before, kept in (kr, ki)
      float kr[kQ / 2], ki[kQ / 2];
      for (int pp = 0; pp < p.P; ++pp) {
        float xr[kQ], xi[kQ];
        const int b = base - pp * kL + t;
#pragma unroll
        for (int n = 0; n < kQ / 2; ++n)
          mathfns::nco_folded_sample(pos.ph0, pos.dp, a, b0, p.R, s0 + sl,
                                     b + kQ * n, sc, &xr[n], &xi[n]);
        if (pp == 0) {
#pragma unroll
          for (int n = kQ / 2; n < kQ; ++n)
            mathfns::nco_folded_sample(pos.ph0, pos.dp, a, b0, p.R, s0 + sl,
                                       b + kQ * n, sc, &xr[n], &xi[n]);
        } else {
#pragma unroll
          for (int n = kQ / 2; n < kQ; ++n) {
            xr[n] = kr[n - kQ / 2];
            xi[n] = ki[n - kQ / 2];
          }
        }
#pragma unroll
        for (int n = 0; n < kQ / 2; ++n) {
          kr[n] = xr[n];
          ki[n] = xi[n];
        }
        fft<kQ>(xr, xi, xb, tw, t, wr, wi);
        // X[t + Q k] H_p[t + Q k], summed over the partitions in order
        const float* hr = p.tab + (2 + 2 * pp) * kN + t;
        const float* hi = hr + kN;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          cmul(xr[k], xi[k], __ldg(hr + kQ * k), __ldg(hi + kQ * k));
          float2& s = ac[k * kQ + t];
          s = pp ? make_float2(radd(s.x, xr[k]), radd(s.y, xi[k]))
                 : make_float2(xr[k], xi[k]);
        }
      }
      // the inverse transform as the forward one of the conjugate
      float xr[kQ], xi[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const float2 s = ac[k * kQ + t];
        xr[k] = s.x;
        xi[k] = -s.y;
      }
      fft<kQ>(xr, xi, xb, tw, t, wr, wi);
      // keep y[t + Q m] = conj(.) for m >= Q/2: output j = q*L + t + Q*(m - Q/2)
#pragma unroll
      for (int m = kQ / 2; m < kQ; ++m)
        xb[t + kQ * (m - kQ / 2)] = make_float2(xr[m], -xi[m]);
    }
    if (p.BR && tid == 0 && r > 0) tma_wait_read();  // the last round's tile
    __syncthreads();
    // this round's outputs to their rows
    if (p.BR) {
      // whole output blocks (every dl is 0): 8 segments from sl0 of the
      // iq-th block, BR rows; the tile [row][segment], re then im, then
      // tensor copies of (at most kBox rows x 8 lanes)
      const int sl0 = (r * kG) & (GS - 1), iq = (r * kG) >> gs_shift;
      for (int e = tid; e < kG * p.BR; e += kThreads) {
        const float2 v = xbuf[(e & (kG - 1)) * kXS + (e / kG) * D];
        ot[e] = v.x;
        ot[kG * p.BR + e] = v.y;
      }
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        const int row = (r0 + iq * kL) / D;
        for (int b = 0; b < p.BR; b += kBox) {
          tma_store(&omap, ot + kG * b, s0 + sl0, row + b);
          tma_store(&omap, ot + kG * (p.BR + b), kSegs + s0 + sl0, row + b);
        }
      }
      continue;  // the next round's first barrier orders the tile's reuse
    }
    // else 4 segments a 16-byte store where all 4 are in the round, else one
    // by one
    const int iq_a = (r * kG) >> gs_shift;
    const int iq_b = (min(n_slots, (r + 1) * kG) - 1) >> gs_shift;
    const int k_a = max(0, iq_a * kL - dmax), k_b = min(T, (iq_b + 1) * kL);
    const int o_a = (k_a + D - 1) / D, o_b = (k_b + D - 1) / D;
    const int qshift = gs_shift - 2;  // GS / 4 quads a row
#pragma unroll 2
    for (int e = tid; e < (o_b - o_a) << qshift; e += kThreads) {
      const int o = o_a + (e >> qshift), c = e & ((GS >> 2) - 1);
      float vr[4], vi[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // the output's place in segment sl's output blocks: iq-th, position
        // x mod L
        const int sl = 4 * c + u, x = dl[sl] + o * D;
        const int k = (x >> kLgL) * GS + sl - r * kG;
        ok[u] = k >= 0 && k < kG;
        const float2 v = ok[u] ? xbuf[k * kXS + (x & (kL - 1))]
                               : make_float2(0.f, 0.f);
        vr[u] = v.x;
        vi[u] = v.y;
      }
      float* row = p.out + (long long)(r0 / D + o) * kW + s0 + 4 * c;
      if (ok[0] && ok[1] && ok[2] && ok[3]) {
        *reinterpret_cast<float4*>(row) = make_float4(vr[0], vr[1], vr[2], vr[3]);
        *reinterpret_cast<float4*>(row + kSegs) =
            make_float4(vi[0], vi[1], vi[2], vi[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ok[u]) {
            row[u] = vr[u];
            row[kSegs + u] = vi[u];
          }
      }
    }
    __syncthreads();
  }
  if (p.BR && tid == 0) tma_wait_all();
}

}  // namespace

extern "C" int fir_part_launch(const long long* phase, const long long* dphase,
                               const float* amp, const unsigned char* first,
                               int shard, const float* tab, float* out, int R,
                               int D, int T, int GS, int NQ, int P, int BR,
                               const float* sincos_coeffs, void* stream) {
  const Part p{tab, out, R, D, T, GS, NQ, P, BR};
  if (D <= 0 || T <= 0 || T % D || R % T || GS < 8 || kSegs % GS ||
      (GS & (GS - 1)) || NQ <= 0 || P <= 0 || shard < 0 || BR < 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap omap{};
  if (BR) {
    // whole output blocks only: each round's box rows are its own; the map
    // holds the output's address, so a captured graph replays it
    if (R % kL || T % kL || kL % D || BR != kL / D || (BR > kBox && BR % kBox))
      return (int)cudaErrorInvalidValue;
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)kW, (cuuint64_t)(R / D)};
    const cuuint64_t strides[1] = {(cuuint64_t)kW * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)kG, (cuuint32_t)min(BR, kBox)};
    const cuuint32_t estrides[2] = {1, 1};
    if (encode(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides,
               box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_float2(p) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R / T, kSegs / GS);
  fir_part_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      phase, dphase, amp, first, shard, mathfns::load_sincos(sincos_coeffs), p,
      omap);
  return (int)cudaGetLastError();
}
