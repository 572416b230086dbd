// Config #0's live chain, the fixed-point NCO tone through a real-tap FIR,
// as one kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel newsched_tpu/ops/pallas/fir_source.py
// `fir_tone_step` (`_kernel`, its window from wbfm_chain.py `_gen_window`;
// K9 here).
//
// Layout (time-folded lanes, as the wideband-FM chain's): a batch of 64*R
// samples is R rows of 128 lanes; lane s holds re and lane 64+s im of
// segment s, samples s*R .. s*R+R-1. With x[j] the batch's j-th sample
// (j < 0: the samples before it in the stream) and D the decimation,
//
//   out[o, s] + j out[o, 64+s] = sum_t taps[t] * x[s*R + o*D - t],  o < R/D.
//
// The samples are generated, never read: mathfns.cuh nco_folded_sample,
// the values of the NCO sources K8/K11 (sources.cu) and of K12's loader,
// with the previous batch's samples by the uint32 wrap and 0 before the
// stream on the first batch.
//
// Bound on the H100 at config #0 (128 taps, D = 1, 2^21 samples a batch):
// 16.8 MB of output written and nothing read, 5.0 us at 3.35 TB/s. The
// direct form costs 4 flops a tap and sample, 1.07 GFLOP, at least 16 us
// on the FP32 cores, so it could not come within 3x of the bound. This
// kernel takes the FIR as an overlap-save FFT convolution: N = Q*Q points
// (Q = 8, 16 or 32: the smallest with N/2 >= ntaps - 1; N = 256 at 128
// taps), L = N/2 outputs a transform, ~120 operations a complex output
// against 512. The transforms are aligned to the batch index j = 64*R*shard
// + s*R + row at multiples of L, not to the block: transform q takes the
// samples j in [q*L - L, q*L + L) and keeps the outputs j in [q*L, q*L+L).
// A block owns the output rows of a tile of T batch rows of GS segments
// (GS >= 8, so that each row's re and im lanes are whole 32-byte sectors)
// and computes every transform that touches them, whole, writing only its
// own rows. So an output's value depends only on the samples and on j mod
// L: it is bit-identical for every tile and segment group, and for every
// batch split and time shard whose boundaries fall on multiples of L. At
// D > 1 the transforms run at the full rate and the rows o*D are kept.
//
// A block: (1) generates its window of samples once into shared memory,
// [row][segment] complex with a row stride chosen on the host against
// bank conflicts; (2) walks its transforms in rounds of 256/Q, one
// transform to Q threads: thread t loads x[t + Q*n2], a radix-Q DFT over
// n2, times W_N^(t*k1), an exchange through the transform's own padded
// shared buffer, a radix-Q DFT over n1 gives X[t + Q*k2]; times the taps'
// spectrum (1/N folded in), and the inverse as the same transform of the
// conjugate; (3) each round's kept outputs wait in the exchange buffers.
// Where a round's transforms fill whole rows of the tile (the default
// geometry), the block gathers them into a [row][lane] tile and writes it
// by two 2-D tensor copies (the TMA), one a plane: a block's rows are 32
// bytes a plane, and through the load/store unit such slices cost 3x the
// same bytes written contiguously (PERF.md). Elsewhere it writes 16-byte
// stores of 4 segments. The twiddles and the spectrum are the host's,
// float64 rounded to float32 (ops/cuda/fir_source.py fir_tone_table), and
// every add and multiply of the transforms is rounded on its own
// (__fadd_rn/__fmul_rn, never contracted), so a transform's arithmetic is
// the same wherever it runs; tests/test_torch_fir_fft.py repeats it in
// torch float32. Measured at config #0, the samples take ~38% of the
// kernel, the transforms ~46%, the writes ~16%.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fir_fft.cuh"
#include "mathfns.cuh"

namespace {

using namespace firfft;

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // samples a thread generates per pass
constexpr int kSegs = 64;  // fold width: segments = lane pairs
constexpr int kW = 2 * kSegs;

struct Fir {
  const float* tab;  // (4, N): W_N^j (re, im), then the taps' spectrum / N
  float* out;        // (R / D, 128)
  int R, D;
  int T;             // batch rows per block (T / D output rows)
  int GS;            // segments per block: a power of 2, >= 8
  int NQ;            // transforms a segment per block, at most
  int off;           // the window starts `off` rows before the tile
  int WR;            // window rows
  int PW;            // window row stride in complex values (>= GS)
  int BR;            // > 0: output rows a round, written by a tensor copy
};

template <int Q>
struct Geo {
  static constexpr int N = Q * Q;
  static constexpr int L = N / 2;
  static constexpr int G = kThreads / Q;  // transforms a round
  // exchange buffer a transform: odd, so that the copy-out's reads of
  // consecutive transforms fall on distinct banks
  static constexpr int XS = Q * (Q + 1) + 1;
};

// Shared memory in float2: the output tile of a round (BR rows of GS
// floats, re then im; 128-byte aligned for the tensor copy), the window,
// the exchange buffers, the twiddles W_N^(t*k) at [k][t], the spectrum,
// then one int a segment.
template <int Q>
__host__ __device__ __forceinline__ int smem_float2(const Fir& p) {
  using Gq = Geo<Q>;
  return (p.BR * p.GS + 15) / 16 * 16 + p.WR * p.PW + Gq::G * Gq::XS + Q * Q +
         Gq::N + (p.GS + 1) / 2;
}

// One block: segments [blockIdx.y*GS, +GS), batch rows [r0, r0+T) with r0
// = blockIdx.x * T. The phase counter, its increment and the first-batch
// flag are read from the card (the stream state of the runner's captured
// graph); time shard `shard` starts shard * 64 * R samples into the batch,
// and only shard 0 has samples before the stream.
template <int Q>
__global__ void __launch_bounds__(kThreads, 2)
fir_tone_kernel(const long long* __restrict__ phase,
                const long long* __restrict__ dphase,
                const float* __restrict__ amp,
                const unsigned char* __restrict__ first, int shard,
                mathfns::SinCosCoeffs sc, Fir p,
                const __grid_constant__ CUtensorMap omap) {
  using Gq = Geo<Q>;
  constexpr int N = Gq::N, L = Gq::L, G = Gq::G, XS = Gq::XS;
  constexpr int lgL = log2i(L);
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
  float2* win = sm2 + (p.BR * GS + 15) / 16 * 16;
  float2* xbuf = win + p.WR * p.PW;
  float2* tw = xbuf + G * XS;
  float2* hs = tw + Q * Q;
  // where segment sl's row r0 sits in its transform: (jb + sl*R) mod L
  int* dl = reinterpret_cast<int*>(hs + N);
  for (int sl = tid; sl < GS; sl += kThreads)
    dl[sl] = (int)((jb + (long long)sl * p.R) & (L - 1));
  for (int e = tid; e < Q * Q; e += kThreads) {
    const int k = e / Q, t = e % Q;
    tw[e] = make_float2(__ldg(p.tab + t * k), __ldg(p.tab + N + t * k));
  }
  for (int e = tid; e < N; e += kThreads)
    hs[e] = make_float2(__ldg(p.tab + 2 * N + e), __ldg(p.tab + 3 * N + e));
  float wr[Q / 2], wi[Q / 2];  // W_Q^m = W_N^(m Q)
#pragma unroll
  for (int m = 0; m < Q / 2; ++m) {
    wr[m] = __ldg(p.tab + m * Q);
    wi[m] = __ldg(p.tab + N + m * Q);
  }

  // (1) the window: rows [r0 - off, r0 - off + WR) of the GS segments,
  //     kLoads samples a thread in flight before any is stored
  const int n_win = p.WR * GS, k0 = r0 - p.off;
  for (int e0 = tid; e0 < n_win; e0 += kLoads * kThreads) {
    float re[kLoads], im[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {  // past the window: its last sample
      const int e = min(e0 + u * kThreads, n_win - 1);
      mathfns::nco_folded_sample(pos.ph0, pos.dp, a, b0, p.R,
                                 s0 + (e & (GS - 1)), k0 + (e >> gs_shift),
                                 sc, &re[u], &im[u]);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n_win)
        win[(e >> gs_shift) * p.PW + (e & (GS - 1))] = make_float2(re[u], im[u]);
    }
  }
  __syncthreads();

  const int g = tid / Q, t = tid % Q;
  float2* xb = xbuf + g * XS;
  const int n_slots = GS * p.NQ;
  // the largest offset of a segment's first transform before the tile
  int dmax = 0;
  for (int sl = 0; sl < GS; ++sl) dmax = max(dmax, dl[sl]);
  for (int r = 0; r * G < n_slots; ++r) {
    // (2) transform of slot i: segment sl = i % GS, iq = i / GS
    {
      const int i = r * G + g, sl = i & (GS - 1), iq = i >> gs_shift;
      const bool live = i < n_slots && iq <= ((dl[sl] + T - 1) >> lgL);
      // window row of the transform's first sample j = q*L - L
      const int base = live ? iq * L - dl[sl] - L + p.off : 0;
      float xr[Q], xi[Q];
#pragma unroll
      for (int n = 0; n < Q; ++n) {
        const float2 v = win[(base + t + Q * n) * p.PW + sl];
        xr[n] = v.x;
        xi[n] = v.y;
      }
      fft<Q>(xr, xi, xb, tw, t, wr, wi);
      // Z = conj(X H): the inverse transform as the forward one of Z
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float2 h = hs[t + Q * k];
        cmul(xr[k], xi[k], h.x, h.y);
        xi[k] = -xi[k];
      }
      fft<Q>(xr, xi, xb, tw, t, wr, wi);
      // keep y[t + Q m] = conj(.) for m >= Q/2: output j = q*L + t + Q*(m - Q/2)
#pragma unroll
      for (int m = Q / 2; m < Q; ++m)
        xb[t + Q * (m - Q / 2)] = make_float2(xr[m], -xi[m]);
    }
    if (p.BR && tid == 0 && r > 0) tma_wait_read();  // the last round's tile
    __syncthreads();
    // (3) this round's outputs to their rows: 4 segments a 16-byte store
    //     where all 4 are in the round, else one by one
    const int iq_a = (r * G) >> gs_shift;
    const int iq_b = (min(n_slots, (r + 1) * G) - 1) >> gs_shift;
    const int k_a = max(0, iq_a * L - dmax), k_b = min(T, (iq_b + 1) * L);
    const int o_a = (k_a + D - 1) / D, o_b = (k_b + D - 1) / D;
    if (p.BR) {
      // whole rows of whole transforms: the tile [row][segment], re then
      // im, then two tensor copies of (BR rows x GS lanes)
      for (int e = tid; e < (o_b - o_a) << gs_shift; e += kThreads) {
        const int sl = e & (GS - 1), x = (o_a + (e >> gs_shift)) * D;
        const float2 v =
            xbuf[((x >> lgL) * GS + sl - r * G) * XS + (x & (L - 1))];
        ot[e] = v.x;
        ot[p.BR * GS + e] = v.y;
      }
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        tma_store(&omap, ot, s0, r0 / D + o_a);
        tma_store(&omap, ot + p.BR * GS, kSegs + s0, r0 / D + o_a);
      }
      continue;  // the next round's first barrier orders the tile's reuse
    }
    const int qshift = gs_shift - 2;  // GS / 4 quads a row
#pragma unroll 2
    for (int e = tid; e < (o_b - o_a) << qshift; e += kThreads) {
      const int o = o_a + (e >> qshift), c = e & ((GS >> 2) - 1);
      float vr[4], vi[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // the output's place in segment sl's transforms: iq-th, position
        // x mod L
        const int sl = 4 * c + u, x = dl[sl] + o * D;
        const int i = (x >> lgL) * GS + sl - r * G;
        ok[u] = i >= 0 && i < G;
        const float2 v = ok[u] ? xbuf[i * XS + (x & (L - 1))]
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

template <int Q>
int launch(const long long* phase, const long long* dphase, const float* amp,
           const unsigned char* first, int shard, Fir p,
           const float* sincos_coeffs, cudaStream_t stream) {
  using Gq = Geo<Q>;
  const size_t smem = (size_t)smem_float2<Q>(p) * sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      fir_tone_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap omap{};
  if (p.BR) {
    // the output (R/D rows of 128 floats), a box of GS lanes x BR rows; the
    // map holds the output's address, so a captured graph replays it
    // whole rounds of whole rows only: a round's outputs fill its box
    const int per_round = Gq::G / p.GS * Gq::L / p.D;
    if (p.R % Gq::L || p.T % Gq::L || Gq::G % p.GS || Gq::L % p.D ||
        p.NQ % (Gq::G / p.GS) || p.BR != per_round || p.BR * p.GS % 32)
      return (int)cudaErrorInvalidValue;
    const EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)kW, (cuuint64_t)(p.R / p.D)};
    const cuuint64_t strides[1] = {(cuuint64_t)kW * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)p.GS, (cuuint32_t)p.BR};
    const cuuint32_t estrides[2] = {1, 1};
    if (encode(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p.out, dims, strides,
               box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(p.R / p.T, kSegs / p.GS);
  fir_tone_kernel<Q><<<grid, kThreads, smem, stream>>>(
      phase, dphase, amp, first, shard, mathfns::load_sincos(sincos_coeffs), p,
      omap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fir_tone_launch(const long long* phase, const long long* dphase,
                               const float* amp, const unsigned char* first,
                               int shard, const float* tab, float* out, int R,
                               int Q, int D, int T, int GS, int NQ, int off,
                               int WR, int PW, int BR,
                               const float* sincos_coeffs, void* stream) {
  const Fir p{tab, out, R, D, T, GS, NQ, off, WR, PW, BR};
  if (D <= 0 || T <= 0 || T % D || R % T || GS < 8 || kSegs % GS ||
      (GS & (GS - 1)) || PW < GS || NQ <= 0 || WR <= 0 || off < 0 ||
      BR < 0 || BR > 256 || shard < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Q) {
    case 8: return launch<8>(phase, dphase, amp, first, shard, p, sincos_coeffs, s);
    case 16: return launch<16>(phase, dphase, amp, first, shard, p, sincos_coeffs, s);
    case 32: return launch<32>(phase, dphase, amp, first, shard, p, sincos_coeffs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
