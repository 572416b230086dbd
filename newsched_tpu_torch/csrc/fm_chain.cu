// The fused FM channelizer chain on planes rows, for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/fm_chain.py
// `fm_chain_step_planes` (`_kernel`, `_compute_tile`; K3 here) and
// `fm_chain_gen_step` (`_kernel_gen`; K5 here); their device function
// newsched_tpu/ops/pallas/mathfns.py `atan2` is in mathfns.cuh. Per
// stream row t:
//
//   acc[t]  = sum_q c2[q] * vp[t + off + q]        L-tap arm fold
//   Y[t]    = acc[t] @ W2                          (2M x 2M) real DFT
//   aud[t]  = atan2(PI, PR) * gain                 quadrature demod of
//             PR + j PI = conj(Y[t-1]) * Y[t]      each of the M channels
//   out[o]  = sum_k ataps[k] * aud[o*decim - k]    decimating audio FIR
//
// with vp = [halo; vb] (the H8 rows before the batch, then the batch),
// Y[-1] = prev0 and aud[t<0] from tail0, the carried state.
//
// The two kernels differ only in where a block's input rows come from. K3
// reads vb and halo from device memory. K5 generates them: row t >= 0 of
// the batch is amp * gauss(seed, group g0, row t, lane) (philox.cuh, the
// stream of the noise kernel K4), and the halo comes from carry0, the
// previous batch's last H8 generated rows (zeros at stream start); K5
// returns this batch's last H8 rows as the next carry. Everything after
// the rows is one routine (chain_tile), so K5's outputs equal
// K4 -> K3's bit for bit.
//
// The TPU grid runs its tiles in order and carries Y[t-1] and the audio
// tail from tile to tile in VMEM. CUDA blocks run in no order, so each
// block recomputes its own junction instead: the block for output rows
// [t0, t0+T) folds input rows [t0-A-(L-1), t0+T), computes Y over
// [t0-A, t0+T) and aud over [t0-(A-1), t0+T). Only blocks that reach back
// before the batch (the first, and for T < A a few more) read prev0/tail0.
// Every value is computed by the same code with the same summation order
// whichever block computes it, so the outputs are bit-identical for every
// tile size T.
//
// Bound on the H100: the DFT matmul, 2*(2M)^2 flops per row (32 KFLOP at
// M=64) against 2M*4 bytes read per row: ~64 flops/byte, compute-bound in
// FP32 on the CUDA cores, and more so by the junction recompute (A rows
// per tile: +51% at T=128, +75% with the padding to 32-row passes). That
// is the work of this formulation (the TPU's MXU form), not the least work
// of the function: an M-point FFT a row takes ~5 M log2 M flops (1,920 at
// M=64, 17x fewer), under which K3's least time is its bytes and K5's its
// Philox (chip_smoke.py kernel_bounds). As on the TPU, Y and aud never
// leave the chip:
// the block keeps its (T+A, 2M) tile in shared memory (112 KB at T=128),
// turns Y into aud in place, and writes only the T/decim audio rows.
// The block first loads (K3) or generates (K5) its window of T+A+L-1
// input rows into that same buffer, once, and folds it in place, 32 rows
// a pass, so the fold's L reads per output come from shared memory and
// K5 generates each value once per block that needs it (1.6x per row at
// T=128, for the junction), not once per tap. The window fits in the
// padded tile at T = 64, 128 and 256 (at most L-1 more rows elsewhere).
// The matmul is a plain register-tiled FP32 loop (tile_mm.cuh). Tensor
// cores (TF32/3xTF32) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mathfns.cuh"
#include "philox.cuh"
#include "tile_mm.cuh"

namespace {

using mathfns::AtanCoeffs;
using mathfns::atan2_poly;

constexpr int kThreads = tile_mm::kThreads;
constexpr int kChunkRows = tile_mm::kPassRows;
constexpr int kW = tile_mm::kW;  // planes lanes, 2M for M = 64 channels
constexpr int kM = kW / 2;

// What the two chain kernels share: constants, carried state in and out,
// and the tile geometry.
struct Chain {
  const float* c2;     // (L, W) fold taps
  const float* w2;     // (W, W) planes DFT matrix
  const float* ataps;  // (A,) audio taps
  const float* prev0;  // (1, W)
  const float* tail0;  // (A-1, W)
  float* aud;          // (n/decim, M)
  float* prev_out;     // (1, W)
  float* tail_out;     // (A-1, W)
  int n, L, H8, A, decim, T;
  float gain;
  AtanCoeffs co;
};

__global__ void atan2_kernel(const float* __restrict__ y,
                             const float* __restrict__ x,
                             float* __restrict__ out, long long n,
                             AtanCoeffs co) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = atan2_poly(y[i], x[i], co);
}

__host__ __device__ __forceinline__ int pad_rows(int rows) {
  return (rows + kChunkRows - 1) / kChunkRows * kChunkRows;
}

// Rows of the tile buffer: the padded (T+A)-row tile, and the window of
// T+A+L-1 input rows it is folded from in place.
__host__ __device__ __forceinline__ int tile_rows(int T, int A, int L) {
  const int r = pad_rows(T + A);
  return r > T + A + L - 1 ? r : T + A + L - 1;
}

// One block's tile of T stream rows, both kernels: the block's input rows
// come from `row(sr, k)` (stream row sr of the batch, lane k; sr < 0 is
// the carried halo), everything after is the same code.
template <class Row>
__device__ __forceinline__ void chain_tile(float* buf, const Chain& p,
                                           Row row) {
  constexpr int W = kW, M = kM;
  const int t0 = blockIdx.x * p.T;
  const int A = p.A, L = p.L;
  const int R = p.T + A;
  const int R_pad = pad_rows(R);
  const int tid = threadIdx.x;
  const bool last = blockIdx.x == gridDim.x - 1;

  // 1a. The window: buffer row ii holds input stream row t0 - A - (L-1) + ii.
  for (int idx = tid; idx < (R + L - 1) * W; idx += kThreads) {
    const int ii = idx / W, k = idx % W;
    buf[idx] = row(t0 - A - (L - 1) + ii, k);
  }
  __syncthreads();

  // 1b. Arm fold in place, kChunkRows rows a pass: acc of stream row
  //     t0 - A + jj (0 before the stream and in the padding rows) goes to
  //     row jj. Every read of a pass (window rows r0 .. r0+31+L-1)
  //     happens before its writes (rows r0 .. r0+31), and later passes
  //     read only rows past r0+31. Per lane: c2[0]*v, then fmaf in order.
  constexpr int kPer = kChunkRows * W / kThreads;  // 16 rows per thread
  {
    const int k = tid % W, h = tid / W;
    for (int r0 = 0; r0 < R_pad; r0 += kChunkRows) {
      float v[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int jj = r0 + h * kPer + e;
        v[e] = 0.f;
        if (jj < R && t0 - A + jj >= 0) {
          float acc = __ldg(p.c2 + k) * buf[jj * W + k];
          for (int q = 1; q < L; ++q)
            acc = fmaf(__ldg(p.c2 + q * W + k), buf[(jj + q) * W + k], acc);
          v[e] = acc;
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kPer; ++e) buf[(r0 + h * kPer + e) * W + k] = v[e];
      __syncthreads();
    }
  }

  // 2. Y = acc @ W2 in place, kChunkRows rows a pass.
  const int tx = tid & 31, ty = tid >> 5;
  for (int r0 = 0; r0 < R_pad; r0 += kChunkRows) {
    float o[4][4];
    tile_mm::pass(buf + r0 * W, p.w2, o);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(buf + (r0 + 4 * ty + i) * W + 4 * tx) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    __syncthreads();
  }
  if (t0 < A)  // the tile reaches back to Y[-1], the carried row
    for (int k = tid; k < W; k += kThreads)
      buf[(A - 1 - t0) * W + k] = p.prev0[k];
  if (last)  // Y[n-1], before the demod overwrites it
    for (int k = tid; k < W; k += kThreads)
      p.prev_out[k] = buf[(R - 1) * W + k];
  __syncthreads();

  // 3. Demod in place, from the last row down: aud[jj] needs Y[jj-1] and
  //    Y[jj], and is written into row jj's re half only after the chunk's
  //    reads, so lower chunks still find their Y rows intact.
  constexpr int kElems = 4;
  constexpr int kDemodRows = kElems * kThreads / M;
  for (int hi = R; hi > 1;) {
    const int lo = hi - kDemodRows > 1 ? hi - kDemodRows : 1;
    float val[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int idx = tid + e * kThreads;
      const int jj = lo + idx / M, m = idx % M;
      val[e] = 0.f;
      if (jj < hi) {
        const int t = t0 - A + jj;
        if (t < 0) {
          val[e] = p.tail0[(A - 1 + t) * W + m];
        } else {
          const float* pa = buf + (jj - 1) * W;
          const float* py = buf + jj * W;
          const float ar = pa[m], ai = pa[m + M], yr = py[m], yi = py[m + M];
          const float pr = ar * yr + ai * yi;
          const float pi = ar * yi - ai * yr;
          val[e] = atan2_poly(pi, pr, p.co) * p.gain;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int idx = tid + e * kThreads;
      const int jj = lo + idx / M, m = idx % M;
      if (jj < hi) buf[jj * W + m] = val[e];
    }
    __syncthreads();
    hi = lo;
  }
  if (last)  // the last A-1 aud rows, duplicated in both halves
    for (int idx = tid; idx < (A - 1) * M; idx += kThreads) {
      const int i = idx / M, m = idx % M;
      const float v = buf[(R - (A - 1) + i) * W + m];
      p.tail_out[i * W + m] = v;
      p.tail_out[i * W + M + m] = v;
    }

  // 4. Decimating audio FIR: out[o] = sum_k ataps[k] * aud[o*decim - k].
  const int n_o = p.T / p.decim;
  for (int idx = tid; idx < n_o * M; idx += kThreads) {
    const int o = idx / M, m = idx % M;
    const float* col = buf + (A + o * p.decim) * W + m;
    float acc = 0.f;
    for (int k = 0; k < A; ++k) acc = fmaf(__ldg(p.ataps + k), col[-k * W], acc);
    p.aud[((long long)t0 / p.decim + o) * M + m] = acc;
  }
}

// K3: input rows read from memory, vp = [halo; vb].
__global__ void __launch_bounds__(kThreads)
fm_chain_kernel(const float* __restrict__ vb, const float* __restrict__ halo,
                Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int H8 = p.H8;
  chain_tile(buf, p, [&](int sr, int k) {
    const int i = sr + H8;  // row of vp
    if (i < 0) return 0.f;
    return i < H8 ? __ldg(halo + i * kW + k)
                  : __ldg(vb + (long long)(i - H8) * kW + k);
  });
}

// K5: input rows generated in the block (and the batch's last H8 copied
// out as the next carry), the halo from carry0.
__global__ void __launch_bounds__(kThreads)
fm_chain_gen_kernel(philox::Stream s, const float* __restrict__ amp,
                    const float* __restrict__ carry0,
                    float* __restrict__ carry_out, Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int H8 = p.H8, n = p.n;
  const float a = amp[0];
  chain_tile(buf, p, [&](int sr, int k) {
    if (sr < 0) return sr >= -H8 ? carry0[(H8 + sr) * kW + k] : 0.f;
    const float v = __fmul_rn(philox::gauss(s, sr, k, kW), a);
    if (sr >= n - H8) carry_out[(sr - (n - H8)) * kW + k] = v;
    return v;
  });
}

Chain make_chain(const float* prev0, const float* tail0, const float* c2,
                 const float* w2, const float* ataps, float* aud,
                 float* prev_out, float* tail_out, int n, int L, int H8,
                 int A, int decim, int T, float gain,
                 const float* atan_coeffs) {
  return Chain{c2,       w2, ataps, prev0, tail0, aud,   prev_out,
               tail_out, n,  L,     H8,    A,     decim, T,
               gain,     mathfns::load_atan(atan_coeffs)};
}

}  // namespace

extern "C" int fm_chain_planes_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* w2, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, float gain, const float* atan_coeffs, void* stream) {
  if (2 * M != kW) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows(T, A, L) * kW * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fm_chain_kernel<<<n / T, kThreads, smem, (cudaStream_t)stream>>>(
      vb, halo,
      make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, gain, atan_coeffs));
  return (int)cudaGetLastError();
}

extern "C" int fm_chain_gen_launch(
    uint32_t g_lo, uint32_t g_hi, uint32_t k0, uint32_t k1, int draws,
    float mean, float inv_std, const float* amp, const float* carry0,
    const float* prev0, const float* tail0, const float* c2, const float* w2,
    const float* ataps, float* aud, float* prev_out, float* tail_out,
    float* carry_out, int n, int M, int L, int H8, int A, int decim, int T,
    float gain, const float* atan_coeffs, void* stream) {
  if (2 * M != kW || (draws != 2 && draws != 3))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows(T, A, L) * kW * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fm_chain_gen_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const philox::Stream s{((uint64_t)g_hi << 32) | g_lo, k0, k1, draws, mean,
                         inv_std};
  fm_chain_gen_kernel<<<n / T, kThreads, smem, (cudaStream_t)stream>>>(
      s, amp, carry0, carry_out,
      make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, gain, atan_coeffs));
  return (int)cudaGetLastError();
}

extern "C" int atan2_launch(const float* y, const float* x, float* out,
                            long long n, const float* atan_coeffs,
                            void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  atan2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      y, x, out, n, mathfns::load_atan(atan_coeffs));
  return (int)cudaGetLastError();
}
