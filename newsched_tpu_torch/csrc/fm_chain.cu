// The fused FM channelizer chain on planes rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel newsched_tpu/ops/pallas/fm_chain.py
// `fm_chain_step_planes` (`_kernel`, `_compute_tile`), and its device
// function newsched_tpu/ops/pallas/mathfns.py `atan2`. Per stream row t:
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
// per tile: +51% at T=128, +75% with the padding to 32-row passes). As on
// the TPU, Y and aud never leave the chip:
// the block keeps its (T+A, 2M) tile in shared memory (112 KB at T=128),
// turns Y into aud in place, and writes only the T/decim audio rows.
// The matmul is a plain register-tiled FP32 loop (4x4 outputs a thread);
// W2 is read through the read-only cache. Tensor cores (TF32/3xTF32) are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtanDeg = 9;
constexpr int kThreads = 256;
constexpr int kChunkRows = 32;  // matmul rows per pass: 8 row groups x 4
constexpr int kW = 128;         // planes lanes, 2M for M = 64 channels

struct AtanCoeffs {
  float c[kAtanDeg + 1];
};

// atan2 by argument reduction to [0, 1] and an odd polynomial of degree
// 2*kAtanDeg+1 (the reference's mathfns.atan2, deg=9). (+-0, +-0) -> 0:
// the zero-history demod emits exactly 0, whatever the signs of the zeros.
__device__ __forceinline__ float atan2_poly(float y, float x,
                                            const AtanCoeffs& co) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float z = lo / fmaxf(hi, 1e-37f);
  const float w = z * z;
  float acc = co.c[kAtanDeg];
#pragma unroll
  for (int k = kAtanDeg - 1; k >= 0; --k) acc = acc * w + co.c[k];
  float a = z * acc;
  const float pi = 3.14159265358979f;
  if (ay > ax) a = pi * 0.5f - a;
  if (x < 0.f) a = pi - a;
  if (y < 0.f) a = -a;
  if (x == 0.f && y == 0.f) a = 0.f;
  return a;
}

__global__ void atan2_kernel(const float* __restrict__ y,
                             const float* __restrict__ x,
                             float* __restrict__ out, long long n,
                             AtanCoeffs co) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = atan2_poly(y[i], x[i], co);
}

// One block per tile of T stream rows; kW = 2M lanes ([re | im] planes).
__global__ void __launch_bounds__(kThreads)
fm_chain_kernel(const float* __restrict__ vb, const float* __restrict__ halo,
                const float* __restrict__ prev0,
                const float* __restrict__ tail0, const float* __restrict__ c2,
                const float* __restrict__ w2, const float* __restrict__ ataps,
                float* __restrict__ aud, float* __restrict__ prev_out,
                float* __restrict__ tail_out, int L, int H8, int A, int decim,
                int T, float gain, AtanCoeffs co) {
  constexpr int W = kW, M = kW / 2;
  // (R_pad, W) tile: buffer row jj holds stream row t0 - A + jj
  extern __shared__ __align__(16) float buf[];
  const int t0 = blockIdx.x * T;
  const int R = T + A;
  const int R_pad = (R + kChunkRows - 1) / kChunkRows * kChunkRows;
  const int off = H8 - (L - 1);
  const int tid = threadIdx.x;
  const bool last = blockIdx.x == gridDim.x - 1;

  // 1. Arm fold into the tile buffer (rows before the stream start, and
  //    the padding rows, hold 0).
  for (int idx = tid; idx < R_pad * W; idx += kThreads) {
    const int jj = idx / W, k = idx % W;
    const int t = t0 - A + jj;
    float acc = 0.f;
    if (jj < R && t >= 0) {
      for (int q = 0; q < L; ++q) {
        const int i = t + off + q;  // row of vp = [halo; vb]
        const float v = i < H8 ? __ldg(halo + i * W + k)
                               : __ldg(vb + (long long)(i - H8) * W + k);
        acc = q ? acc + __ldg(c2 + q * W + k) * v : __ldg(c2 + k) * v;
      }
    }
    buf[idx] = acc;
  }
  __syncthreads();

  // 2. Y = acc @ W2 in place, kChunkRows rows a pass. Thread (ty, tx) owns
  //    rows 4*ty..4*ty+3 of the pass and columns 4*tx..4*tx+3.
  const int tx = tid & 31, ty = tid >> 5;
  for (int r0 = 0; r0 < R_pad; r0 += kChunkRows) {
    float o[4][4] = {};
    const float* arow = buf + (r0 + 4 * ty) * W;
    for (int k = 0; k < W; ++k) {
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(w2 + k * W + 4 * tx));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = arow[i * W + k];
        o[i][0] = fmaf(a, wv.x, o[i][0]);
        o[i][1] = fmaf(a, wv.y, o[i][1]);
        o[i][2] = fmaf(a, wv.z, o[i][2]);
        o[i][3] = fmaf(a, wv.w, o[i][3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(buf + (r0 + 4 * ty + i) * W + 4 * tx) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    __syncthreads();
  }
  if (t0 < A)  // the tile reaches back to Y[-1], the carried row
    for (int k = tid; k < W; k += kThreads)
      buf[(A - 1 - t0) * W + k] = prev0[k];
  if (last)  // Y[n-1], before the demod overwrites it
    for (int k = tid; k < W; k += kThreads) prev_out[k] = buf[(R - 1) * W + k];
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
          val[e] = tail0[(A - 1 + t) * W + m];
        } else {
          const float* pa = buf + (jj - 1) * W;
          const float* py = buf + jj * W;
          const float ar = pa[m], ai = pa[m + M], yr = py[m], yi = py[m + M];
          const float pr = ar * yr + ai * yi;
          const float pi = ar * yi - ai * yr;
          val[e] = atan2_poly(pi, pr, co) * gain;
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
      tail_out[i * W + m] = v;
      tail_out[i * W + M + m] = v;
    }

  // 4. Decimating audio FIR: out[o] = sum_k ataps[k] * aud[o*decim - k].
  const int n_o = T / decim;
  for (int idx = tid; idx < n_o * M; idx += kThreads) {
    const int o = idx / M, m = idx % M;
    const float* col = buf + (A + o * decim) * W + m;
    float acc = 0.f;
    for (int k = 0; k < A; ++k) acc = fmaf(__ldg(ataps + k), col[-k * W], acc);
    aud[((long long)t0 / decim + o) * M + m] = acc;
  }
}

AtanCoeffs load_coeffs(const float* host) {
  AtanCoeffs co;
  for (int i = 0; i <= kAtanDeg; ++i) co.c[i] = host[i];
  return co;
}

}  // namespace

extern "C" int fm_chain_planes_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* w2, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, float gain, const float* atan_coeffs, void* stream) {
  if (2 * M != kW) return (int)cudaErrorInvalidValue;
  const int r_pad = (T + A + kChunkRows - 1) / kChunkRows * kChunkRows;
  const size_t smem = (size_t)r_pad * kW * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fm_chain_kernel<<<n / T, kThreads, smem, (cudaStream_t)stream>>>(
      vb, halo, prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, L, H8,
      A, decim, T, gain, load_coeffs(atan_coeffs));
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
      y, x, out, n, load_coeffs(atan_coeffs));
  return (int)cudaGetLastError();
}
