// The overlap-save FFT of the live FIR kernel K9, shared by its two
// instances: fir_source.cu (up to 513 taps, one spectrum) and fir_part.cu
// (past 513 taps, a spectrum a partition of the taps). An N = Q*Q-point
// transform runs on Q threads (a half-warp, or a warp at Q = 32), thread t
// holding x[t + Q*n]: a radix-Q DFT over n, times W_N^(t*k1), an exchange
// through the transform's padded shared buffer, a radix-Q DFT over the
// threads. Every add and multiply is rounded on its own (__fadd_rn,
// __fmul_rn, never contracted), so a transform's arithmetic is the same
// wherever it runs; tests/test_torch_fir_fft.py repeats it in torch float32.
// Also the instances' writes of whole rows of output by the tensor-memory
// accelerator.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace firfft {

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// Single operations, each rounded to nearest on its own (never contracted).
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }

// (re, im) *= (cr, ci), each product and sum rounded on its own.
__device__ __forceinline__ void cmul(float& re, float& im, float cr, float ci) {
  const float r = rsub(rmul(re, cr), rmul(im, ci));
  im = radd(rmul(re, ci), rmul(im, cr));
  re = r;
}

// x[k] = sum_n x[n] W_S^(nk) in place, n, k < S, by decimation in
// frequency: a = x[n] + x[n+S/2] gives the even k, b = (x[n] - x[n+S/2])
// W_S^n the odd ones. W_S^n = W_Q^(n Q/S) from (wr, wi), W_Q^m for m <
// Q/2; W_S^(S/4) = -i, W_S^(S/8) = c (1 - i) and W_S^(3S/8) = -c (1 + i)
// with c = cos(pi/4) = wr[Q/8] take two multiplies.
template <int S, int Q>
__device__ __forceinline__ void dft(float* xr, float* xi, const float* wr,
                                    const float* wi) {
  if constexpr (S == 2) {
    const float r = rsub(xr[0], xr[1]), i = rsub(xi[0], xi[1]);
    xr[0] = radd(xr[0], xr[1]);
    xi[0] = radd(xi[0], xi[1]);
    xr[1] = r;
    xi[1] = i;
  } else {
    constexpr int H = S / 2;
    float ar[H], ai[H], br[H], bi[H];
#pragma unroll
    for (int n = 0; n < H; ++n) {
      ar[n] = radd(xr[n], xr[n + H]); ai[n] = radd(xi[n], xi[n + H]);
      br[n] = rsub(xr[n], xr[n + H]); bi[n] = rsub(xi[n], xi[n + H]);
    }
#pragma unroll
    for (int n = 1; n < H; ++n) {
      if (4 * n == S) {  // -i
        const float r = bi[n];
        bi[n] = -br[n];
        br[n] = r;
      } else if (8 * n == S) {  // c (1 - i)
        const float c = wr[Q / 8];
        const float r = rmul(radd(br[n], bi[n]), c);
        bi[n] = rmul(rsub(bi[n], br[n]), c);
        br[n] = r;
      } else if (8 * n == 3 * S) {  // -c (1 + i)
        const float c = wr[Q / 8];
        const float r = rmul(rsub(bi[n], br[n]), c);
        bi[n] = -rmul(radd(br[n], bi[n]), c);
        br[n] = r;
      } else {
        cmul(br[n], bi[n], wr[n * (Q / S)], wi[n * (Q / S)]);
      }
    }
    dft<H, Q>(ar, ai, wr, wi);
    dft<H, Q>(br, bi, wr, wi);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      xr[2 * k] = ar[k]; xi[2 * k] = ai[k];
      xr[2 * k + 1] = br[k]; xi[2 * k + 1] = bi[k];
    }
  }
}

// The N-point DFT of the values thread t of a transform holds, x[t + Q*n]
// in (xr, xi)[n], in place: X[t + Q*k] in (xr, xi)[k]. xb: the transform's
// exchange buffer; tw: W_N^(t*k) at [k*Q + t]. The transform's Q threads
// call it together (a half-warp, or a warp at Q = 32).
template <int Q>
__device__ __forceinline__ void fft(float* xr, float* xi, float2* xb,
                                    const float2* tw, int t, const float* wr,
                                    const float* wi) {
  dft<Q, Q>(xr, xi, wr, wi);  // A[t][k1]
#pragma unroll
  for (int k = 1; k < Q; ++k) {
    const float2 w = tw[k * Q + t];
    cmul(xr[k], xi[k], w.x, w.y);
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) xb[t * (Q + 1) + k] = make_float2(xr[k], xi[k]);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < Q; ++n) {
    const float2 v = xb[n * (Q + 1) + t];
    xr[n] = v.x;
    xi[n] = v.y;
  }
  __syncwarp();
  dft<Q, Q>(xr, xi, wr, wi);  // X[t + Q k2]
}

// The output tile's rows to the output by the tensor-memory accelerator:
// generic-proxy writes to shared memory are fenced for the async proxy
// before the block's barrier; one thread then issues the copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"((unsigned)__cvta_generic_to_shared(src)), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the tile may be written again once the copies have read it
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found once through the runtime's
// entry-point query, so the library links against the runtime alone.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

}  // namespace firfft
