// S3 viterbi_decode for Hopper (sm_90a): maximum-likelihood decoding of a
// rate-1/n convolutional code, one terminated (or unterminated) frame a
// block.
//
// No TPU kernel: it replaces the reference's two `lax.scan`s in
// newsched_tpu/ops/fec.py `viterbi_decode` (:83): the add-compare-select
// over S = 2^(K-1) states (:131) and the traceback (:142). The trellis
// tables (each state's two predecessors `pred`, their input bits `pbit`
// and the expected +-1 symbols `psym` on the two branches) are the
// reference's, built by the same loop on the host (ops/fec.py).
//
// What bounds it: each of the T steps of a frame depends on the one
// before, and each step needs every state's new metric (the
// normalisation subtracts their max). At the FEC link's shape (1024
// frames of 512 bits, K = 7, rate 1/2: T = 518, S = 64) the work is ~10
// FP32 operations a state a step, ~340 MFLOP, 5 us at 67 TFLOP/s, and the
// bytes 6.3 MB, 1.9 us at 3.35 TB/s; the kernel is bound instead by the
// step's synchronisation. The design keeps that to one barrier a step:
//   - one block a frame, one thread a state (at least a warp);
//   - the frame's LLRs and the tables are staged in shared memory once;
//   - the metrics are double-buffered in shared memory and kept
//     unnormalised: a step reads its predecessors' metric m and the
//     previous step's max g and forms (m - g) + bm, the reference's
//     rounding order exactly, so the max (warp shuffles, then one word a
//     warp in shared memory, also double-buffered) needs no second
//     barrier;
//   - each step's decisions are one __ballot_sync word a warp, T * S / 8
//     bytes a frame (4.1 KB at K = 7 and 512-bit frames);
//   - the traceback runs on one thread over the shared-memory words, the
//     bits leave through shared memory in coalesced stores.
// Ties: predecessor 1 only if its metric is strictly greater, as
// jnp.argmax picks the first maximum (hard +-1 LLRs tie often). Every
// multiply and add is separately rounded (__fmul_rn/__fadd_rn); each
// branch metric at rate 1/2 is a sum of two exact +-r products, so the
// decoded bits equal the reference's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 4;  // outputs a step (rate 1/n)

__global__ void viterbi_kernel(const float* __restrict__ llr,
                               int* __restrict__ bits,
                               const float* __restrict__ psym,
                               const int* __restrict__ pred,
                               const int* __restrict__ pbit, int T, int n,
                               int S, int terminated, int nbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = (S + 31) / 32;  // decision words a step
  float* r = reinterpret_cast<float*>(smem);  // T * n LLRs
  float* nm = r + T * n;                      // 2 x S metrics
  float* wmax = nm + 2 * S;                   // 2 x NW warp maxima
  float* fin = wmax + 2 * NW;                 // S final metrics
  int* pred_s = reinterpret_cast<int*>(fin + S);  // 2 S
  int* pbit_s = pred_s + 2 * S;                   // 2 S
  unsigned* dec = reinterpret_cast<unsigned*>(pbit_s + 2 * S);  // T x NW
  int* out = reinterpret_cast<int*>(dec + (long long)T * NW);   // T bits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* lf = llr + (long long)blockIdx.x * T * n;
  for (int i = tid; i < T * n; i += blockDim.x) r[i] = lf[i];
  for (int i = tid; i < 2 * S; i += blockDim.x) {
    pred_s[i] = pred[i];
    pbit_s[i] = pbit[i];
  }
  const bool live = tid < S;
  float sym0[kMaxN] = {}, sym1[kMaxN] = {};
  int q0 = 0, q1 = 0;
  if (live) {
    q0 = pred[2 * tid];
    q1 = pred[2 * tid + 1];
    for (int j = 0; j < n; ++j) {
      sym0[j] = psym[(2 * tid) * n + j];
      sym1[j] = psym[(2 * tid + 1) * n + j];
    }
  }
  __syncthreads();
  const float kNeg = -1e9f;  // the encoder starts in state 0
  for (int t = 0; t < T; ++t) {
    float m0, m1;
    if (t == 0) {
      m0 = q0 == 0 ? 0.f : kNeg;
      m1 = q1 == 0 ? 0.f : kNeg;
    } else {
      const float* prev = nm + ((t - 1) & 1) * S;
      const float* wm = wmax + ((t - 1) & 1) * NW;
      float g = wm[0];
      for (int w = 1; w < NW; ++w) g = fmaxf(g, wm[w]);
      m0 = __fsub_rn(prev[q0], g);
      m1 = __fsub_rn(prev[q1], g);
    }
    const float* rt = r + t * n;
    float bm0 = __fmul_rn(sym0[0], rt[0]);
    float bm1 = __fmul_rn(sym1[0], rt[0]);
    for (int j = 1; j < n; ++j) {
      bm0 = __fadd_rn(bm0, __fmul_rn(sym0[j], rt[j]));
      bm1 = __fadd_rn(bm1, __fmul_rn(sym1[j], rt[j]));
    }
    const float c0 = __fadd_rn(m0, bm0), c1 = __fadd_rn(m1, bm1);
    const bool ch = live && c1 > c0;
    const float v = ch ? c1 : c0;
    const unsigned word = __ballot_sync(0xffffffffu, ch);
    float mx = live ? v : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (live) nm[(t & 1) * S + tid] = v;
    if (lane == 0) {
      wmax[(t & 1) * NW + warp] = mx;
      dec[(long long)t * NW + warp] = word;
    }
    __syncthreads();
  }
  if (T > 0) {
    const float* wm = wmax + ((T - 1) & 1) * NW;
    float g = wm[0];
    for (int w = 1; w < NW; ++w) g = fmaxf(g, wm[w]);
    if (live) fin[tid] = __fsub_rn(nm[((T - 1) & 1) * S + tid], g);
  }
  __syncthreads();
  if (tid == 0 && T > 0) {
    int state = 0;
    if (!terminated) {  // argmax, the first of equal maxima
      float best = fin[0];
      for (int s = 1; s < S; ++s)
        if (fin[s] > best) {
          best = fin[s];
          state = s;
        }
    }
    for (int t = T - 1; t >= 0; --t) {
      const int which =
          (dec[(long long)t * NW + (state >> 5)] >> (state & 31)) & 1;
      out[t] = pbit_s[2 * state + which];
      state = pred_s[2 * state + which];
    }
  }
  __syncthreads();
  int* bf = bits + (long long)blockIdx.x * nbits;
  for (int i = tid; i < nbits; i += blockDim.x) bf[i] = out[i];
}

}  // namespace

// Shared memory of a block (ops/cuda/fec.py `viterbi_smem` mirrors it, to
// refuse a frame that does not fit and name the limit).
static long long viterbi_smem(int T, int n, int S) {
  const long long NW = (S + 31) / 32;
  return 4LL * ((long long)T * n + 2 * S + 2 * NW + S + 4 * S + T * NW + T);
}

extern "C" int viterbi_launch(const float* llr, int* bits, const float* psym,
                              const int* pred, const int* pbit, int F, int T,
                              int n, int S, int terminated, int nbits,
                              void* stream) {
  if (F < 0 || T < 0 || n < 1 || n > kMaxN || S < 2 || S > 1024 ||
      (S & (S - 1)) || nbits < 0 || nbits > T)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const long long smem = viterbi_smem(T, n, S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = S < 32 ? 32 : S;
  viterbi_kernel<<<F, threads, (size_t)smem, (cudaStream_t)stream>>>(
      llr, bits, psym, pred, pbit, T, n, S, terminated, nbits);
  return (int)cudaGetLastError();
}
