// S3 viterbi_decode for Hopper (sm_90a): maximum-likelihood decoding of a
// rate-1/n convolutional code, one terminated (or unterminated) frame a
// warp (K <= 9) or a block (K = 10, 11).
//
// No TPU kernel: it replaces the reference's two `lax.scan`s in
// newsched_tpu/ops/fec.py `viterbi_decode` (:83): the add-compare-select
// over S = 2^(K-1) states (:131) and the traceback (:142). The branch
// symbols `psym` (each state's expected +-1 symbols on its two incoming
// branches) are the reference's, built by the same loop on the host
// (ops/fec.py), which also asserts the trellis's butterfly: state s' has
// the predecessors s'>>1 and (s'>>1) + S/2, both by the input bit s' & 1
// (nxt[s, b] = ((s << 1) | b) & (S-1) for every code).
//
// What bounds it: each of the T steps of a frame depends on the one
// before, and each step needs every state's new metric (the
// normalisation subtracts their max). At the FEC link's shape (1024
// frames of 512 bits, K = 7, rate 1/2: T = 518, S = 64) the work is ~12
// FP32 operations a state a step, ~400 MFLOP, 6 us at 67 TFLOP/s, and the
// bytes 6.3 MB, 1.9 us at 3.35 TB/s; what the kernel pays instead is a
// step's latency, T of them in a row. So the design keeps a step inside
// one warp, with no barrier and no shared-memory round trip:
//   - a frame a warp, up to 4 frames a block; lane l holds states
//     l E .. l E + E - 1 (E = S/32 at S >= 32; one state a lane, lanes
//     past S idle, below), their metrics and branch symbols in registers;
//   - the states 2p and 2p + 1 share the predecessors p and p + S/2, so a
//     lane's E/2 pairs read E old metrics, from lanes l>>1 and
//     16 + (l>>1): 2E __shfl_sync a step (E/2 of each source's E metrics
//     are the lane's, by the parity of l);
//   - the max: each lane's over its states, then one __reduce_max_sync on
//     the floats' order-preserving int keys, in every lane at once;
//   - the metrics stay unnormalised: a step forms (m - g) + bm with g the
//     previous step's max, the reference's rounding order exactly;
//   - each step's decisions are E __ballot_sync words (bit l of word e:
//     state l E + e), written to the warp's slice of shared memory, T E
//     words a frame (4.1 KB at K = 7 and 512-bit frames), beside its LLRs,
//     staged there once;
//   - the traceback runs on one lane over the words: the state's word is
//     picked from the step's E words, loaded ahead of it, so the chain is
//     a select, a shift and an add a step; the bits leave in coalesced
//     stores.
// At K = 10 and 11 (16 and 32 states a lane) a warp's registers would not
// hold them: the block instance takes those codes, one block a frame, one
// thread a state, its metrics double-buffered in shared memory, one
// barrier a step, the max by warp shuffles and one word a warp.
// Ties: predecessor 1 only if its metric is strictly greater, as
// jnp.argmax picks the first maximum (hard +-1 LLRs tie often). Every
// multiply and add is separately rounded (__fmul_rn/__fadd_rn); each
// branch metric at rate 1/2 is a sum of two exact +-r products, so the
// decoded bits equal the reference's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

// ---- the warp instance: a frame a warp, S <= 256 ----------------------------

constexpr int kWarpMaxS = 256;   // 8 states a lane
constexpr int kWarpFrames = 4;   // frames (warps) a block, at most
constexpr unsigned kAll = 0xffffffffu;

// The max of x over the warp, in every lane: one redux on int keys that
// order as the floats do (negative floats' magnitude bits flipped).
__device__ __forceinline__ float warp_max(float x) {
  const int i = __float_as_int(x);
  const int m = __reduce_max_sync(kAll, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// E states a lane (1: one state, lanes past S idle), N coded bits a step.
// The warp's slice of shared memory: T N LLRs (then the T decoded bits),
// then T E decision words.
template <int E, int N>
__global__ void __launch_bounds__(32 * kWarpFrames)
viterbi_warp_kernel(const float* __restrict__ llr, int* __restrict__ bits,
                    const float* __restrict__ psym, int F, int T, int S,
                    int terminated, int nbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = E > 1 ? E / 2 : 1;  // predecessor pairs a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= F) return;  // a whole warp; no block barrier follows
  float* r = reinterpret_cast<float*>(smem) + (long long)warp * T * (N + E);
  unsigned* dec = reinterpret_cast<unsigned*>(r + (long long)T * N);
  const float* lf = llr + (long long)f * T * N;
  for (int i = lane; i < T * N; i += 32) r[i] = lf[i];
  const bool live = lane * E < S;
  float sym[E][2][N], v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int st = lane * E + e;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < N; ++j)
        sym[e][b][j] = live ? psym[(st * 2 + b) * N + j] : 0.f;
    v[e] = st == 0 ? 0.f : -1e9f;  // the encoder starts in state 0
  }
  // the lanes holding this lane's predecessors p and p + S/2
  const int src0 = lane >> 1, src1 = (lane >> 1) + (E > 1 ? 16 : S / 2);
  const bool odd = lane & 1;
  float g = 0.f;  // the previous step's max (0 before the first step)
  __syncwarp();
  for (int t = 0; t < T; ++t) {
    float rr[N];
#pragma unroll
    for (int j = 0; j < N; ++j) rr[j] = r[t * N + j];
    float m0[H], m1[H];  // the pairs' predecessor metrics, less g
    if constexpr (E == 1) {
      m0[0] = __fsub_rn(__shfl_sync(kAll, v[0], src0), g);
      m1[0] = __fsub_rn(__shfl_sync(kAll, v[0], src1), g);
    } else {
      float a[E], b[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        a[e] = __shfl_sync(kAll, v[e], src0);
        b[e] = __shfl_sync(kAll, v[e], src1);
      }
#pragma unroll
      for (int i = 0; i < H; ++i) {
        m0[i] = __fsub_rn(odd ? a[H + i] : a[i], g);
        m1[i] = __fsub_rn(odd ? b[H + i] : b[i], g);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float bm0 = __fmul_rn(sym[e][0][0], rr[0]);
      float bm1 = __fmul_rn(sym[e][1][0], rr[0]);
#pragma unroll
      for (int j = 1; j < N; ++j) {
        bm0 = __fadd_rn(bm0, __fmul_rn(sym[e][0][j], rr[j]));
        bm1 = __fadd_rn(bm1, __fmul_rn(sym[e][1][j], rr[j]));
      }
      const float c0 = __fadd_rn(m0[e / 2], bm0), c1 = __fadd_rn(m1[e / 2], bm1);
      const bool ch = c1 > c0;
      v[e] = ch ? c1 : c0;
      mx = fmaxf(mx, v[e]);
      const unsigned word = __ballot_sync(kAll, live && ch);
      if (lane == 0) dec[t * E + e] = word;
    }
    g = warp_max(live ? mx : -INFINITY);
  }
  int state = 0;
  if (!terminated && T > 0) {  // argmax of v - g, the first of equal maxima
    int best = 0;
    float bv = live ? __fsub_rn(v[0], g) : -INFINITY;
#pragma unroll
    for (int e = 1; e < E; ++e) {
      const float fe = __fsub_rn(v[e], g);
      if (fe > bv) bv = fe, best = e;
    }
    const float top = warp_max(bv);
    const unsigned at = __ballot_sync(kAll, live && bv == top);
    const int win = __ffs(at) - 1;
    state = win * E + __shfl_sync(kAll, best, win);
  }
  int* out = reinterpret_cast<int*>(r);  // the LLRs are read
  __syncwarp();
  if (lane == 0) {
    const int hi = S >> 1;
#pragma unroll 4
    for (int t = T - 1; t >= 0; --t) {
      unsigned w[E];
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = dec[t * E + e];
      unsigned word = w[0];
#pragma unroll
      for (int e = 1; e < E; ++e) word = (state & (E - 1)) == e ? w[e] : word;
      const int which = (word >> (state / E)) & 1;
      out[t] = state & 1;  // the input bit into state: pbit
      state = (state >> 1) + (which ? hi : 0);  // pred[state][which]
    }
  }
  __syncwarp();
  int* bf = bits + (long long)f * nbits;
  for (int i = lane; i < nbits; i += 32) bf[i] = out[i];
}

using WarpKernel = void (*)(const float*, int*, const float*, int, int, int,
                            int, int);

template <int E>
WarpKernel warp_instance(int n) {
  switch (n) {
    case 1: return viterbi_warp_kernel<E, 1>;
    case 2: return viterbi_warp_kernel<E, 2>;
    case 3: return viterbi_warp_kernel<E, 3>;
    default: return viterbi_warp_kernel<E, 4>;
  }
}

}  // namespace

// Shared memory of a block of the block instance, and of a warp's frame in
// the warp instance (ops/cuda/fec.py `viterbi_smem` mirrors both, to
// refuse a frame that does not fit and name the limit).
static long long viterbi_smem(int T, int n, int S) {
  const long long NW = (S + 31) / 32;
  return 4LL * ((long long)T * n + 2 * S + 2 * NW + S + 4 * S + T * NW + T);
}

static long long viterbi_warp_smem(int T, int n, int S) {
  return 4LL * T * (n + (S < 32 ? 1 : S / 32));
}

static constexpr long long kSmemMax = 232448;  // a block on the H100

// The warp instance up to S = 256 (K = 9), the block instance above.
extern "C" int viterbi_launch(const float* llr, int* bits, const float* psym,
                              const int* pred, const int* pbit, int F, int T,
                              int n, int S, int terminated, int nbits,
                              void* stream) {
  if (F < 0 || T < 0 || n < 1 || n > kMaxN || S < 2 || S > 1024 ||
      (S & (S - 1)) || nbits < 0 || nbits > T)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S <= kWarpMaxS) {
    const long long per = viterbi_warp_smem(T, n, S);
    if (per > kSmemMax) return (int)cudaErrorInvalidValue;
    const int wpb = (int)std::min<long long>(kWarpFrames, kSmemMax / std::max(per, 1LL));
    WarpKernel fn;
    switch (S < 32 ? 1 : S / 32) {
      case 1: fn = warp_instance<1>(n); break;
      case 2: fn = warp_instance<2>(n); break;
      case 4: fn = warp_instance<4>(n); break;
      default: fn = warp_instance<8>(n);
    }
    const long long smem = per * wpb;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    fn<<<(F + wpb - 1) / wpb, 32 * wpb, (size_t)smem, st>>>(
        llr, bits, psym, F, T, S, terminated, nbits);
    return (int)cudaGetLastError();
  }
  const long long smem = viterbi_smem(T, n, S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = S < 32 ? 32 : S;
  viterbi_kernel<<<F, threads, (size_t)smem, st>>>(
      llr, bits, psym, pred, pbit, T, n, S, terminated, nbits);
  return (int)cudaGetLastError();
}
