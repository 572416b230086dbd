// S3 viterbi_decode for Hopper (sm_90a): maximum-likelihood decoding of a
// rate-1/n convolutional code, one terminated (or unterminated) frame a
// warp (K <= 9, n <= 4), a block or a thread-block cluster (K <= 18, n <=
// 8: viterbi_acs_kernel below), or, for the rest, a block of up to 1024
// threads (the serial instance, viterbi_kernel).
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
// At K = 10 and past (16 and more states a lane) a warp's registers would
// not hold them, nor its 4 E branch symbols past n = 4: the block and
// cluster instance takes those codes up to K = 18 and n = 8 (its header
// below). The serial instance takes what neither takes (K <= 6 past n = 4,
// n > 8, K > 18), one block a frame, S/1024 states a thread past 1024
// states (state s on thread s mod 1024, so a ballot of warp w at state
// group e is word s >> 5), the branch symbols from the read-only cache past
// rate 1/4 or two states a thread, its metrics double-buffered in shared
// memory (2 S floats: 128 KB at K = 15, the last code whose two rows fit a
// block), one barrier a step, the max by warp shuffles and one word a warp.
// Past K = 15 (S/1024 >= 32 states a thread, a run-time count) the two rows
// live in device memory, 2 S floats a frame of the caller's scratch
// (`metrics`), written and read by the frame's block alone, whose barrier
// a step also orders those accesses (256 KB a frame at K = 16, from L2);
// such a frame takes the `global` route below too. Its branch symbols
// (512 KB at K = 16, rate 1/2) would come from L2 at every step as well,
// so up to rate 1/4 they are computed instead: the code is linear, psym
// of state s' on branch b is 2 parity(g_j & (s' + b S)) - 1 for the
// register s' + b S of its K bits, and the generators g_j are read back
// once from psym (bit k of g_j from state 2^k, branch 0; bit K-1 from
// state 0, branch 1), so the symbols are psym's, exactly +-1. What bounds
// the code is then the card's memory for the metrics and decision words
// (ops/cuda/fec.py viterbi_plan).
//
// Memory of a frame: where its LLRs and decision words fit a block's
// shared memory (the warp instance: 4 T (n + S/32) bytes, 14,528 steps at
// K = 7, rate 1/2) they are staged there, as above. Past it (`global`) the
// LLRs are read from device memory step by step (the next step's loaded
// ahead of the step), the decision words go to a scratch buffer in device
// memory (T S/32 words a frame, the caller's), the traceback reads them
// back from there, and the bits leave as they are traced. The arithmetic
// and its order are the same either way.
// Ties: predecessor 1 only if its metric is strictly greater, as
// jnp.argmax picks the first maximum (hard +-1 LLRs tie often). Every
// multiply and add is separately rounded (__fmul_rn/__fadd_rn); each
// branch metric at rate 1/2 is a sum of two exact +-r products, so the
// decoded bits equal the reference's bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 4;         // coded bits a step the warp instance holds
constexpr int kBlockThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e9f;    // the encoder starts in state 0

// One step's branch metric of state st on branch b: sum_j psym * r, the
// first product alone, then each add rounded on its own.
// kRegSym<E>: the block instance keeps the branch symbols in registers
// (E = 1, 2 states a thread); E = 0 is the run-time count past K = 15.
template <int E>
constexpr bool kRegSym = E >= 1 && E <= 2;

template <int E>
__device__ __forceinline__ float branch(const float (&sym)[kRegSym<E> ? E : 1][2][kMaxN],
                                        int e, int b, const float* __restrict__ psym,
                                        int st, const float* rt, int n) {
  if (kRegSym<E> && n <= kMaxN) {
    float bm = __fmul_rn(sym[kRegSym<E> ? e : 0][b][0], rt[0]);
#pragma unroll
    for (int j = 1; j < kMaxN; ++j)
      if (j < n) bm = __fadd_rn(bm, __fmul_rn(sym[kRegSym<E> ? e : 0][b][j], rt[j]));
    return bm;
  }
  const float* ps = psym + ((long long)st * 2 + b) * n;
  float bm = __fmul_rn(__ldg(ps), rt[0]);
  for (int j = 1; j < n; ++j) bm = __fadd_rn(bm, __fmul_rn(__ldg(ps + j), rt[j]));
  return bm;
}

// The block instance: a frame a block of min(S, 1024) threads (32 below 32
// states, lanes past S idle), E = S / threads states a thread (E = 0: that
// count at run time). metrics_g: the frames' metrics in device memory (2 S
// floats a frame), else in shared memory.
template <int E>
__global__ void __launch_bounds__(kBlockThreads)
viterbi_kernel(const float* __restrict__ llr, int* __restrict__ bits,
               const float* __restrict__ psym, unsigned* __restrict__ dec_g,
               float* metrics_g, int T, int n, int S, int terminated,
               int nbits, int global) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, NWt = threads >> 5;
  const int NE = E ? E : S / threads;       // states a thread
  const int NW = S < 32 ? 1 : S >> 5;       // decision words a step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long f = blockIdx.x;
  float* nm = metrics_g ? metrics_g + f * 2 * S        // 2 x S metrics
                        : reinterpret_cast<float*>(smem);
  float* wmax = metrics_g ? reinterpret_cast<float*>(smem)
                          : nm + 2 * S;                // 2 x 32 warp maxima
  const float* r;                               // T x n LLRs
  unsigned* dec;                                // T x NW decision words
  int* out = nullptr;                           // T bits (shared frames)
  // E = 0 up to rate 1/4: the generators, read back from psym (the header)
  unsigned gen[kMaxN] = {};
  if constexpr (E == 0) {
    if (n <= kMaxN) {
      const int lg = 31 - __clz(S);  // K - 1
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < n) {
          unsigned g = __ldg(psym + n + j) > 0.f ? 1u << lg : 0u;
          for (int k = 0; k < lg; ++k)
            if (__ldg(psym + (2LL << k) * n + j) > 0.f) g |= 1u << k;
          gen[j] = g;
        }
    }
  }
  if (global) {
    r = llr + f * T * n;
    dec = dec_g + f * T * NW;
  } else {
    float* rs = wmax + 64;
    for (int i = tid; i < T * n; i += threads) rs[i] = llr[f * T * n + i];
    r = rs;
    dec = reinterpret_cast<unsigned*>(rs + T * n);
    out = reinterpret_cast<int*>(dec + (long long)T * NW);
  }
  float sym[kRegSym<E> ? E : 1][2][kMaxN] = {};
  if (kRegSym<E> && n <= kMaxN)
#pragma unroll
    for (int e = 0; e < (kRegSym<E> ? E : 1); ++e) {
      const int st = tid + e * threads;
      if (st < S)
        for (int b = 0; b < 2; ++b)
          for (int j = 0; j < n; ++j) sym[e][b][j] = psym[(st * 2 + b) * n + j];
    }
  const int half = S >> 1;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* prev = nm + ((t - 1) & 1) * S;
    float* cur = nm + (t & 1) * S;
    float g = 0.f;
    if (t > 0) {
      const float* wm = wmax + ((t - 1) & 1) * 32;
      g = wm[0];
      for (int w = 1; w < NWt; ++w) g = fmaxf(g, wm[w]);
    }
    const float* rt = r + (long long)t * n;
    float rr[kMaxN] = {};  // E = 0: the step's LLRs, loaded once
    if constexpr (E == 0) {
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < n) rr[j] = rt[j];
    }
    float mx = -INFINITY;
    // the metric of state st's predecessor `which` (st>>1, or that + S/2),
    // less the previous step's max
    const auto pred_metric = [&](int st, int which) {
      const int q = (st >> 1) + (which ? half : 0);
      if (t == 0) return q == 0 ? 0.f : kNeg;  // the encoder starts in 0
      return __fsub_rn(prev[q], g);
    };
    // state st's branch metric on branch b: E = 0 up to rate 1/4 from the
    // generators, in branch()'s order of operations
    const auto bmetric = [&](int e, int b, int st) {
      if constexpr (E == 0) {
        if (n <= kMaxN) {
          const unsigned reg = (unsigned)st + (b ? (unsigned)S : 0u);
          float bm = __fmul_rn(__popc(gen[0] & reg) & 1 ? 1.f : -1.f, rr[0]);
#pragma unroll
          for (int j = 1; j < kMaxN; ++j)
            if (j < n)
              bm = __fadd_rn(bm, __fmul_rn(__popc(gen[j] & reg) & 1 ? 1.f : -1.f,
                                           rr[j]));
          return bm;
        }
      }
      return branch<E>(sym, e, b, psym, st, rt, n);
    };
    // state group e's ACS from its predecessors' metrics, its decisions
    const auto acs = [&](int e, float m0, float m1) {
      const int st = tid + e * threads;
      bool ch = false;
      if (st < S) {
        const float c0 = __fadd_rn(m0, bmetric(e, 0, st));
        const float c1 = __fadd_rn(m1, bmetric(e, 1, st));
        ch = c1 > c0;
        const float v = ch ? c1 : c0;
        cur[st] = v;
        mx = fmaxf(mx, v);
      }
      const unsigned word = __ballot_sync(kAll, ch);  // states st - lane ..
      if (lane == 0) dec[(long long)t * NW + e * NWt + warp] = word;
    };
    if constexpr (E > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int st = tid + e * threads;
        const bool live = st < S;
        acs(e, live ? pred_metric(st, 0) : 0.f, live ? pred_metric(st, 1) : 0.f);
      }
    } else {  // NE = S/1024 >= 32 groups, every state live: the metrics of
              // 8 groups loaded before their ACS stores
      for (int e0 = 0; e0 < NE; e0 += 8) {
        float m[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int st = tid + (e0 + i) * threads;
          m[i][0] = pred_metric(st, 0);
          m[i][1] = pred_metric(st, 1);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acs(e0 + i, m[i][0], m[i][1]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, o));
    if (lane == 0) wmax[(t & 1) * 32 + warp] = mx;
    __syncthreads();
  }
  if (T == 0) return;
  int state = 0;
  if (!terminated) {  // argmax of the last metrics less their max: the first
    const float* last = nm + ((T - 1) & 1) * S;
    const float* wm = wmax + ((T - 1) & 1) * 32;
    float g = wm[0];
    for (int w = 1; w < NWt; ++w) g = fmaxf(g, wm[w]);
    float bv = -INFINITY;
    int bs = S;
    for (int e = 0; e < NE; ++e) {
      const int st = tid + e * threads;
      if (st < S) {
        const float fe = __fsub_rn(last[st], g);
        if (fe > bv) bv = fe, bs = st;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kAll, bv, o);
      const int os = __shfl_xor_sync(kAll, bs, o);
      if (ov > bv || (ov == bv && os < bs)) bv = ov, bs = os;
    }
    float* cv = nm + (T & 1) * S;                       // free: NWt <= S
    int* cs = reinterpret_cast<int*>(wmax + (T & 1) * 32);
    if (lane == 0) cv[warp] = bv, cs[warp] = bs;
    __syncthreads();
    if (tid == 0) {
      bv = cv[0], bs = cs[0];
      for (int w = 1; w < NWt; ++w)
        if (cv[w] > bv || (cv[w] == bv && cs[w] < bs)) bv = cv[w], bs = cs[w];
      state = bs;
    }
  }
  int* bf = bits + f * nbits;
  if (tid == 0)
    for (int t = T - 1; t >= 0; --t) {
      const int which = (dec[(long long)t * NW + (state >> 5)] >> (state & 31)) & 1;
      if (out)
        out[t] = state & 1;  // the input bit into state: pbit
      else if (t < nbits)
        bf[t] = state & 1;
      state = (state >> 1) + (which ? half : 0);  // pred[state][which]
    }
  if (out) {
    __syncthreads();
    for (int i = tid; i < nbits; i += threads) bf[i] = out[i];
  }
}

// ---- the warp instance: a frame a warp, S <= 256, n <= 4 -------------------

constexpr int kWarpMaxS = 256;   // 8 states a lane
constexpr int kWarpFrames = 4;   // frames (warps) a block, at most

// The max of x over the warp, in every lane: one redux on int keys that
// order as the floats do (negative floats' magnitude bits flipped).
__device__ __forceinline__ float warp_max(float x) {
  const int i = __float_as_int(x);
  const int m = __reduce_max_sync(kAll, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// E states a lane (1: one state, lanes past S idle), N coded bits a step.
// A staged frame's slice of shared memory: T N LLRs (then the T decoded
// bits), then T E decision words; a kGlobal frame's LLRs are llr's (the
// next step's loaded ahead of the step) and its words dec_g's.
template <int E, int N, bool kGlobal>
__global__ void __launch_bounds__(32 * kWarpFrames)
viterbi_warp_kernel(const float* __restrict__ llr, int* __restrict__ bits,
                    const float* __restrict__ psym,
                    unsigned* __restrict__ dec_g, int F, int T, int S,
                    int terminated, int nbits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = E > 1 ? E / 2 : 1;  // predecessor pairs a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.x * (blockDim.x >> 5) + warp;
  if (f >= F) return;  // a whole warp; no block barrier follows
  const float* lf = llr + (long long)f * T * N;
  float* rs = reinterpret_cast<float*>(smem) + (long long)warp * T * (N + E);
  const float* r;
  unsigned* dec;
  if constexpr (kGlobal) {
    r = lf;
    dec = dec_g + (long long)f * T * E;
  } else {
    for (int i = lane; i < T * N; i += 32) rs[i] = lf[i];
    r = rs;
    dec = reinterpret_cast<unsigned*>(rs + (long long)T * N);
  }
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
  float rn[N];  // kGlobal: the next step's LLRs, loaded a step ahead
#pragma unroll
  for (int j = 0; j < N; ++j) rn[j] = kGlobal && T > 0 ? r[j] : 0.f;
  for (int t = 0; t < T; ++t) {
    float rr[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (kGlobal) {
        rr[j] = rn[j];
        rn[j] = t + 1 < T ? r[(t + 1) * N + j] : 0.f;
      } else {
        rr[j] = r[t * N + j];
      }
    }
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
      if (lane == 0) dec[(long long)t * E + e] = word;
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
  int* bf = bits + (long long)f * nbits;
  // a staged frame's bits go where its LLRs were (read by now)
  int* out = kGlobal ? bf : reinterpret_cast<int*>(rs);
  const int lim = kGlobal ? nbits : T;
  __syncwarp();
  if (lane == 0) {
    const int hi = S >> 1;
#pragma unroll 4
    for (int t = T - 1; t >= 0; --t) {
      unsigned w[E];
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = dec[(long long)t * E + e];
      unsigned word = w[0];
#pragma unroll
      for (int e = 1; e < E; ++e) word = (state & (E - 1)) == e ? w[e] : word;
      const int which = (word >> (state / E)) & 1;
      if (t < lim) out[t] = state & 1;  // the input bit into state: pbit
      state = (state >> 1) + (which ? hi : 0);  // pred[state][which]
    }
  }
  if constexpr (!kGlobal) {
    __syncwarp();
    for (int i = lane; i < nbits; i += 32) bf[i] = out[i];
  }
}

// ---- the block and cluster instance: K = 7-18 past the warp's, n <= 8 ------
//
// A frame is C blocks (a thread-block cluster at C > 1; C = 1 a block) of P
// = S / (C E) threads, E states a thread (2-32). Block r of the frame
// computes states r Sb .. r Sb + Sb - 1 (Sb = S / C), thread t of it the E
// consecutive states r Sb + t E + e, whose E/2 pairs 2p, 2p + 1 read the
// E/2 consecutive metrics p and the E/2 at p + S/2. Each block keeps, in
// two rows of Sb (one a step's parity), the metrics its own pairs read:
// the "lo" half p = r Sb/2 .. and the "hi" half p + S/2, so every read is
// local. Its writers put them there: the metrics of block r's first or
// second half of states go to block 2 (r mod C/2) or that + 1, into the lo
// half below C/2 and the hi half from it (distributed shared memory; at C
// = 1 the block's own rows in state order). Each row is swizzled in
// 16-byte groups (swz: group g at g ^ ((g / 8) mod 8) past E = 4), so the
// float4 loads of eight consecutive threads, and their E/4 float4 stores,
// fall on distinct banks. A step:
//   - the previous step's max g: each warp loads the C P/32 warp maxima
//     (int keys) one a lane and reduces them with one redux (one warp a
//     frame: the redux's result, kept);
//   - the ACS of the thread's E states, the reference's rounding order,
//     (m - g) + bm: each state's two branch metrics come from the step's
//     table of the 2^n sums of +-LLR (a sign pattern's: the first product,
//     then each add rounded on its own; a product by +-1 is the LLR with
//     its sign bit flipped), indexed by the state's sign bits (psym < 0,
//     read once into a register);
//   - the decisions: the thread's E bits are one E-bit element of the
//     step's S/32 words (state s at bit s mod 32 of word s / 32), one
//     store, coalesced across the warp (below E = 8, E ballots whose bits
//     are spread into place);
//   - the next step's table, from its LLRs (staged in shared memory where
//     the frame's fit in 32 KB, else loaded a step ahead);
//   - the max: the thread's over its states, the warp's by one redux on
//     the int keys, then lane c of each warp stores it into block c's
//     table (C stores; at C = 1 lane 0 into the block's);
//   - one barrier: the cluster's (barrier.cluster, release and acquire),
//     or the block's, or at P = 32 the warp's.
// The decision words stay in shared memory beside the LLRs ("shared", C =
// 1) where that costs the launch no wave (ops/cuda/fec.py viterbi_layout),
// else they go to device memory, stores nothing waits on. The traceback is
// one warp of block 0: lane l fetches, five steps ahead, the word of the
// l-th state the path can reach by then, (s >> 5) + l S/32 from state s
// (from device memory by cp.async into a ring in shared memory, one group
// a step, so a step waits for the group of five steps before, not for the
// last load), and each step is a select, a shift and an add (the first
// five steps load directly).
constexpr int kAcsMaxN = 8;       // coded bits a step: 2n sign bits a state
constexpr int kAcsThreads = 512;  // threads of a frame's block, at most
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kAcsTab = 1 << kAcsMaxN;  // a step's branch metrics, at most
constexpr int kRing = 10;         // the traceback's steps in flight, twice
constexpr int kAux = 80 + kRing * 32;  // words: 32 warp bests (value, state),
                                       // 8 blocks', the traceback's ring
constexpr int kStageLlr = 8192;   // LLRs staged in shared memory, at most

__device__ __forceinline__ int fkey(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unkey(int m) {
  return __int_as_float(m >= 0 ? m : m ^ 0x7fffffff);
}

// Physical index of logical metric i in a row (16-byte groups swizzled
// past E = 4; i a multiple of 4 where a float4 is read or written).
template <int E>
__device__ __forceinline__ int swz(int i) {
  if constexpr (E >= 8)
    return (((i >> 2) ^ ((i >> 5) & 7)) << 2) | (i & 3);
  else
    return i;
}

// +-r: __fmul_rn(+-1, r) exactly, the sign bit flipped where bit is 1.
__device__ __forceinline__ float flip(float r, unsigned bit) {
  return __int_as_float(__float_as_int(r) ^ (int)(bit << 31));
}

// Q consecutive floats, one load (Q = 1, 2, 4; 4 Q-byte aligned).
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float (&v)[Q]) {
  if constexpr (Q == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (Q == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int E>
using DecElem = std::conditional_t<
    E == 8, uint8_t, std::conditional_t<E == 16, uint16_t, uint32_t>>;

// The 32/E bits of x (x < 2^(32/E)) spread to every E-th bit (E = 2, 4).
template <int E>
__device__ __forceinline__ unsigned spread(unsigned x) {
  if constexpr (E == 2) {
    x = (x | (x << 8)) & 0x00ff00ffu;
    x = (x | (x << 4)) & 0x0f0f0f0fu;
    x = (x | (x << 2)) & 0x33333333u;
    return (x | (x << 1)) & 0x55555555u;
  } else {
    x = (x | (x << 12)) & 0x000f000fu;
    x = (x | (x << 6)) & 0x03030303u;
    return (x | (x << 3)) & 0x11111111u;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The traceback by one warp: from `state` at step T-1 over the step's
// NW = S/32 decision words a step, the bits out (`out` in shared memory, T
// of them, or the frame's nbits in device memory). Lane l fetches, at step
// t, the word at step t - 5 of state (s_t >> 5) + l S/32; the path's
// state at t - 5 is the one of lane m, m the five decisions between
// (hist). kAsync (the words in device memory): the fetch is a cp.async
// into `ring` (kRing x 32 words of shared memory), a group a step; else a
// load into a register, its ring.
template <bool kAsync>
__device__ __forceinline__ void traceback_warp(const unsigned* dec, int T,
                                               int S, int state, int* out,
                                               int* bf, int nbits,
                                               unsigned* ring) {
  const int lane = threadIdx.x & 31, NW = S >> 5, half = S >> 1;
  unsigned reg[5] = {};
  int hist = 0;
#pragma unroll 1
  for (int t0 = T - 1; t0 >= 0; t0 -= kRing) {
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
      const int t = t0 - k;
      if (t < 0) break;
      unsigned w;
      if (t >= T - 5) {
        w = dec[(long long)t * NW + (state >> 5)];
      } else if constexpr (kAsync) {
        asm volatile("cp.async.wait_group 4;\n" ::: "memory");
        __syncwarp();
        w = ring[k * 32 + hist];
      } else {
        w = __shfl_sync(kAll, reg[k % 5], hist);
      }
      const unsigned* src = dec + (long long)(t - 5) * NW +
                            (((state >> 5) + lane * NW) >> 5);
      if constexpr (kAsync) {
        if (t >= 5)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_u32(ring + ((k + 5) % kRing) * 32 + lane)),
                       "l"(src)
                       : "memory");
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      } else {
        if (t >= 5) reg[k % 5] = *src;
      }
      const int which = (w >> (state & 31)) & 1;
      if (lane == 0) {
        if (out)
          out[t] = state & 1;  // the input bit into state: pbit
        else if (t < nbits)
          bf[t] = state & 1;
      }
      state = (state >> 1) + (which ? half : 0);  // pred[state][which]
      hist = (hist >> 1) | (which << 4);
    }
  }
  if constexpr (kAsync) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int E, bool kCluster>
__global__ void __launch_bounds__(kAcsThreads, 1)
viterbi_acs_kernel(const float* __restrict__ llr, int* __restrict__ bits,
                   const float* __restrict__ psym, unsigned* dec_g, int T,
                   int n, int S, int C, int terminated, int nbits, int global) {
  static_assert(E >= 2 && E <= 32 && (E & (E - 1)) == 0, "E a power of 2");
  extern __shared__ __align__(16) unsigned char smem[];
  if (T == 0) return;
  const int P = blockDim.x, NWt = P >> 5, CW = C * NWt, NB = 1 << n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int r = 0;
  if constexpr (kCluster) r = (int)cg::this_cluster().block_rank();
  const long long f = blockIdx.x / C;
  const int Sb = S / C, NW = S >> 5;
  // one warp a frame: its max stays in registers, the rows need no block
  // barrier
  const bool solo = !kCluster && NWt == 1;
  float* rows = reinterpret_cast<float*>(smem);           // 2 x Sb metrics
  float* tab = rows + 2 * Sb;                             // 2 x 2^n metrics
  int* keys = reinterpret_cast<int*>(tab + 2 * kAcsTab);  // 2 x CW maxima
  float* wv = reinterpret_cast<float*>(keys + 2 * CW);    // warp bests
  int* ws = reinterpret_cast<int*>(wv + 32);
  float* cv = reinterpret_cast<float*>(ws + 32);          // block bests
  int* cs = reinterpret_cast<int*>(cv + kMaxCluster);
  unsigned* ring = reinterpret_cast<unsigned*>(cs + kMaxCluster);
  float* stage = reinterpret_cast<float*>(ring + kRing * 32);
  const float* rsrc = llr + f * T * n;  // the frame's T x n LLRs
  unsigned* dec = dec_g ? dec_g + f * T * NW : nullptr;
  int* out = nullptr;
  if (!global || T * n <= kStageLlr) {  // the LLRs staged
    for (int i = tid; i < T * n; i += P) stage[i] = rsrc[i];
    rsrc = stage;
  }
  if (!global) {  // and the decision words and bits (C = 1)
    dec = reinterpret_cast<unsigned*>(stage + T * n);
    out = reinterpret_cast<int*>(dec + (long long)T * NW);
  }
  // each state's two branches: their symbols' sign bits (bit j: psym < 0),
  // the indices of their metrics in the step's table, in bytes 0 and 1
  unsigned sg[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long s = (long long)r * Sb + tid * E + e;
    unsigned w = 0;
    for (int b = 0; b < 2; ++b)
      for (int j = 0; j < n; ++j)
        if (__ldg(psym + (s * 2 + b) * n + j) < 0.f) w |= 1u << (8 * b + j);
    sg[e] = w;
  }
  for (int i = tid; i < Sb; i += P)  // the metrics before step 0
    rows[Sb + swz<E>(i)] = r == 0 && i == 0 ? 0.f : kNeg;
  // Step t's 2^n branch metrics, one a sign pattern, into tab's slot
  // t & 1: the LLRs with their sign bits flipped, summed in order (the
  // first product, then each add rounded on its own), as every state's.
  const auto fill_tab = [&](int t, const float (&x)[kAcsMaxN]) {
    for (int sgn = tid; sgn < NB; sgn += P) {
      float bm = flip(x[0], sgn & 1);
#pragma unroll
      for (int j = 1; j < kAcsMaxN; ++j)
        if (j < n) bm = __fadd_rn(bm, flip(x[j], (sgn >> j) & 1));
      tab[(t & 1) * kAcsTab + sgn] = bm;
    }
  };
  const bool filler = tid < NB;  // a thread of the table: the LLRs
  float rn[kAcsMaxN] = {};       // the next step's LLRs
  // where the thread's new metrics go: its destination block's row
  // (distributed shared memory at C > 1), at its states' offset + woff
  constexpr int H = E / 2, Q = H < 4 ? H : 4;  // pairs; a load's pairs
  float* wdst = rows;
  int woff = 0;
  if constexpr (kCluster) {
    const int hb = tid * E >= Sb / 2;  // the second half of its states
    wdst = cg::this_cluster().map_shared_rank(rows, 2 * (r % (C / 2)) + hb);
    woff = (r >= C / 2 ? Sb / 2 : 0) - hb * (Sb / 2);
  }
  int* key_dst = keys;  // lane c's table: block c's
  if constexpr (kCluster)
    key_dst = cg::this_cluster().map_shared_rank(keys, lane < C ? lane : 0);
  if (kCluster || !solo) {
    if constexpr (kCluster)
      cg::this_cluster().sync();  // every block started, its rows set
    else
      __syncthreads();
  } else {
    __syncwarp();
  }
  if (filler) {
    float r0[kAcsMaxN] = {};
#pragma unroll
    for (int j = 0; j < kAcsMaxN; ++j) {
      r0[j] = j < n ? rsrc[j] : 0.f;
      rn[j] = j < n && T > 1 ? rsrc[n + j] : 0.f;
    }
    fill_tab(0, r0);
  }
  if (kCluster || !solo) {
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
  } else {
    __syncwarp();
  }
  const auto step_max = [&](int t) {  // g of step t, in every lane
    const int* kk = keys + (t & 1) * CW;
    int x = INT_MIN;
    for (int i = lane; i < CW; i += 32) x = max(x, kk[i]);
    return unkey(__reduce_max_sync(kAll, x));
  };
  const int off_lo = tid * H, off_hi = Sb / 2 + tid * H;
  float g = 0.f;  // the previous step's max (0 before the first step)
  for (int t = 0; t < T; ++t) {
    if (t > 0 && !solo) g = step_max(t - 1);
    const float* tb = tab + (t & 1) * kAcsTab;
    const float* prev = rows + ((t - 1) & 1) * Sb;
    float* cur = wdst + (t & 1) * Sb;
    float mx = -INFINITY;
    unsigned mask = 0;
#pragma unroll
    for (int h0 = 0; h0 < H; h0 += Q) {
      float a[Q], b[Q], v[2 * Q];
      load_q<Q>(prev + swz<E>(off_lo + h0), a);
      load_q<Q>(prev + swz<E>(off_hi + h0), b);
#pragma unroll
      for (int h = 0; h < Q; ++h) {
        const float m0 = __fsub_rn(a[h], g), m1 = __fsub_rn(b[h], g);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * (h0 + h) + u;
          const float c0 = __fadd_rn(m0, tb[sg[e] & 0xff]);
          const float c1 = __fadd_rn(m1, tb[sg[e] >> 8]);
          const bool ch = c1 > c0;  // the first maximum, as jnp.argmax
          v[2 * h + u] = ch ? c1 : c0;
          mx = fmaxf(mx, v[2 * h + u]);
          mask |= (unsigned)ch << e;
        }
      }
      const int i0 = tid * E + 2 * h0 + woff;
      if constexpr (2 * Q == 2) {
        *reinterpret_cast<float2*>(cur + i0) = make_float2(v[0], v[1]);
      } else {
#pragma unroll
        for (int q = 0; q < 2 * Q; q += 4)
          *reinterpret_cast<float4*>(cur + swz<E>(i0 + q)) =
              make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
    }
    unsigned* drow = dec + (long long)t * NW;
    if constexpr (E >= 8) {
      reinterpret_cast<DecElem<E>*>(drow)[r * (Sb / E) + tid] =
          (DecElem<E>)mask;
    } else {  // E ballots; word w: lanes w 32/E .., state bit (l E + e) % 32
      unsigned wd = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned bl = __ballot_sync(kAll, (mask >> e) & 1);
        wd |= spread<E>((bl >> (lane * (32 / E))) & ((1u << (32 / E)) - 1)) << e;
      }
      if (lane < E && lane * 32 < Sb) drow[(r * Sb >> 5) + (tid >> 5) * E + lane] = wd;
    }
    if (filler && t + 1 < T) {  // the next step's table; its LLRs' load
      fill_tab(t + 1, rn);
#pragma unroll
      for (int j = 0; j < kAcsMaxN; ++j)
        rn[j] = j < n && t + 2 < T ? rsrc[(t + 2) * n + j] : 0.f;
    }
    const int key = __reduce_max_sync(kAll, fkey(mx));
    if constexpr (kCluster) {
      if (lane < C) key_dst[(t & 1) * CW + r * NWt + warp] = key;
      cg::this_cluster().sync();
    } else if (solo) {
      g = unkey(key);
      __syncwarp();
    } else {
      if (lane == 0) keys[(t & 1) * CW + warp] = key;
      __syncthreads();
    }
  }
  if constexpr (kCluster) {  // the words of every block, before block 0 reads
    __threadfence();
    cg::this_cluster().sync();
  }
  int state = 0;
  if (!terminated) {  // argmax of the last metrics less their max: the
                      // first, by state
    if (!solo) g = step_max(T - 1);
    const float* last = rows + ((T - 1) & 1) * Sb;
    float bv = -INFINITY;
    int bs = INT_MAX;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = tid * E + e;  // a row offset: the lo half, then the hi
      const int st = (j < Sb / 2 ? 0 : S / 2 - Sb / 2) + r * (Sb / 2) + j;
      const float fe = __fsub_rn(last[swz<E>(j)], g);
      if (fe > bv || (fe == bv && st < bs)) bv = fe, bs = st;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kAll, bv, o);
      const int os = __shfl_xor_sync(kAll, bs, o);
      if (ov > bv || (ov == bv && os < bs)) bv = ov, bs = os;
    }
    if (lane == 0) wv[warp] = bv, ws[warp] = bs;
    __syncthreads();
    if (tid == 0) {
      bv = wv[0], bs = ws[0];
      for (int w = 1; w < NWt; ++w)
        if (wv[w] > bv || (wv[w] == bv && ws[w] < bs)) bv = wv[w], bs = ws[w];
      if constexpr (kCluster) {
        cg::cluster_group cl = cg::this_cluster();
        cl.map_shared_rank(cv, 0)[r] = bv;
        cl.map_shared_rank(cs, 0)[r] = bs;
      } else {
        cs[0] = bs;
      }
    }
    if constexpr (kCluster)
      cg::this_cluster().sync();
    else
      __syncthreads();
    if (r == 0) {
      bv = cv[0], bs = cs[0];
      if constexpr (kCluster)
        for (int c = 1; c < C; ++c)
          if (cv[c] > bv || (cv[c] == bv && cs[c] < bs)) bv = cv[c], bs = cs[c];
      state = bs;
    }
  }
  if (r != 0) return;
  int* bf = bits + f * nbits;
  if (warp == 0) {
    if (out)
      traceback_warp<false>(dec, T, S, state, out, bf, nbits, ring);
    else
      traceback_warp<true>(dec, T, S, state, out, bf, nbits, ring);
  }
  if (out) {
    __syncthreads();
    for (int i = tid; i < nbits; i += P) bf[i] = out[i];
  }
}

using WarpKernel = void (*)(const float*, int*, const float*, unsigned*, int,
                            int, int, int, int);
using BlockKernel = void (*)(const float*, int*, const float*, unsigned*,
                             float*, int, int, int, int, int, int);

template <int E, bool kGlobal>
WarpKernel warp_instance(int n) {
  switch (n) {
    case 1: return viterbi_warp_kernel<E, 1, kGlobal>;
    case 2: return viterbi_warp_kernel<E, 2, kGlobal>;
    case 3: return viterbi_warp_kernel<E, 3, kGlobal>;
    default: return viterbi_warp_kernel<E, 4, kGlobal>;
  }
}

template <int E>
WarpKernel warp_instance(int n, int global) {
  return global ? warp_instance<E, true>(n) : warp_instance<E, false>(n);
}

BlockKernel block_instance(int E) {
  switch (E) {
    case 1: return viterbi_kernel<1>;
    case 2: return viterbi_kernel<2>;
    case 4: return viterbi_kernel<4>;
    case 8: return viterbi_kernel<8>;
    case 16: return viterbi_kernel<16>;
    default: return viterbi_kernel<0>;
  }
}

using AcsKernel = void (*)(const float*, int*, const float*, unsigned*, int,
                           int, int, int, int, int, int);

AcsKernel acs_instance(int E, bool cluster) {
  if (cluster) {
    switch (E) {
      case 8: return viterbi_acs_kernel<8, true>;
      case 16: return viterbi_acs_kernel<16, true>;
      default: return viterbi_acs_kernel<32, true>;
    }
  }
  switch (E) {
    case 2: return viterbi_acs_kernel<2, false>;
    case 4: return viterbi_acs_kernel<4, false>;
    case 8: return viterbi_acs_kernel<8, false>;
    case 16: return viterbi_acs_kernel<16, false>;
    default: return viterbi_acs_kernel<32, false>;
  }
}

template <class Kernel>
int allow_smem(Kernel fn, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

static constexpr int kSmemMaxS = 16384;  // K = 15: the last metrics in a block

// Shared memory of a frame's block in the block instance and of a frame's
// warp in the warp instance, staged (global = 0) or not (ops/cuda/fec.py
// `viterbi_smem` mirrors both, to plan the route and name the limit).
static long long viterbi_smem(int T, int n, int S, int global) {
  const long long NW = S < 32 ? 1 : S / 32;
  return 4LL * ((S > kSmemMaxS ? 0 : 2LL * S) + 64 +
                (global ? 0 : (long long)T * n + T * NW + T));
}

static long long viterbi_warp_smem(int T, int n, int S, int global) {
  return global ? 0 : 4LL * T * (n + (S < 32 ? 1 : S / 32));
}

static constexpr long long kSmemMax = 232448;  // a block on the H100
static constexpr int kMaxS = 1 << 26;          // K = 27

// warp: the warp instance (S <= 256, n <= 4), else the block instance;
// global: the frame's LLRs and decision words in device memory (dec: F T
// max(1, S/32) words), else staged in shared memory, which must hold them;
// past kSmemMaxS states (K = 15) the block instance's metrics in device
// memory too (metrics: F 2 S floats), and the global route.
extern "C" int viterbi_launch(const float* llr, int* bits, const float* psym,
                              unsigned* dec, float* metrics, int F, int T,
                              int n, int S, int terminated, int nbits,
                              int warp, int global, void* stream) {
  const bool wide = S > kSmemMaxS;
  if (F < 0 || T < 0 || n < 1 || S < 2 || S > kMaxS || (S & (S - 1)) ||
      nbits < 0 || nbits > T || (warp && (S > kWarpMaxS || n > kMaxN)) ||
      (global && dec == nullptr) ||
      (wide && (warp || !global || metrics == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (warp) {
    const long long per = viterbi_warp_smem(T, n, S, global);
    if (per > kSmemMax) return (int)cudaErrorInvalidValue;
    const int wpb = (int)std::min<long long>(
        kWarpFrames, per ? kSmemMax / per : kWarpFrames);
    WarpKernel fn;
    switch (S < 32 ? 1 : S / 32) {
      case 1: fn = warp_instance<1>(n, global); break;
      case 2: fn = warp_instance<2>(n, global); break;
      case 4: fn = warp_instance<4>(n, global); break;
      default: fn = warp_instance<8>(n, global);
    }
    const long long smem = per * wpb;
    if (const int e = allow_smem(fn, smem)) return e;
    fn<<<(F + wpb - 1) / wpb, 32 * wpb, (size_t)smem, st>>>(
        llr, bits, psym, dec, F, T, S, terminated, nbits);
    return (int)cudaGetLastError();
  }
  const long long smem = viterbi_smem(T, n, S, global);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int threads = std::max(32, std::min(S, kBlockThreads));
  const BlockKernel fn = block_instance(S / threads > 0 ? S / threads : 1);
  if (const int e = allow_smem(fn, smem)) return e;
  fn<<<F, threads, (size_t)smem, st>>>(llr, bits, psym, dec,
                                       wide ? metrics : nullptr, T, n, S,
                                       terminated, nbits, global);
  return (int)cudaGetLastError();
}


// Shared memory of a block of the block and cluster instance (ops/cuda/
// fec.py `viterbi_smem` mirrors it): its two rows of Sb metrics, two
// steps' tables of branch metrics, two tables of C P/32 warp maxima, the
// bests and the traceback's ring, the frame's LLRs where they are staged
// (at most kStageLlr of them on the global route), and, staged (global =
// 0), its decision words and bits.
static long long viterbi_acs_smem(int T, int n, int S, int E, int C,
                                  int global) {
  const long long Sb = S / C, CW = (long long)C * (Sb / E / 32);
  const long long llr = !global || (long long)T * n <= kStageLlr
                            ? (long long)T * n : 0;
  return 4LL * (2 * Sb + 2 * kAcsTab + 2 * CW + kAux + llr +
                (global ? 0 : (long long)T * (S / 32) + T));
}

// The block (C = 1) and cluster (C = 2, 4, 8) instance: F frames of T
// steps, S >= 64 states, E states a thread, n <= 8; global: the decision
// words in dec (F T S/32 words) and the LLRs read from device memory, else
// staged in shared memory (C = 1 only).
extern "C" int viterbi_acs_launch(const float* llr, int* bits,
                                  const float* psym, unsigned* dec, int F,
                                  int T, int n, int S, int E, int C,
                                  int terminated, int nbits, int global,
                                  void* stream) {
  const bool okE = E == 2 || E == 4 || E == 8 || E == 16 || E == 32;
  const bool okC = C == 1 || C == 2 || C == 4 || C == 8;
  if (F < 0 || T < 0 || n < 1 || n > kAcsMaxN || S < 64 || S > kMaxS ||
      (S & (S - 1)) || !okE || !okC || nbits < 0 || nbits > T ||
      (global && dec == nullptr) || (C > 1 && (!global || E < 8)))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)S / C / E;
  if (threads < 32 || threads > kAcsThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const long long smem = viterbi_acs_smem(T, n, S, E, C, global);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const AcsKernel fn = acs_instance(E, C > 1);
  if (const int e = allow_smem(fn, smem)) return e;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 1) {
    fn<<<F, (int)threads, (size_t)smem, st>>>(llr, bits, psym, dec, T, n, S,
                                             C, terminated, nbits, global);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)F * C);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, llr, bits, psym, dec,
                                             T, n, S, C, terminated, nbits,
                                             global);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
