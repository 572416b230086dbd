// S4 iir_filter and S5 agc for Hopper (sm_90a): the two linear recurrences
// of the DSP half, each one launch a call.
//
// Neither has a TPU kernel. Each replaces a `lax.associative_scan` of the
// reference: newsched_tpu/ops/iir.py `_ar_scan` (the scans at :51 and :74,
// with the feed-forward taps applied before it by `fir_filter` "conv" at
// :90) and newsched_tpu/ops/agc.py `agc` (the scan at :54). Torch has no
// associative scan.
//
// What bounds them on the H100 is bytes (each sample read once and written
// once: S4 at 104448 rf32 samples 0.84 MB, 0.00025 ms; S5 at 2^20 cf32
// samples 16.8 MB, 0.0050 ms) and, below that, the latency of a launch and
// of the round trips through L2 that tie the tiles together. So both are a
// single-pass chained scan in the manner of decoupled look-back (Merrill
// and Garland, 2016), with as few dependent round trips as it can have:
//   - a block takes its tile (kTile samples) from a ticket (atomicAdd), not
//     from blockIdx, so it waits only for tiles whose blocks already run;
//     the ticket counter is never reset: ticket / gridDim is the launch's
//     epoch, and a flag holds the epoch (+1) it was published in, so a flag
//     left by an earlier launch reads as unpublished;
//   - a tile is staged in shared memory (coalesced loads; one pad word in
//     32 so that each thread's kSeg consecutive samples fall in distinct
//     banks), and each thread runs its kSeg samples sequentially from a
//     zero state, keeping the end state;
//   - each warp scans its threads' states by shuffles; one thread composes
//     the 8 warps' totals into the tile's aggregate (its end state from a
//     zero start) and publishes it behind a flag (st.release); the last
//     tile of each group of kGroup tiles also composes and publishes the
//     group's aggregate from its tiles';
//   - warp 0 then composes, with the carried state, the aggregates of the
//     groups before its tile's and of the tiles of its group before it:
//     lane l takes two tiles and (where there are more than 32 groups)
//     every 32nd group, polls all its flags at once (relaxed loads, then
//     one fence) and loads their values at once. Where the look-back of the
//     paper stops at the nearest tile whose inclusive state is ready, the
//     order of the sum would follow the timing, and the outputs would not
//     repeat bit for bit (a captured graph replayed twice could differ);
//     here the partition is fixed by the tile's index alone, and the lanes
//     combine in a fixed tree. A tile publishes before it waits, and waits
//     at most two publications deep;
//   - each thread then reruns its segment from its true start state and
//     writes its outputs: twice the arithmetic, which is nothing here, and
//     each output carries the rounding of the plain recurrence, not that of
//     a correction term.
// The ticket and the flags live in a workspace that the caller keeps (one
// per block instance, zeroed when made): a captured graph replays with no
// reset launch and nothing passed from the host per launch.
//
// S4: y[n] = v[n] + sum_k fb[k] y[n-1-k], v = sum_k ff[k] x[n-k] (up to
// kMaxFf feed-forward taps; with more the wrapper computes v outside and
// passes ff = [1]). The coefficients are constant, so only the state vector
// z = [y[n], ..., y[n-P+1]] combines: z <- A^L z + e, with A the companion
// matrix and two host-built tables (float64, stored as float32): the powers
// pows[k] = A^(kSeg 2^k), k < 6 (the warps' scans, and A^(32 kSeg) from one
// warp to the next), and the distances dist[m] = A^(kTile m), m < ntiles
// (tile j's aggregate reaches tile i's start through dist[i - 1 - j], the
// carried state through dist[i]); a sum, so lane l takes the tiles first +
// l and first + 32 + l of the group, and the groups l, l + 32, ... Orders
// 1-4 are instances of their own; orders 5-16 run the
// P = 16 instance with the taps padded by zeros. A complex stream with real
// taps is two real streams (cs = 2, the interleaved floats at stride 2),
// each tile of each a ticket of its own.
//
// S5: g[n+1] = a[n] g[n] + b, a[n] = 1 - rate |x[n]|, b = rate reference;
// y[n] = x[n] min(g[n], max_gain) (no clamp where max_gain <= 0), the new
// gain g[n] after the batch, clamped the same way: the scan runs over the
// affine maps (prod a, B), which do not commute, so lane l of warp 0 takes
// the tiles first + 2 l and first + 2 l + 1 and the contiguous groups
// [l q, (l + 1) q), q = ceil(groups / 32), and the lanes compose in order.
// rate and reference come from the card where the
// wrapper passes pointers (the block's settable parameters).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;                   // samples a thread
constexpr int kTile = kThreads * kSeg;    // samples a tile
constexpr int kHalo = 32;                 // S4: FIR history slots before a tile
constexpr int kMaxFf = kHalo;             // S4: feed-forward taps in the kernel
constexpr int kMaxP = 16;                 // S4: the widest state
constexpr int kPows = 6;                  // S4: A^(kSeg 2^k), k < kPows
constexpr int kGroup = 64;                // tiles a group (its last tile
                                          // publishes the group's aggregate)
constexpr unsigned kFull = 0xffffffffu;

// shared-memory slot of tile sample i (i >= -kHalo): a pad word every 32
__device__ __forceinline__ int slot(int i) {
  i += kHalo;
  return i + (i >> 5);
}
constexpr int kSlots = kHalo + kTile + (kHalo + kTile) / 32 + 1;

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The workspace: a 64-bit ticket counter, then a flag a slot (a tile and
// part), then a flag a group and part. Returns this block's index in the
// launch; *want: the value its launch's flags are published with.
__device__ __forceinline__ int take_ticket(unsigned long long* ticket,
                                           unsigned* want) {
  __shared__ unsigned long long got;
  if (threadIdx.x == 0) got = atomicAdd(ticket, 1ull);
  __syncthreads();
  *want = (unsigned)(got / gridDim.x) + 1u;
  return (int)(got % gridDim.x);
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// Waits until the flags f0, f1 and f2 (null: none), polled together, hold
// `want`; then an acquire fence: the values behind them are then read. A
// flag that never comes (a workspace launched from two streams at once)
// ends the launch with an error after some seconds, not a hang.
__device__ __forceinline__ void wait_flags(unsigned want, const unsigned* f0,
                                           const unsigned* f1 = nullptr,
                                           const unsigned* f2 = nullptr) {
  for (long long i = 0;; ++i) {
    const bool a = !f0 || ld_relaxed(f0) == want;
    const bool b = !f1 || ld_relaxed(f1) == want;
    const bool d = !f2 || ld_relaxed(f2) == want;
    if (a && b && d) break;
    if (i > (1ll << 22)) __trap();
    __nanosleep(64);
  }
  fence_acq_rel();
}

// (A2, B2) <- (A2, B2) o (A1, B1), the map g -> A2 (A1 g + B1) + B2
__device__ __forceinline__ void compose(float& A2, float& B2, float A1,
                                        float B1) {
  B2 = fmaf(A2, B1, B2);
  A2 = A2 * A1;
}

// Lane 0's map becomes lane 31's o ... o lane 0's: each lane's map after
// the one of the lane before it.
__device__ __forceinline__ void reduce_maps(float& A, float& B, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float oA = __shfl_down_sync(kFull, A, o);
    float oB = __shfl_down_sync(kFull, B, o);
    if (lane + o < 32) {
      compose(oA, oB, A, B);
      A = oA;
      B = oB;
    }
  }
}

// o = M v for a row-major P x P M (shared or device memory).
template <int P>
__device__ __forceinline__ void matvec(const float* M, const float (&v)[P],
                                       float (&o)[P]) {
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float s = 0.f;
    if constexpr (P % 4 == 0) {
#pragma unroll
      for (int k = 0; k < P; k += 4) {
        const float4 m = *reinterpret_cast<const float4*>(M + r * P + k);
        s = fmaf(m.x, v[k], s);
        s = fmaf(m.y, v[k + 1], s);
        s = fmaf(m.z, v[k + 2], s);
        s = fmaf(m.w, v[k + 3], s);
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) s = fmaf(M[r * P + k], v[k], s);
    }
    o[r] = s;
  }
}

// o += M v for a row-major P x P M (shared or device memory).
template <int P>
__device__ __forceinline__ void matvec_add(const float* M, const float (&v)[P],
                                           float (&o)[P]) {
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float s = o[r];
#pragma unroll
    for (int k = 0; k < P; ++k) s = fmaf(M[r * P + k], v[k], s);
    o[r] = s;
  }
}

// v <- A^(kSeg m) v, m < 32: pows[k] for each binary digit k of m.
template <int P>
__device__ __forceinline__ void apply_power(const float* pows, int m,
                                            float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (m >> k & 1) {
      float o[P];
      matvec<P>(pows + k * P * P, v, o);
#pragma unroll
      for (int r = 0; r < P; ++r) v[r] = o[r];
    }
  }
}

// One step of the recurrence: y = v + fb . z, z shifted down with y on top.
template <int P>
__device__ __forceinline__ float ar_step(const float (&fb)[P], float (&z)[P],
                                         float v) {
  float y = v;
#pragma unroll
  for (int k = 0; k < P; ++k) y = fmaf(fb[k], z[k], y);
#pragma unroll
  for (int k = P - 1; k > 0; --k) z[k] = z[k - 1];
  z[0] = y;
  return y;
}

// S4. Grid: one block a (tile, component), ntiles * cs blocks.
//   x, y: n samples of a stream at stride cs (floats; cs = 2: the real and
//     imaginary parts of a complex stream, one real recurrence each);
//   tail_in, tail_out: the nff - 1 samples before x, and after the call;
//   ff: nff <= kMaxFf feed-forward taps; fb: P feedback taps (zero past
//     order); pows: kPows powers A^(kSeg 2^k); dist: ntiles powers
//     A^(kTile m); P x P each, row-major;
//   hist_in, hist_out: `order` outputs, [0] the latest (y_hist);
//   ticket, flags: the workspace's, for this cs (ntiles + ngroups) * cs
//     flags; vals: P floats a slot (tile * cs + c), then a group's
//     (group * cs + c).
template <int P>
__global__ void __launch_bounds__(kThreads)
    iir_scan_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                    int cs, const float* __restrict__ tail_in,
                    float* __restrict__ tail_out, const float* __restrict__ ff,
                    int nff, const float* __restrict__ fb_g,
                    const float* __restrict__ pows,
                    const float* __restrict__ dist,
                    const float* __restrict__ hist_in,
                    float* __restrict__ hist_out, int order,
                    unsigned long long* ticket, unsigned* flags, float* vals,
                    int ntiles) {
  __shared__ float xs[kSlots];
  __shared__ __align__(16) float pw[kPows * P * P];
  __shared__ float wt[kWarps][P];  // each warp's total, then its start state
  __shared__ float ffs[kMaxFf];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned want;
  const int me = take_ticket(ticket, &want);  // the slot: tile * cs + c
  const int c = me % cs, tile = me / cs;
  const int base = tile * kTile;

  for (int i = t; i < kPows * P * P; i += kThreads) pw[i] = pows[i];
  if (t < nff) ffs[t] = ff[t];
  {
    // every load of the thread issued before the first use: sample
    // t + kThreads u of the tile, and the halo's t - kHalo
    float r[kSeg + 1];
#pragma unroll
    for (int u = 0; u <= kSeg; ++u) {
      const int i = u < kSeg ? t + u * kThreads : t - kHalo;
      const int g = base + i;
      r[u] = 0.f;
      if (u < kSeg || t < kHalo) {
        if (g >= 0 && g < n)
          r[u] = x[(size_t)g * cs + c];
        else if (g < 0 && g >= 1 - nff)
          r[u] = tail_in[(size_t)(nff - 1 + g) * cs + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) xs[slot(t + u * kThreads)] = r[u];
    if (t < kHalo) xs[slot(t - kHalo)] = r[kSeg];
  }
  float fb[P];
#pragma unroll
  for (int k = 0; k < P; ++k) fb[k] = fb_g[k];
  __syncthreads();

  // the feed-forward part, and the segment from a zero state
  const int i0 = t * kSeg;
  float v[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) v[j] = 0.f;
  for (int k = 0; k < nff; ++k) {
    const float h = ffs[k];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) v[j] = fmaf(h, xs[slot(i0 + j - k)], v[j]);
  }
  float z[P];
#pragma unroll
  for (int k = 0; k < P; ++k) z[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) ar_step<P>(fb, z, v[j]);

  // the warp's inclusive scan of its segments' states, by shuffles
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    float w[P];
#pragma unroll
    for (int r = 0; r < P; ++r) w[r] = __shfl_up_sync(kFull, z[r], d);
    if (lane >= d) matvec_add<P>(pw + k * P * P, w, z);
  }
  if (lane == 31) {
#pragma unroll
    for (int r = 0; r < P; ++r) wt[warp][r] = z[r];
  }
  __syncthreads();

  // warp 0: the tile's aggregate published (by the last tile of a group,
  // the group's too), then the state at the tile's start from the carried
  // state, the groups before this tile's and the tiles of its group before
  // it, then each warp's start state
  if (warp == 0) {
    const int grp = tile / kGroup, first = grp * kGroup;
    unsigned* gflags = flags + ntiles * cs;
    float* gvals = vals + (size_t)ntiles * cs * P;
    float agg[P];
#pragma unroll
    for (int r = 0; r < P; ++r) agg[r] = wt[0][r];
    if (lane == 0) {
      for (int w = 1; w < kWarps; ++w) {
        float o[P];
#pragma unroll
        for (int r = 0; r < P; ++r) o[r] = wt[w][r];
        matvec_add<P>(pw + 5 * P * P, agg, o);  // A^(32 kSeg)
#pragma unroll
        for (int r = 0; r < P; ++r) agg[r] = o[r];
      }
      if (tile < ntiles - 1) {
#pragma unroll
        for (int r = 0; r < P; ++r) __stcg(vals + (size_t)me * P + r, agg[r]);
        st_release(flags + me, want);
      }
    }
    // lane l's tiles of the group: first + l and first + 32 + l
    const int j0 = first + lane, j1 = first + 32 + lane;
    if (tile % kGroup == kGroup - 1 && tile < ntiles - 1) {
      // the group's aggregate: tile j reaches the group's end through
      // first + kGroup - 1 - j tiles; j1 of lane 31 is this tile
      float w0[P], w1[P], ga[P];
      wait_flags(want, flags + j0 * cs + c,
                 lane < 31 ? flags + j1 * cs + c : nullptr);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        w0[r] = __ldcg(vals + (size_t)(j0 * cs + c) * P + r);
        const float own = __shfl_sync(kFull, agg[r], 0);
        w1[r] = lane < 31 ? __ldcg(vals + (size_t)(j1 * cs + c) * P + r) : own;
        ga[r] = 0.f;
      }
      matvec_add<P>(dist + (size_t)(kGroup - 1 - lane) * P * P, w0, ga);
      matvec_add<P>(dist + (size_t)(31 - lane) * P * P, w1, ga);
#pragma unroll
      for (int r = 0; r < P; ++r)
#pragma unroll
        for (int o = 16; o; o >>= 1) ga[r] += __shfl_xor_sync(kFull, ga[r], o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < P; ++r)
          __stcg(gvals + (size_t)(grp * cs + c) * P + r, ga[r]);
        st_release(gflags + grp * cs + c, want);
      }
    }
    float acc[P];
#pragma unroll
    for (int r = 0; r < P; ++r) acc[r] = 0.f;
    if (lane == 0 && order > 0) {
      float h[P];
#pragma unroll
      for (int r = 0; r < P; ++r)
        h[r] = r < order ? hist_in[(size_t)r * cs + c] : 0.f;
      matvec_add<P>(dist + (size_t)tile * P * P, h, acc);
    }
    // and the groups g = l, l + 32, ... before this tile's (group g ends
    // kGroup (g + 1) tiles from this tile's start)
    wait_flags(want, lane < grp ? gflags + lane * cs + c : nullptr,
               j0 < tile ? flags + j0 * cs + c : nullptr,
               j1 < tile ? flags + j1 * cs + c : nullptr);
    for (int g = lane; g < grp; g += 32) {
      if (g != lane) wait_flags(want, gflags + g * cs + c);
      float w[P];
#pragma unroll
      for (int r = 0; r < P; ++r)
        w[r] = __ldcg(gvals + (size_t)(g * cs + c) * P + r);
      matvec_add<P>(dist + (size_t)(tile - kGroup * (g + 1)) * P * P, w, acc);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = h ? j1 : j0;
      if (j < tile) {
        float w[P];
#pragma unroll
        for (int r = 0; r < P; ++r)
          w[r] = __ldcg(vals + (size_t)(j * cs + c) * P + r);
        matvec_add<P>(dist + (size_t)(tile - 1 - j) * P * P, w, acc);
      }
    }
#pragma unroll
    for (int r = 0; r < P; ++r)
#pragma unroll
      for (int o = 16; o; o >>= 1) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
    if (lane == 0) {
      // acc: the tile's start; each warp's start in its total's place
      for (int w = 0; w < kWarps; ++w) {
        float tot[P];
#pragma unroll
        for (int r = 0; r < P; ++r) {
          tot[r] = wt[w][r];
          wt[w][r] = acc[r];
        }
        matvec_add<P>(pw + 5 * P * P, acc, tot);  // A^(32 kSeg)
#pragma unroll
        for (int r = 0; r < P; ++r) acc[r] = tot[r];
      }
    }
  }
  __syncthreads();

  // the true start state of this thread's segment: A^(kSeg lane) times its
  // warp's, and the warp's states before it from a zero start (the scan's
  // inclusive state of the lane before); then the rerun
  {
    float st[P];
#pragma unroll
    for (int r = 0; r < P; ++r) st[r] = wt[warp][r];
    apply_power<P>(pw, lane, st);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const float e = __shfl_up_sync(kFull, z[r], 1);
      z[r] = lane == 0 ? st[r] : st[r] + e;
    }
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int g = base + i0 + j;
    if (g < n) {
      v[j] = ar_step<P>(fb, z, v[j]);
      if (g == n - 1)
        for (int r = 0; r < order; ++r) hist_out[(size_t)r * cs + c] = z[r];
    }
  }
  // own slots only: the FIR read the others' before the warps' barrier
#pragma unroll
  for (int j = 0; j < kSeg; ++j) xs[slot(i0 + j)] = v[j];
  __syncthreads();
  for (int i = t; i < kTile; i += kThreads) {
    const int g = base + i;
    if (g < n) y[(size_t)g * cs + c] = xs[slot(i)];
  }
  // the new FIR history: the last nff - 1 samples of [tail_in, x]
  if (tile == ntiles - 1 && t < nff - 1) {
    const int idx = n + t;  // in [tail_in, x]
    tail_out[(size_t)t * cs + c] = idx < nff - 1
                                       ? tail_in[(size_t)idx * cs + c]
                                       : x[(size_t)(idx - (nff - 1)) * cs + c];
  }
}

// S5. Grid: one block a tile. x, y: n samples (float2 where kCplx);
// gain_in, gain_out: the carried gain; rate and reference from rate_p,
// ref_p where not null, else the host values; ticket, flags: the
// workspace's, ntiles + ngroups flags; vals: a tile's aggregate (A, B), a
// float2, then a group's.
template <bool kCplx>
__global__ void __launch_bounds__(kThreads)
    agc_scan_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                    const float* __restrict__ gain_in,
                    float* __restrict__ gain_out, const float* rate_p,
                    const float* ref_p, float rate_h, float ref_h,
                    float max_gain, unsigned long long* ticket,
                    unsigned* flags, float2* vals, int ntiles) {
  __shared__ float xr[kSlots];
  __shared__ float xi[kCplx ? kSlots : 1];
  __shared__ float tA[kWarps], tB[kWarps];  // warp totals
  __shared__ float gw[kWarps];              // the gain at each warp's start

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned want;
  const int tile = take_ticket(ticket, &want);
  const int base = tile * kTile;
  const float rate = rate_p ? *rate_p : rate_h;
  const float ref = ref_p ? *ref_p : ref_h;
  const float b = __fmul_rn(rate, ref);

  {
    // every load of the thread issued before the first use
    float2 r[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int g = base + t + u * kThreads;
      r[u] = make_float2(0.f, 0.f);
      if (g < n) {
        if constexpr (kCplx)
          r[u] = reinterpret_cast<const float2*>(x)[g];
        else
          r[u].x = x[g];
      }
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      xr[slot(t + u * kThreads)] = r[u].x;
      if constexpr (kCplx) xi[slot(t + u * kThreads)] = r[u].y;
    }
  }
  __syncthreads();

  // the segment's map from the identity
  const int i0 = t * kSeg;
  float a[kSeg], re[kSeg], im[kSeg];
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    re[j] = xr[slot(i0 + j)];
    im[j] = kCplx ? xi[slot(i0 + j)] : 0.f;
    const float mag = kCplx ? hypotf(re[j], im[j]) : fabsf(re[j]);
    a[j] = __fsub_rn(1.f, __fmul_rn(rate, mag));
    if (base + i0 + j < n) {
      float Aj = a[j], Bj = b;
      compose(Aj, Bj, A, B);
      A = Aj;
      B = Bj;
    }
  }
  // the warp's inclusive scan of the maps, by shuffles
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    const float pA = __shfl_up_sync(kFull, A, d);
    const float pB = __shfl_up_sync(kFull, B, d);
    if (lane >= d) compose(A, B, pA, pB);
  }
  float eA = __shfl_up_sync(kFull, A, 1), eB = __shfl_up_sync(kFull, B, 1);
  if (lane == 0) {
    eA = 1.f;
    eB = 0.f;
  }
  if (lane == 31) {
    tA[warp] = A;
    tB[warp] = B;
  }
  __syncthreads();

  // warp 0: the tile's aggregate published (by the last tile of a group,
  // the group's too), then the gain at the tile's start from the carried
  // gain, the groups before this tile's and the tiles of its group before
  // it, then each warp's start gain
  if (warp == 0) {
    const int grp = tile / kGroup, first = grp * kGroup;
    unsigned* gflags = flags + ntiles;
    float2* gvals = vals + ntiles;
    float aA = tA[0], aB = tB[0];
    if (lane == 0) {
      for (int w = 1; w < kWarps; ++w) {
        float wA = tA[w], wB = tB[w];
        compose(wA, wB, aA, aB);
        aA = wA;
        aB = wB;
      }
      if (tile < ntiles - 1) {
        __stcg(vals + tile, make_float2(aA, aB));
        st_release(flags + tile, want);
      }
    }
    // lane l's tiles of the group: first + 2 l and the one after it
    const int j0 = first + 2 * lane, j1 = j0 + 1;
    if (tile % kGroup == kGroup - 1 && tile < ntiles - 1) {
      // j1 of lane 31 is this tile
      wait_flags(want, flags + j0, lane < 31 ? flags + j1 : nullptr);
      const float2 m0 = __ldcg(vals + j0);
      const float oA = __shfl_sync(kFull, aA, 0), oB = __shfl_sync(kFull, aB, 0);
      float mA = oA, mB = oB;
      if (lane < 31) {
        const float2 m1 = __ldcg(vals + j1);
        mA = m1.x;
        mB = m1.y;
      }
      compose(mA, mB, m0.x, m0.y);
      reduce_maps(mA, mB, lane);
      if (lane == 0) {
        __stcg(gvals + grp, make_float2(mA, mB));
        st_release(gflags + grp, want);
      }
    }
    // and the groups [g0, g1) in order
    const int q = (grp + 31) / 32;
    const int g0 = min(lane * q, grp), g1 = min(g0 + q, grp);
    wait_flags(want, g1 > g0 ? gflags + g0 : nullptr,
               j0 < tile ? flags + j0 : nullptr,
               j1 < tile ? flags + j1 : nullptr);
    float gA = 1.f, gB = 0.f, jA = 1.f, jB = 0.f;
    for (int g = g0; g < g1; ++g) {
      if (g != g0) wait_flags(want, gflags + g);
      const float2 m = __ldcg(gvals + g);
      float mA = m.x, mB = m.y;
      compose(mA, mB, gA, gB);
      gA = mA;
      gB = mB;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = h ? j1 : j0;
      if (j < tile) {
        const float2 m = __ldcg(vals + j);
        float mA = m.x, mB = m.y;
        compose(mA, mB, jA, jB);
        jA = mA;
        jB = mB;
      }
    }
    reduce_maps(gA, gB, lane);
    reduce_maps(jA, jB, lane);
    if (lane == 0) {
      // the groups' maps on the carried gain, then the group's tiles'
      float g = fmaf(jA, fmaf(gA, *gain_in, gB), jB);
      for (int w = 0; w < kWarps; ++w) {
        gw[w] = g;
        g = fmaf(tA[w], g, tB[w]);
      }
    }
  }
  __syncthreads();

  // the true start gain of this thread's segment, and the rerun
  float g = fmaf(eA, gw[warp], eB);
  const bool clamp = max_gain > 0.f;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const int gi = base + i0 + j;
    if (gi < n) {
      const float ga = clamp ? fminf(g, max_gain) : g;
      re[j] = __fmul_rn(re[j], ga);
      im[j] = __fmul_rn(im[j], ga);
      g = fmaf(a[j], g, b);
      if (gi == n - 1) *gain_out = clamp ? fminf(g, max_gain) : g;
    }
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {  // own slots only
    xr[slot(i0 + j)] = re[j];
    if constexpr (kCplx) xi[slot(i0 + j)] = im[j];
  }
  __syncthreads();
  for (int i = t; i < kTile; i += kThreads) {
    const int g2 = base + i;
    if (g2 < n) {
      if constexpr (kCplx)
        reinterpret_cast<float2*>(y)[g2] =
            make_float2(xr[slot(i)], xi[slot(i)]);
      else
        y[g2] = xr[slot(i)];
    }
  }
}

template <int P>
int iir_launch_p(const float* x, float* y, int n, int cs, const float* tail_in,
                 float* tail_out, const float* ff, int nff, const float* fb,
                 const float* pows, const float* dist, const float* hist_in,
                 float* hist_out, int order, unsigned long long* ticket,
                 unsigned* flags, float* vals, int ntiles, cudaStream_t st) {
  iir_scan_kernel<P><<<ntiles * cs, kThreads, 0, st>>>(
      x, y, n, cs, tail_in, tail_out, ff, nff, fb, pows, dist, hist_in,
      hist_out, order, ticket, flags, vals, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// S4: the arguments of iir_scan_kernel; P the instance (1, 2, 3, 4 or 16);
// ticket, flags and vals the workspace's for this cs.
extern "C" int iir_scan_launch(const float* x, float* y, int n, int cs,
                               const float* tail_in, float* tail_out,
                               const float* ff, int nff, const float* fb,
                               const float* pows, const float* dist, int P,
                               int order, const float* hist_in,
                               float* hist_out, unsigned long long* ticket,
                               unsigned* flags, float* vals, int ntiles,
                               void* stream) {
  if (n <= 0 || (cs != 1 && cs != 2) || nff < 1 || nff > kMaxFf ||
      order < 0 || order > P || ntiles != (n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
    case 1:
      return iir_launch_p<1>(x, y, n, cs, tail_in, tail_out, ff, nff, fb, pows,
                             dist, hist_in, hist_out, order, ticket, flags,
                             vals, ntiles, st);
    case 2:
      return iir_launch_p<2>(x, y, n, cs, tail_in, tail_out, ff, nff, fb, pows,
                             dist, hist_in, hist_out, order, ticket, flags,
                             vals, ntiles, st);
    case 3:
      return iir_launch_p<3>(x, y, n, cs, tail_in, tail_out, ff, nff, fb, pows,
                             dist, hist_in, hist_out, order, ticket, flags,
                             vals, ntiles, st);
    case 4:
      return iir_launch_p<4>(x, y, n, cs, tail_in, tail_out, ff, nff, fb, pows,
                             dist, hist_in, hist_out, order, ticket, flags,
                             vals, ntiles, st);
    case kMaxP:
      return iir_launch_p<kMaxP>(x, y, n, cs, tail_in, tail_out, ff, nff, fb,
                                 pows, dist, hist_in, hist_out, order, ticket,
                                 flags, vals, ntiles, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// S5: the arguments of agc_scan_kernel; cplx 1 for a complex stream.
extern "C" int agc_scan_launch(const float* x, float* y, int n, int cplx,
                               const float* gain_in, float* gain_out,
                               const float* rate_p, const float* ref_p,
                               float rate_h, float ref_h, float max_gain,
                               unsigned long long* ticket, unsigned* flags,
                               float* vals, int ntiles, void* stream) {
  if (n <= 0 || ntiles != (n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float2* v2 = reinterpret_cast<float2*>(vals);
  if (cplx)
    agc_scan_kernel<true><<<ntiles, kThreads, 0, st>>>(
        x, y, n, gain_in, gain_out, rate_p, ref_p, rate_h, ref_h, max_gain,
        ticket, flags, v2, ntiles);
  else
    agc_scan_kernel<false><<<ntiles, kThreads, 0, st>>>(
        x, y, n, gain_in, gain_out, rate_p, ref_p, rate_h, ref_h, max_gain,
        ticket, flags, v2, ntiles);
  return (int)cudaGetLastError();
}
