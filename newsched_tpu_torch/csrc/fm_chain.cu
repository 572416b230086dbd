// The fused FM channelizer chain on planes rows, for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/fm_chain.py
// `fm_chain_step_planes` (`_kernel`, `_compute_tile`; K3 here), its
// pipelined variant (`_kernel_pipe`, `pipelined=True`; K3p here),
// `fm_chain_gen_step` (`_kernel_gen`; K5 here) and its stateless per-shard
// form `fm_chain_gen_warm_step` (`_kernel_gen_warm`; K6 here); their device
// function
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
// Stream start: rows t < t_min are before the stream (a launch argument,
// 0 for the carried forms; K6 derives it from its base group, which like
// K5's lives on the card): their acc is 0, Y[t_min-1] is prev0 and aud
// there comes from tail0. The sharded forms move it. K3 with warm > 0 (a
// time shard of the fused graph) gets a halo of warm + H8 real rows before
// its batch and t_min far in the past, so every block rebuilds its junction
// from the halo's rows, prev0/tail0 unread: the same values, by the same
// code, as the unsharded stream's, where the reference recomputes `warm`
// rows from a zero junction and drops them. K6 (a time shard of the live
// source) generates every row it reads, at any signed offset from its
// shard's base group, with groups before the stream reading 0, and puts
// t_min at the stream's first row when that lies within reach (shard 0 of
// the first batch), so it computes what K5 computes at the same rows.
//
// The kernels differ only in where a block's input rows come from. K3
// reads vb and halo from device memory. K5 (and K6) generate them: row t >= 0 of
// the batch is amp * gauss(seed, group g0, row t, lane) (philox.cuh, the
// stream of the noise kernel K4), and the halo comes from carry0, the
// previous batch's last H8 generated rows (zeros at stream start); K5
// returns this batch's last H8 rows as the next carry. Everything after
// the rows is one routine (chain_tile), so K5's outputs equal
// K4 -> K3's bit for bit. K3p reads what K3 reads and runs the same
// routine on it, tile after tile (see fm_chain_pipe_kernel), so its
// outputs equal K3's bit for bit.
//
// The TPU grid runs its tiles in order and carries Y[t-1] and the audio
// tail from tile to tile in VMEM. CUDA blocks run in no order, so each
// block recomputes its own junction instead: the block for output rows
// [t0, t0+T) folds input rows [t0-A-(L-1), t0+T), computes Y over
// [t0-A, t0+T) and aud over [t0-(A-1), t0+T). Only blocks that reach back
// before the batch (the first, and for T < A a few more) read prev0/tail0.
// Every value is computed by the same code with the same summation order
// whichever block computes it, so the outputs are bit-identical for every
// tile size T. K3p is the ordered form the TPU grid has, inside a block:
// a block walks G consecutive tiles, rebuilds the junction for its first
// only and carries it from tile to tile after that, and copies the next
// tile's window (cp.async) while the current one computes. At the
// flagship's batch and tile 64, G = 4 (128 blocks, one an SM at 121 KB of
// shared memory) cuts the rows folded and transformed from +150% to +38%
// over the batch's own (K3 at tile 128: +75%).
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

// The stages of a tile, each of which a variant of the ablation probe
// (newsched_tpu_torch/probes/ablate.py; the reference's
// bench/exp_ablate.py) switches off at compile time. The shipped kernels are
// the all-on instance, kFull: every `if constexpr` below is then the code
// they always ran.
enum Variant {
  kFull = 0,   // the chain
  kNoAtan2,    // demod: (PR + PI) * gain in place of atan2(PI, PR) * gain
  kNoDft,      // Y = acc, no DFT product
  kNoFold,     // acc = c2[0] * the window row: one tap in place of L
  kNoAudio,    // out[o] = aud[o * decim], no audio FIR
  kNoDemod,    // aud = Re Y * gain, no demod
  kDmaOnly,    // the window loaded, then out[o] = its row o * decim (re)
  kVariants
};

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
  int t_min;  // the stream's first row, relative to the batch
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

// The tile buffer's row jj holds stream row t0 - A + jj (jj < T + A): acc,
// then Y, then aud in the re half. Every value is computed by the same
// code whichever kernel, block or tile computes it.

// Arm fold of nrows rows, kChunkRows rows a pass (npad rows, a multiple of
// kChunkRows, >= nrows): dst row jj = sum_q c2[q] * src row jj + q, 0 where
// t_first + jj < t_min (before the stream) or jj >= nrows. In place when
// dst == src: every read of a pass (rows r0 .. r0+31+L-1) happens before
// its writes (rows r0 .. r0+31), and later passes read only rows past
// r0+31. Per lane: c2[0]*v, then fmaf in order (kOneTap: c2[0]*v alone,
// the ablation's kNoFold).
template <bool kOneTap = false>
__device__ __forceinline__ void fold_rows(const float* src, float* dst,
                                          const Chain& p, int t_min,
                                          int t_first, int nrows, int npad) {
  constexpr int W = kW;
  constexpr int kPer = kChunkRows * W / kThreads;  // 16 rows per thread
  const int tid = threadIdx.x;
  const int k = tid % W, h = tid / W;
  for (int r0 = 0; r0 < npad; r0 += kChunkRows) {
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int jj = r0 + h * kPer + e;
      v[e] = 0.f;
      if (jj < nrows && t_first + jj >= t_min) {
        float acc = __ldg(p.c2 + k) * src[jj * W + k];
        if constexpr (!kOneTap)
          for (int q = 1; q < p.L; ++q)
            acc = fmaf(__ldg(p.c2 + q * W + k), src[(jj + q) * W + k], acc);
        v[e] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[(r0 + h * kPer + e) * W + k] = v[e];
    __syncthreads();
  }
}

// One tile of T stream rows from t0, both kinds:
//   kRebuild (K3, K5, a K3p block's first tile): the tile rebuilds its
//     junction: its window of input rows, from `row(sr, k)` (stream row sr
//     of the batch, lane k; sr < 0 is the carried halo), is folded in
//     place into rows 0 .. T+A-1;
//   !kRebuild (a K3p block's later tiles): the junction comes from the
//     tile before, aud rows 1 .. A-1 in the buffer and Y[t0-1] in yprev;
//     the window is in `stage` (input rows t0-L+1 .. t0+T-1) and only rows
//     A .. A+T-1 are folded and transformed; after_fold() runs once the
//     stage has been read.
// `last`: the batch's last tile (prev_out, tail_out); ynext (or null)
// receives Y[t0+T-1]. kV: the stages switched off (Variant; kFull for
// every shipped kernel). t_min: the stream's first row (p.t_min, but for
// K6, which finds it from the base group it reads; passed on its own so
// that the kernels' Chain stays an unmodified launch parameter).
template <bool kRebuild, int kV, class Row, class AfterFold>
__device__ __forceinline__ void chain_tile(float* buf, const Chain& p,
                                           int t_min, int t0, bool last,
                                           const float* yprev, float* ynext,
                                           const float* stage, Row row,
                                           AfterFold after_fold) {
  constexpr int W = kW, M = kM;
  const int A = p.A, L = p.L;
  const int R = p.T + A;
  const int jlo = kRebuild ? 1 : A;  // the first row the tile demodulates
  const int r_lo = kRebuild ? 0 : A;  // the first row it transforms
  const int r_hi = kRebuild ? pad_rows(R) : R;
  const int tid = threadIdx.x;

  // 1. The window, folded: row jj gets acc of stream row t0 - A + jj.
  if constexpr (kRebuild) {
    for (int idx = tid; idx < (R + L - 1) * W; idx += kThreads) {
      const int ii = idx / W, k = idx % W;
      buf[idx] = row(t0 - A - (L - 1) + ii, k);
    }
    __syncthreads();
    if constexpr (kV == kDmaOnly) {
      // window row A + L - 1 + j is stream row t0 + j
      for (int idx = tid; idx < p.T / p.decim * M; idx += kThreads) {
        const int o = idx / M, m = idx % M;
        p.aud[((long long)t0 / p.decim + o) * M + m] =
            buf[(A + L - 1 + o * p.decim) * W + m];
      }
      return;
    }
    fold_rows<kV == kNoFold>(buf, buf, p, t_min, t0 - A, R, r_hi);
  } else {
    fold_rows(stage, buf + A * W, p, t_min, t0, p.T, p.T);
  }
  after_fold();

  // 2. Y = acc @ W2 in place, kChunkRows rows a pass; the carried row
  //    Y[-1] where the tile reaches it; Y[t0+T-1] out.
  const int tx = tid & 31, ty = tid >> 5;
  for (int r0 = r_lo; r0 < r_hi && kV != kNoDft; r0 += kChunkRows) {
    float o[4][4];
    tile_mm::pass(buf + r0 * W, p.w2, o);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(buf + (r0 + 4 * ty + i) * W + 4 * tx) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    __syncthreads();
  }
  if (kRebuild) {
    const int jp = t_min - 1 - (t0 - A);  // the row of Y[t_min - 1]
    if (jp >= 0 && jp < R)
      for (int k = tid; k < W; k += kThreads) buf[jp * W + k] = p.prev0[k];
  }
  if (last || ynext)
    for (int k = tid; k < W; k += kThreads) {
      const float y = buf[(R - 1) * W + k];
      if (last) p.prev_out[k] = y;
      if (ynext) ynext[k] = y;
    }
  __syncthreads();

  // 3. Demod in place, from the last row down: aud[jj] needs Y[jj-1] (for
  //    a carried junction's first row, yprev) and Y[jj], and is written
  //    into row jj's re half only after the chunk's reads, so lower chunks
  //    still find their Y rows intact. Rows before the stream take tail0.
  constexpr int kElems = 4;
  constexpr int kDemodRows = kElems * kThreads / M;
  for (int hi = R; hi > jlo;) {
    const int lo = hi - kDemodRows > jlo ? hi - kDemodRows : jlo;
    float val[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int idx = tid + e * kThreads;
      const int jj = lo + idx / M, m = idx % M;
      val[e] = 0.f;
      if (jj < hi) {
        const int t = t0 - A + jj;
        if (t < t_min) {
          val[e] = p.tail0[(A - 1 + t - t_min) * W + m];
        } else {
          const float* pa = !kRebuild && jj == jlo ? yprev : buf + (jj - 1) * W;
          const float* py = buf + jj * W;
          const float ar = pa[m], ai = pa[m + M], yr = py[m], yi = py[m + M];
          const float pr = ar * yr + ai * yi;
          const float pi = ar * yi - ai * yr;
          if constexpr (kV == kNoAtan2)
            val[e] = (pr + pi) * p.gain;
          else if constexpr (kV == kNoDemod)
            val[e] = yr * p.gain;
          else
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
    if constexpr (kV == kNoAudio)
      acc = col[0];
    else
      for (int k = 0; k < A; ++k)
        acc = fmaf(__ldg(p.ataps + k), col[-k * W], acc);
    p.aud[((long long)t0 / p.decim + o) * M + m] = acc;
  }
}

// The tile of a kernel that rebuilds every junction (K3, K5, K6); the
// last block writes the end state where the kernel returns one.
template <int kV = kFull, class Row>
__device__ __forceinline__ void rebuilt_tile(float* buf, const Chain& p,
                                             int t_min, Row row) {
  chain_tile<true, kV>(buf, p, t_min, blockIdx.x * p.T,
                   blockIdx.x == gridDim.x - 1 && p.prev_out != nullptr,
                   nullptr, nullptr, nullptr, row, [] {});
}

// K3's and K3p's input rows: read from memory, vp = [halo; vb], the halo
// the hrows rows before the batch (H8, or warm + H8 for a time shard).
struct HaloRows {
  const float* vb;
  const float* halo;
  int hrows;
  __device__ __forceinline__ float operator()(int sr, int k) const {
    const int i = sr + hrows;  // row of vp
    if (i < 0) return 0.f;
    return i < hrows ? __ldg(halo + i * kW + k)
                     : __ldg(vb + (long long)(i - hrows) * kW + k);
  }
};

// K3: input rows read from memory, vp = [halo; vb].
__global__ void __launch_bounds__(kThreads)
fm_chain_kernel(const float* __restrict__ vb, const float* __restrict__ halo,
                int hrows, Chain p) {
  extern __shared__ __align__(16) float buf[];
  rebuilt_tile(buf, p, p.t_min, HaloRows{vb, halo, hrows});
}

// The ablation probe: K3 with the stages of kV switched off; kFull is K3.
template <int kV>
__global__ void __launch_bounds__(kThreads)
fm_chain_ablate_kernel(const float* __restrict__ vb,
                       const float* __restrict__ halo, int hrows, Chain p) {
  extern __shared__ __align__(16) float buf[];
  rebuilt_tile<kV>(buf, p, p.t_min, HaloRows{vb, halo, hrows});
}

// K5: input rows generated in the block (and the batch's last H8 copied
// out as the next carry), the halo from carry0; the base group on the card.
__global__ void __launch_bounds__(kThreads)
fm_chain_gen_kernel(philox::Stream s, const long long* __restrict__ group,
                    const float* __restrict__ amp,
                    const float* __restrict__ carry0,
                    float* __restrict__ carry_out, Chain p) {
  extern __shared__ __align__(16) float buf[];
  s.g0 = philox::group_at(group, 0);
  const int H8 = p.H8, n = p.n;
  const float a = amp[0];
  rebuilt_tile(buf, p, p.t_min, [&](int sr, int k) {
    if (sr < 0) return sr >= -H8 ? carry0[(H8 + sr) * kW + k] : 0.f;
    const float v = __fmul_rn(philox::gauss(s, sr, k, kW), a);
    if (sr >= n - H8) carry_out[(sr - (n - H8)) * kW + k] = v;
    return v;
  });
}

// K6: K5 with nothing carried in or out: every row a block reads, before
// the batch too, generated from its signed offset to the base group (the
// stream masks groups before its start to 0). The shard's base is the
// batch's group counter on the card plus `goff` groups; the stream's first
// row relative to it (t_min) follows from that base here: where a block
// can reach it (shard 0 of the first batch) it is -64 * base, else far in
// the past (kFarPast, which no block reaches).
constexpr int kFarPast = -(1 << 30);

__global__ void __launch_bounds__(kThreads)
fm_chain_gen_warm_kernel(philox::Stream s, const long long* __restrict__ group,
                         long long goff, const float* __restrict__ amp,
                         const Chain p) {
  extern __shared__ __align__(16) float buf[];
  s.g0 = philox::group_at(group, goff);
  const long long g = (long long)s.g0;
  const int t_min = g <= 0 ? 0
                    : g >= (1LL << 24) ? kFarPast
                                       : (int)(-g * philox::kGroupRows);
  const float a = amp[0];
  rebuilt_tile(buf, p, t_min, [&](int sr, int k) {
    return __fmul_rn(philox::gauss(s, sr, k, kW), a);
  });
}

// K3p's overlap: a 16-byte copy from device to shared memory that runs
// while the block computes (cp.async), committed as one group.
__device__ __forceinline__ void prefetch_window(float* dst, const float* src,
                                             int nfloats) {
  for (int i = threadIdx.x * 4; i < nfloats; i += kThreads * 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_window() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K3p: block b walks tiles [b*G, b*G + G) of the batch in stream order.
// Its first tile is K3's (chain_tile, the junction rebuilt from the
// block's own window); every later tile carries the junction from the tile
// before: aud rows t0-A+1 .. t0-1 stay in the tile buffer (moved from rows
// T+1 .. T+A-1 to 1 .. A-1) and Y[t0-1] in a shared row, so the tile folds
// and transforms only its own T rows. Its window, the T+L-1 input rows
// t0-L+1 .. t0+T-1 of vb, was copied into the stage buffer while the tile
// before computed.
__global__ void __launch_bounds__(kThreads)
fm_chain_pipe_kernel(const float* __restrict__ vb,
                     const float* __restrict__ halo, int hrows, Chain p,
                     int G) {
  extern __shared__ __align__(16) float sm[];
  constexpr int W = kW, M = kM;
  const int T = p.T, A = p.A, L = p.L;
  const int NT = p.n / T;
  const int g0 = blockIdx.x * G;
  const int g1 = min(g0 + G, NT);
  const int tid = threadIdx.x;
  float* buf = sm;
  float* stage = buf + tile_rows(T, A, L) * W;
  float* yrows = stage + (T + L - 1) * W;  // Y[t0-1] and Y[t0+T-1], by turns
  const int win = (T + L - 1) * W;

  const HaloRows row{vb, halo, hrows};
  if (g0 + 1 < g1)
    prefetch_window(stage, vb + ((long long)(g0 + 1) * T - (L - 1)) * W, win);
  chain_tile<true, kFull>(buf, p, p.t_min, g0 * T, g0 == NT - 1, nullptr,
                          yrows, nullptr, row, [] {});
  for (int g = g0 + 1; g < g1; ++g) {
    __syncthreads();  // the tile before has read its aud rows
    for (int idx = tid; idx < (A - 1) * M; idx += kThreads) {
      const int i = idx / M, m = idx % M;
      buf[(1 + i) * W + m] = buf[(T + 1 + i) * W + m];
    }
    wait_window();
    __syncthreads();
    chain_tile<false, kFull>(buf, p, p.t_min, g * T, g == NT - 1,
                      yrows + ((g - g0 - 1) & 1) * W,  // Y[t0-1]
                      yrows + ((g - g0) & 1) * W, stage, row, [&] {
      if (g + 1 < g1)
        prefetch_window(stage, vb + ((long long)(g + 1) * T - (L - 1)) * W,
                        win);
    });
  }
}

Chain make_chain(const float* prev0, const float* tail0, const float* c2,
                 const float* w2, const float* ataps, float* aud,
                 float* prev_out, float* tail_out, int n, int L, int H8,
                 int A, int decim, int T, int t_min, float gain,
                 const float* atan_coeffs) {
  return Chain{c2,    w2,    ataps, prev0, tail0,
               aud,   prev_out, tail_out, n, L,
               H8,    A,     decim, T,     t_min,
               gain,  mathfns::load_atan(atan_coeffs)};
}

// The chain kernels' launch: the shared memory the tile buffer takes
// (above 48 KB only once the kernel is allowed it), then one block a tile.
template <class Kernel, class... Args>
int launch_tiles(Kernel kernel, size_t smem, int blocks, void* stream,
                 Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fm_chain_planes_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* w2, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, int hrows, int t_min, float gain,
    const float* atan_coeffs, void* stream) {
  // every block's window must lie in [halo; vb]
  if (2 * M != kW || hrows < H8 || (t_min < 0 && hrows < A + L - 1))
    return (int)cudaErrorInvalidValue;
  return launch_tiles(
      fm_chain_kernel, (size_t)tile_rows(T, A, L) * kW * sizeof(float), n / T,
      stream, vb, halo, hrows,
      make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, t_min, gain, atan_coeffs));
}

// The ablation probe's launch: K3's arguments (prev_out/tail_out may be
// null: the variant then writes the audio only) and the variant.
extern "C" int fm_chain_ablate_launch(
    int variant, const float* vb, const float* halo, const float* prev0,
    const float* tail0, const float* c2, const float* w2, const float* ataps,
    float* aud, float* prev_out, float* tail_out, int n, int M, int L, int H8,
    int A, int decim, int T, int hrows, int t_min, float gain,
    const float* atan_coeffs, void* stream) {
  if (2 * M != kW || hrows < H8 || (t_min < 0 && hrows < A + L - 1) ||
      variant < 0 || variant >= kVariants || (prev_out == nullptr) !=
      (tail_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows(T, A, L) * kW * sizeof(float);
  const Chain p = make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out,
                             tail_out, n, L, H8, A, decim, T, t_min, gain,
                             atan_coeffs);
  switch (variant) {
    case kFull:
      return launch_tiles(fm_chain_ablate_kernel<kFull>, smem, n / T, stream,
                          vb, halo, hrows, p);
    case kNoAtan2:
      return launch_tiles(fm_chain_ablate_kernel<kNoAtan2>, smem, n / T,
                          stream, vb, halo, hrows, p);
    case kNoDft:
      return launch_tiles(fm_chain_ablate_kernel<kNoDft>, smem, n / T, stream,
                          vb, halo, hrows, p);
    case kNoFold:
      return launch_tiles(fm_chain_ablate_kernel<kNoFold>, smem, n / T, stream,
                          vb, halo, hrows, p);
    case kNoAudio:
      return launch_tiles(fm_chain_ablate_kernel<kNoAudio>, smem, n / T,
                          stream, vb, halo, hrows, p);
    case kNoDemod:
      return launch_tiles(fm_chain_ablate_kernel<kNoDemod>, smem, n / T,
                          stream, vb, halo, hrows, p);
    default:
      return launch_tiles(fm_chain_ablate_kernel<kDmaOnly>, smem, n / T,
                          stream, vb, halo, hrows, p);
  }
}

extern "C" int fm_chain_gen_launch(
    const long long* group, uint32_t k0, uint32_t k1, int draws,
    float mean, float inv_std, const float* amp, const float* carry0,
    const float* prev0, const float* tail0, const float* c2, const float* w2,
    const float* ataps, float* aud, float* prev_out, float* tail_out,
    float* carry_out, int n, int M, int L, int H8, int A, int decim, int T,
    float gain, const float* atan_coeffs, void* stream) {
  if (2 * M != kW || (draws != 2 && draws != 3))
    return (int)cudaErrorInvalidValue;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, 0};
  return launch_tiles(
      fm_chain_gen_kernel, (size_t)tile_rows(T, A, L) * kW * sizeof(float),
      n / T, stream, s, group, amp, carry0, carry_out,
      make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, 0, gain, atan_coeffs));
}

extern "C" int fm_chain_gen_warm_launch(
    const long long* group, long long goff, uint32_t k0, uint32_t k1,
    int draws, float mean, float inv_std, const float* amp, const float* prev0,
    const float* tail0, const float* c2, const float* w2, const float* ataps,
    float* aud, int n, int M, int L, int H8, int A, int decim, int T,
    float gain, const float* atan_coeffs, void* stream) {
  if (2 * M != kW || (draws != 2 && draws != 3))
    return (int)cudaErrorInvalidValue;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, 1};
  return launch_tiles(
      fm_chain_gen_warm_kernel,
      (size_t)tile_rows(T, A, L) * kW * sizeof(float), n / T, stream, s,
      group, goff, amp,
      make_chain(prev0, tail0, c2, w2, ataps, aud, nullptr, nullptr, n, L, H8,
                 A, decim, T, 0, gain, atan_coeffs));
}

extern "C" int fm_chain_pipe_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* w2, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, int hrows, int t_min, int G, float gain,
    const float* atan_coeffs, void* stream) {
  // later tiles: whole DFT passes, a window inside vb, a tail below row A
  if (2 * M != kW || T % kChunkRows || T < A - 1 || T < L - 1 || n % T ||
      G < 1 || (uintptr_t)vb % 16 || hrows < H8 ||
      (t_min < 0 && hrows < A + L - 1))
    return (int)cudaErrorInvalidValue;
  return launch_tiles(
      fm_chain_pipe_kernel,
      ((size_t)tile_rows(T, A, L) + T + L - 1 + 2) * kW * sizeof(float),
      (n / T + G - 1) / G, stream, vb, halo, hrows,
      make_chain(prev0, tail0, c2, w2, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, t_min, gain, atan_coeffs),
      G);
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
