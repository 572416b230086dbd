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
//   Y[t]    = acc[t] @ W2                          the planes DFT (W2 is
//                                                  planes_dft_matrix)
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
// per-row arithmetic on it (fold_rows' sums, fft_row, demod, the audio
// FIR's order) in roles of its own, tile after tile (see
// fm_chain_pipe_kernel), so its outputs equal K3's bit for bit.
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
// only and carries it from tile to tile after that, in a warp-specialised
// pipeline (its header below). At the flagship's batch and tile 64, G = 4
// (128 blocks, one an SM at 180 KB of shared memory) cuts the rows folded
// and transformed from +150% to +38% over the batch's own (K3 at tile
// 128: +75%).
//
// Bound on the H100. The function's least work is the fold (2 L flops a
// lane), an M-point FFT a row (~5 M log2 M = 1,920 flops at M = 64), the
// demod and the audio FIR; under it K3's least time is its bytes and K5's
// its Philox (chip_smoke.py kernel_bounds). The TPU formulation takes the
// DFT as a dense (2M x 2M) product on its MXU, 32 KFLOP a row, 17x the
// FFT; here each row is an FFT in shared memory (stage 2 below),
// so the chain's arithmetic is the function's, plus the junction
// recompute (A rows a tile: +51% at T=128). As on the TPU, Y and aud
// never leave the chip: the block keeps its (T+A, 2M) tile in shared
// memory (112 KB at T=128, two blocks an SM), turns Y into aud in place,
// and writes only the T/decim audio rows. The block first loads (K3, with
// 16-byte loads where vb and the halo allow) or generates (K5) its window
// of T+A+L-1 input rows into that same buffer, once, and folds it in
// place, 32 rows a pass: a thread keeps its lane's L taps in registers and
// slides its 16 rows' window through registers, so a pass reads 16+L-1
// values a thread from shared memory, not 16 L (stage 1). The window fits
// in the padded tile at T = 64, 128 and 256 (at most L-1 more rows
// elsewhere).
//
// K5 and K6 generate their window (GenRows): at T = 128 a block's window
// is 1.625 of its own rows, and generating it one element a thread took
// K5 its window's 0.0347 ms plus K3's chain's 0.0313, with no overlap
// between the two, where K4 makes a batch's rows in 0.0151 (PERF.md §6,
// on an NVIDIA H100 80GB HBM3 at 700 W; Philox's integer work bounds the
// window, ~0.0142 ms a batch at Hopper's INT32 rate). So a thread
// makes four lanes of a row at a time from hoisted round keys, with one
// 16-byte store (gen_rows), and at 128 lanes each block generates only its
// own rows and takes its junction from the blocks before it through
// device memory (gen_window_handoff): (n + A + L - 1) / n rows a row, and
// K5 0.0551 ms, the window alone 0.0253 (each block its whole window with
// the same generator: 0.0585 and 0.0270; the same card). Thread-block
// clusters passing the junction through distributed shared memory were
// tried (PERF.md §6): clusters of 4 or 8 tiles of 112 KB do not all
// fit on the card at once (62 and 30 clusters, for 64 and 32), and of 2
// gained 3%.

// Stage 2, the planes DFT as an FFT (planes_fft.cuh, shared with K1 in
// channelizer.cu). W2 maps [ar | ai] to Y with Y[j] = e^{-2 pi i j/M}
// sum_k a[k] e^{-2 pi i jk/M}: at M = 64 a 64-point FFT of 8 x 8 by 8
// threads a row, 4 rows a warp (~2,000 flops a row in place of 32 KFLOP);
// at M = 128, 192 and 256 a radix-2, 3 or 4 step and two to four of those
// 64-point FFTs. The twiddles are the host's (ops/cuda/planes_fft.py
// planes_fft_table, K3's `tw` argument) and every operation is rounded on
// its own, so a row's Y never depends on the block, tile or kernel that
// transforms it; tests/test_torch_fft.py repeats it in torch float32. The
// tile buffer keeps acc and Y rows swizzled (planes_fft.cuh sw); the
// window before the fold and the aud rows after the demod stay natural.
//
// The width 2M: 128 lanes (M = 64) take chain_tile as above, its kernels
// templated on the audio stage's bands; 256 to 2048 (M = 128 .. 1024, 64 P
// for P = 2 .. 16) take chain_tile_wide, which streams a block's rows
// through a pass of 16 and takes its junction from the block before (its
// header below), one instance a P up to 7 and one for P = 8 .. 16, the
// width a run-time value (Chain::w). K3p and the ablation probe are built
// at 128 lanes only. Wider than 1024 channels no kernel is built (the
// wrappers raise; ROADMAP.md Queue 3, R1).
//
// K3ag, the reference's banded audio stage (`_compute_tile` with `ag` > 1,
// taken by K3, K5 and K6 when `_pick_audio_groups` returns 2 or 4), is
// chain_tile's stage 4 at kAG > 1: the tile's audio FIR as kAG bands of
// T/kAG rows, each reading only its rows of [tail; aud] against one shared
// band table, the shifted Toeplitz of T/kAG/decim x (T/kAG + A-1) taps,
// built once per block in the tile buffer's spare rows. The TPU took the
// band's product on the MXU, structural zeros and all, to cut the
// product's size; its outputs were ulp-equal to ag = 1. Here each output
// sums only the A taps of its table row that are not structural zeros, in
// kAG = 1's order, so its outputs are kAG = 1's bit for bit. The audio
// stage is 13% of K3 (the ablation probe, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mathfns.cuh"
#include "philox.cuh"
#include "planes_fft.cuh"

namespace {

using mathfns::AtanCoeffs;
using mathfns::atan2_poly;
using planes_fft::sw;

constexpr int kThreads = 256;
constexpr int kChunkRows = 32;  // rows a fold pass (16 a group of lanes)
constexpr int kFoldL = 16;      // the fold's taps with a register window
constexpr int kFlagW = 128;     // planes lanes of the flagship, M = 64

// The stages of a tile, each of which a variant of the ablation probe
// (newsched_tpu_torch/probes/ablate.py; the reference's
// bench/exp_ablate.py) switches off at compile time. The shipped kernels are
// the all-on instance, kFull: every `if constexpr` below is then the code
// they always ran.
enum Variant {
  kFull = 0,   // the chain
  kNoAtan2,    // demod: (PR + PI) * gain in place of atan2(PI, PR) * gain
  kNoDft,      // Y = acc, no DFT
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
  const float* tw;     // (4, M) the FFT's twiddles (planes_fft_table)
  const float* ataps;  // (A,) audio taps
  const float* prev0;  // (1, W)
  const float* tail0;  // (A-1, W)
  float* aud;          // (n/decim, M)
  float* prev_out;     // (1, W)
  float* tail_out;     // (A-1, W)
  int n, L, H8, A, decim, T;
  int t_min;  // the stream's first row, relative to the batch
  int ag;     // the audio stage's bands, where the kernel reads them here
  int w;      // the planes width 2M (what chain_tile_wide reads)
  float gain;
  AtanCoeffs co;
};

// K2 alone: atan2_poly over whole tensors (mathfns.cuh; the same device
// function the chains call). Bound by its bytes: 12 a element against ~28
// flops, so the launch is shaped for the memory system. kVec: thread i
// takes the 4 elements [4i, 4i + 4) with one 16-byte load of y and one of
// x, both issued before any arithmetic, and one 16-byte store of the four
// angles; the grid covers the n/4 words in one pass, and its first threads
// take the < 4 elements past them one by one (the launch takes kVec only
// where y, x and out are 16-byte aligned). !kVec: one element a thread,
// for pointers off the 16-byte grid.
template <bool kVec>
__global__ void __launch_bounds__(256)
atan2_kernel(const float* __restrict__ y, const float* __restrict__ x,
             float* __restrict__ out, long long n, AtanCoeffs co) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    if (i < n4) {
      const float4 yv = __ldg(reinterpret_cast<const float4*>(y) + i);
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + i);
      reinterpret_cast<float4*>(out)[i] = make_float4(
          atan2_poly(yv.x, xv.x, co), atan2_poly(yv.y, xv.y, co),
          atan2_poly(yv.z, xv.z, co), atan2_poly(yv.w, xv.w, co));
    }
    const long long e = 4 * n4 + i;  // the tail
    if (e < n) out[e] = atan2_poly(y[e], x[e], co);
  } else {
    if (i < n) out[i] = atan2_poly(y[i], x[i], co);
  }
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
// code whichever kernel, block or tile computes it. acc and Y rows are
// swizzled: logical lane k of buffer row r at sw(r, k) (planes_fft.cuh);
// the input window and the aud rows are natural.

// Arm fold of nrows rows, kChunkRows rows a pass (npad rows, a multiple of
// kChunkRows, >= nrows): buffer row row0 + jj = sum_q c2[q] * src row jj +
// q, 0 where t_first + jj < t_min (before the stream) or jj >= nrows. In
// place when src == buf and row0 == 0: every read of a pass (rows r0 ..
// r0+31+L-1) happens before its writes (rows r0 .. r0+31), and later
// passes read only rows past r0+31. A pass is 2 W groups of a lane and 16
// rows, kG = W / 128 a thread (one at the flagship's 128 lanes). Per lane:
// c2[0]*v, then fmaf in order (kOneTap: c2[0]*v alone, the ablation's
// kNoFold). kL = kFoldL: a group's L taps in registers, loaded once, and
// its 16 rows' window of 16+L-1 values slid through registers; kL = 0: any
// L, each tap and value read per output. Both sum the same chain.
template <int kW, bool kOneTap, int kL>
__device__ __forceinline__ void fold_rows(const float* src, float* buf,
                                          int row0, const Chain& p,
                                          int t_min, int t_first, int nrows,
                                          int npad) {
  constexpr int W = kW;
  constexpr int kPer = 16;                                // rows a group
  constexpr int kG = kChunkRows * W / (kPer * kThreads);  // groups a thread
  static_assert(kG * kPer * kThreads == kChunkRows * W, "whole groups");
  const int tid = threadIdx.x;
  float c[kG][kL > 0 ? kL : 1];
  if constexpr (kL > 0) {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi)
#pragma unroll
      for (int q = 0; q < kL; ++q)
        c[gi][q] = __ldg(p.c2 + q * W + (tid + gi * kThreads) % W);
  }
  for (int r0 = 0; r0 < npad; r0 += kChunkRows) {
    float o[kG][kPer];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int g = tid + gi * kThreads;
      const int k = g % W, j0 = r0 + g / W * kPer;
      if constexpr (kL > 0) {
        float v[kPer + kL - 1];
#pragma unroll
        for (int i = 0; i < kPer + kL - 1; ++i)
          v[i] = j0 + i < nrows + kL - 1 ? src[(j0 + i) * W + k] : 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          float acc = 0.f;
          if (j0 + e < nrows && t_first + j0 + e >= t_min) {
            acc = c[gi][0] * v[e];
            if constexpr (!kOneTap) {
#pragma unroll
              for (int q = 1; q < kL; ++q) acc = fmaf(c[gi][q], v[e + q], acc);
            }
          }
          o[gi][e] = acc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int jj = j0 + e;
          o[gi][e] = 0.f;
          if (jj < nrows && t_first + jj >= t_min) {
            float acc = __ldg(p.c2 + k) * src[jj * W + k];
            if constexpr (!kOneTap)
              for (int q = 1; q < p.L; ++q)
                acc = fmaf(__ldg(p.c2 + q * W + k), src[(jj + q) * W + k], acc);
            o[gi][e] = acc;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int g = tid + gi * kThreads;
      const int k = g % W, j0 = r0 + g / W * kPer;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int r = row0 + j0 + e;
        buf[r * W + sw(r, k)] = o[gi][e];
      }
    }
    __syncthreads();
  }
}

// K3's and K3p's input rows: read from memory, vp = [halo; vb], the halo
// the hrows rows before the batch (H8, or warm + H8 for a time shard).
// vec: vb and halo 16-byte aligned, so the window loads 16 bytes at once.
// kW = 0: the width w at run time.
template <int kW>
struct HaloRows {
  const float* vb;
  const float* halo;
  int hrows;
  bool vec;
  int w;
  __device__ __forceinline__ float operator()(int sr, int k) const {
    const int W = kW ? kW : w;
    const int i = sr + hrows;  // row of vp
    if (i < 0) return 0.f;
    return i < hrows ? __ldg(halo + i * W + k)
                     : __ldg(vb + (long long)(i - hrows) * W + k);
  }
  __device__ __forceinline__ float4 load4(int sr, int k) const {
    const int W = kW ? kW : w;
    const int i = sr + hrows;
    if (i < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = i < hrows ? halo + i * W + k
                                 : vb + (long long)(i - hrows) * W + k;
    return __ldg(reinterpret_cast<const float4*>(src));
  }
};

template <int kW>
__device__ __forceinline__ HaloRows<kW> halo_rows(const float* vb,
                                                  const float* halo,
                                                  int hrows, int w = kW) {
  return HaloRows<kW>{vb, halo, hrows,
                      (((uintptr_t)vb | (uintptr_t)halo) & 15) == 0, w};
}

// K5's and K6's input rows, made in the block: row sr of the launch (rows
// counted from the first block's first row, of either sign) is amp *
// gauss(s, sr, lane) (philox.cuh; s.g0 the group of row 0), K4's stream
// bit for bit. K5 reads the carried halo in place of rows sr < 0 (carry0,
// H8 rows, zeros before them) and writes rows sr >= n - H8 out as the next
// batch's (carry_out); K6 has neither (carry0 null) and generates every
// row it reads, the stream's groups before its start reading 0
// (s.mask_pre). A time shard d of K6 is the same stream shifted by d n
// rows (n a multiple of 64), so one base serves every shard. hand/flags:
// the junction handoff between the tiles of a launch (gen_window_handoff;
// null: each block generates its whole window). gen4 is four consecutive
// lanes of one row from the round keys hoisted out of the loop (gen_rows,
// chain_tile_wide's fill_ring), the row's group and its masked test once
// for the four, and their four Philox chains independent, so they are in
// flight together. It computes gauss()'s counter, rounds and transform:
// the same bits.
template <int kW>
struct GenRows {
  philox::Stream s;
  float a;
  const float* carry0;
  float* carry_out;
  int H8, n, w;
  float* hand;
  unsigned* flags;

  __device__ __forceinline__ float4 gen4(int sr, int k,
                                         const philox::Keys& keys) const {
    const int W = kW ? kW : w;
    float v[4];
    if (carry0 && sr < 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = sr >= -H8 ? carry0[(H8 + sr) * W + k + j] : 0.f;
      return make_float4(v[0], v[1], v[2], v[3]);
    }
    const int q = sr >> 6;  // floor(sr / 64), either sign
    const uint64_t g = s.g0 + (uint64_t)(long long)q;
    if (s.mask_pre && (long long)g < 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = 0.f;
    } else {
      const uint32_t c0 = (uint32_t)((sr & 63) * W + k);  // (sr - 64 q) W + k
      uint32_t c[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j][0] = c0 + j;
        c[j][1] = (uint32_t)g;
        c[j][2] = (uint32_t)(g >> 32);
        c[j][3] = 0u;
        philox::philox4x32_10(c[j], keys);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t sum = 0;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          if (d < s.draws) sum += (c[j][d] & 0xFFFFu) + (c[j][d] >> 16);
        v[j] = __fmul_rn(__fsub_rn((float)sum, s.mean), s.inv_std);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __fmul_rn(v[j], a);
      if (carry_out && sr >= n - H8) carry_out[(sr - (n - H8)) * W + k + j] = v[j];
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Rows sr0 .. sr0 + n - 1 of a generating row source into dst (natural,
// kW floats a row), and into `also` (device memory) where given: four
// lanes a thread at a time, one 16-byte store each.
template <int kW>
__device__ __forceinline__ void gen_rows(float* dst, int sr0, int n,
                                         const GenRows<kW>& row,
                                         float* also = nullptr) {
  constexpr int W4 = kW / 4;
  const philox::Keys keys = philox::round_keys(row.s.k0, row.s.k1);
#pragma unroll 2
  for (int idx = threadIdx.x; idx < n * W4; idx += kThreads) {
    const float4 v = row.gen4(sr0 + idx / W4, 4 * (idx % W4), keys);
    reinterpret_cast<float4*>(dst)[idx] = v;
    if (also) reinterpret_cast<float4*>(also)[idx] = v;
  }
}

// A tile's window of n input rows from stream row sr0 into buf (natural,
// kW floats a row): 16-byte loads where the rows come from memory on the
// 16-byte grid, generated four lanes a thread (gen_rows) where the block
// makes them, else one float at a time.
template <int kW, class Row>
__device__ __forceinline__ void load_window(float* buf, int sr0, int n,
                                            const Row& row) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<Row, GenRows<kW>>) {
    gen_rows<kW>(buf, sr0, n, row);
  } else if (row.vec) {
    constexpr int W4 = kW / 4;
    for (int idx = tid; idx < n * W4; idx += kThreads)
      reinterpret_cast<float4*>(buf)[idx] =
          row.load4(sr0 + idx / W4, 4 * (idx % W4));
  } else {
    for (int idx = tid; idx < n * kW; idx += kThreads)
      buf[idx] = row(sr0 + idx / kW, idx % kW);
  }
}

// The junction handoff of a generating launch at the flagship's 128
// lanes. A tile's window is its junction, the J = A + L - 1 rows before
// it, then its own T rows; the junction rows are the tiles before's own
// rows, so generating every window whole makes (T + J) / T rows a row
// (1.625 at T = 128). Here each block generates only its own rows, and
// the rows the tiles after it read, the last H = min(T, J) of them, first:
// into its window and into its slot of `hand` (device memory, H rows a
// tile), then it publishes them (flags[1 + b] = 1, after a fence) and
// generates the rest. Then it waits for the flags of the ceil(J / T)
// tiles before it (one at T >= J, two at tile 64) and copies its junction
// from their slots (from L2; rows before the launch's first row it
// generates, as every window did). `hand` and `flags` belong to the one
// launch: the wrapper allocates them for it on its stream, and the
// launcher zeroes the flags before it (handoff_reset), so launches on
// other streams or threads share nothing. A block's tile b is the ticket
// it takes first (take_tile, flags[0]), not its blockIdx, so every tile
// it waits for belongs to a block that has started and so is resident or
// done, in whatever order the card starts them; a wait that passes ~0.5
// s traps, so a fault ends the launch with an error, not a hang. Every
// row holds the bits its block would have generated itself (the stream is
// position-pure), so the outputs do not depend on the handoff. The rows
// generated fall to (n + J) / n a launch.
__device__ __forceinline__ int take_tile(unsigned* flags, float* buf) {
  if (threadIdx.x == 0)
    reinterpret_cast<int*>(buf)[0] = (int)atomicAdd(flags, 1u);
  __syncthreads();
  const int b = reinterpret_cast<const int*>(buf)[0];
  __syncthreads();
  return b;
}

template <class Row>
__device__ __forceinline__ void gen_window_handoff(float* buf, int t0, int J,
                                                   int T, const Row& row) {
  constexpr int W = kFlagW, W4 = W / 4;
  const int b = t0 / T, tid = threadIdx.x, H = min(T, J);
  // 1. the rows the next tiles read, into the window and the tile's slot
  gen_rows<W>(buf + (J + T - H) * W, t0 + T - H, H, row,
              row.hand + (size_t)b * H * W);
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicExch(row.flags + 1 + b, 1u);
  // 2. the rest of the block's own rows
  gen_rows<W>(buf + J * W, t0, T - H, row);
  // 3. the junction: rows before the launch generated, the rest copied
  const int s_lo = t0 - J;
  if (s_lo < 0) gen_rows<W>(buf, s_lo, min(-s_lo, J), row);
  const int o_lo = s_lo > 0 ? s_lo / T : 0;
  if (tid == 0) {
    for (int o = o_lo; o < b; ++o)
      for (long long i = 0; *(volatile unsigned*)(row.flags + 1 + o) == 0u;
           ++i) {
        if (i > (1LL << 22)) __trap();
        __nanosleep(128);
      }
    __threadfence();
  }
  __syncthreads();
  const int first = s_lo > 0 ? s_lo : 0;  // the first row copied
  for (int idx = tid; idx < (t0 - first) * W4; idx += kThreads) {
    const int sr = first + idx / W4, o = sr / T;
    const float* src = row.hand + ((size_t)o * H + (sr - (o * T + T - H))) * W;
    reinterpret_cast<float4*>(buf + (sr - s_lo) * W)[idx % W4] =
        __ldcg(reinterpret_cast<const float4*>(src) + idx % W4);
  }
}

// The demod of one output: atan2 of conj(Y[t-1]) * Y[t], times the gain
// (the ablation's variants: kNoAtan2 (PR + PI) * gain, kNoDemod Re Y *
// gain). PR and PI are each one fused multiply-add, the rest rounded on
// its own: the roundings nvcc chose in every chain kernel before they were
// written out (left to the compiler, the contraction can differ between
// tile routines, and one routine would not keep another's bits).
template <int kV>
__device__ __forceinline__ float demod(float ar, float ai, float yr, float yi,
                                       const Chain& p) {
  const float pr = __fmaf_rn(ar, yr, __fmul_rn(ai, yi));
  const float pi = __fmaf_rn(ar, yi, -__fmul_rn(ai, yr));
  if constexpr (kV == kNoAtan2)
    return (pr + pi) * p.gain;
  else if constexpr (kV == kNoDemod)
    return yr * p.gain;
  else
    return __fmul_rn(atan2_poly(pi, pr, p.co), p.gain);
}

// Stage 4, the decimating audio FIR of a tile: out[o] = sum_k ataps[k] *
// aud[o*decim - k], aud row jj (stream row t0 - A + jj) at aud + jj * ld,
// M lanes, in kAG bands. With more than one (K3ag),
// band g of Tg = T/ag rows holds outputs g*n_og .. g*n_og + n_og - 1 and
// reads only [tail; aud] rows g*Tg .. g*Tg + Tg + A-2 (aud rows 1 + g*Tg +
// s) against the band table H[o][s] = ataps[A-1 + o*decim - s], zero
// outside [0, A), built in `tab` (free shared memory). The threads of band
// g are the g-th kThreads/ag of the block. Row o of H is summed over its A
// nonzero taps only, k = 0 .. A-1 as with one band, on the same aud
// values: one band's outputs bit for bit.
template <int M, int kV, int kAG>
__device__ __forceinline__ void audio_fir(const float* aud, int ld,
                                          float* tab, const Chain& p,
                                          int t0) {
  const int tid = threadIdx.x, A = p.A;
  const int n_o = p.T / p.decim;
  constexpr int ag = kAG;
  if constexpr (ag == 1) {
    for (int idx = tid; idx < n_o * M; idx += kThreads) {
      const int o = idx / M, m = idx % M;
      const float* col = aud + (A + o * p.decim) * ld + m;
      float acc = 0.f;
      if constexpr (kV == kNoAudio)
        acc = col[0];
      else
        for (int k = 0; k < A; ++k)
          acc = fmaf(__ldg(p.ataps + k), col[-k * ld], acc);
      p.aud[((long long)t0 / p.decim + o) * M + m] = acc;
    }
  } else {
    static_assert(kThreads % ag == 0, "whole bands");
    const int Tg = p.T / ag, n_og = Tg / p.decim, S = Tg + A - 1;
    for (int idx = tid; idx < n_og * S; idx += kThreads) {
      const int o = idx / S, s = idx % S, k = A - 1 + o * p.decim - s;
      tab[idx] = k >= 0 && k < A ? __ldg(p.ataps + k) : 0.f;
    }
    __syncthreads();
    const int band_threads = kThreads / ag;
    const int g = tid / band_threads;
    const float* band = aud + (1 + g * Tg) * ld;
    for (int idx = tid % band_threads; idx < n_og * M; idx += band_threads) {
      const int o = idx / M, m = idx % M;
      const int s0 = A - 1 + o * p.decim;  // column of H[o] at k = 0
      const float* h = tab + o * S + s0;
      const float* col = band + s0 * ld + m;
      float acc = 0.f;
      for (int k = 0; k < A; ++k) acc = fmaf(h[-k], col[-k * ld], acc);
      p.aud[((long long)t0 / p.decim + g * n_og + o) * M + m] = acc;
    }
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
// every shipped kernel). kAG: the audio stage's bands (1, or K3ag's 2 or
// 4; see stage 4). t_min: the stream's first row (p.t_min, but for
// K6, which finds it from the base group it reads; passed on its own so
// that the kernels' Chain stays an unmodified launch parameter).
template <bool kRebuild, int kV, int kAG, class Row, class AfterFold>
__device__ __forceinline__ void chain_tile(float* buf, const Chain& p,
                                           int t_min, int t0, bool last,
                                           const float* yprev, float* ynext,
                                           const float* stage, Row row,
                                           AfterFold after_fold) {
  constexpr int W = kFlagW, M = W / 2;
  const int A = p.A, L = p.L;
  const int R = p.T + A;
  const int jlo = kRebuild ? 1 : A;  // the first row the tile demodulates
  const int r_lo = kRebuild ? 0 : A;  // the first row it transforms
  const int tid = threadIdx.x;

  // 1. The window, folded: row jj gets acc of stream row t0 - A + jj.
  if constexpr (kRebuild) {
    // the window's first stream row is t0 - A - (L - 1)
    if constexpr (std::is_same_v<Row, GenRows<W>>) {
      if (row.hand)
        gen_window_handoff(buf, t0, A + L - 1, p.T, row);
      else
        load_window<W>(buf, t0 - A - (L - 1), R + L - 1, row);
    } else {
      load_window<W>(buf, t0 - A - (L - 1), R + L - 1, row);
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
    if (L == kFoldL)
      fold_rows<W, kV == kNoFold, kFoldL>(buf, buf, 0, p, t_min, t0 - A, R,
                                          pad_rows(R));
    else
      fold_rows<W, kV == kNoFold, 0>(buf, buf, 0, p, t_min, t0 - A, R,
                                     pad_rows(R));
  } else {
    if (L == kFoldL)
      fold_rows<W, false, kFoldL>(stage, buf, A, p, t_min, t0, p.T, p.T);
    else
      fold_rows<W, false, 0>(stage, buf, A, p, t_min, t0, p.T, p.T);
  }
  after_fold();

  // 2. Y = the planes DFT of acc, in place: rows r_lo .. R-1, each a
  //    64-point FFT by 8 threads (fft_row), 4 rows a warp, a warp's rows
  //    32 apart from pass to pass, no block barrier between passes. Then
  //    the carried row Y[-1] where the tile reaches it; Y[t0+T-1] out.
  if constexpr (kV != kNoDft) {
    const planes_fft::Tw<1> tw(p.tw, tid & 7);
    for (int base = r_lo + 4 * (tid >> 5); base < R; base += kChunkRows) {
      const int r = base + ((tid >> 3) & 3);
      planes_fft::fft_row<1>(buf + r * W, r, tid & 7, tw, p.tw);
    }
    __syncthreads();
  }
  if (kRebuild) {
    const int jp = t_min - 1 - (t0 - A);  // the row of Y[t_min - 1]
    if (jp >= 0 && jp < R)
      for (int k = tid; k < W; k += kThreads) buf[jp * W + sw(jp, k)] = p.prev0[k];
  }
  if (last || ynext)
    for (int k = tid; k < W; k += kThreads) {
      const float y = buf[(R - 1) * W + sw(R - 1, k)];
      if (last) p.prev_out[k] = y;
      if (ynext) ynext[k] = y;
    }
  __syncthreads();

  // 3. Demod in place, from the last row down: aud[jj] needs Y[jj-1] (for
  //    a carried junction's first row, yprev, natural) and Y[jj], and is
  //    written into row jj's re half (natural) only after the chunk's
  //    reads, so lower chunks still find their Y rows intact. Rows before
  //    the stream take tail0.
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
          const bool carried = !kRebuild && jj == jlo;
          const float* pa = carried ? yprev : buf + (jj - 1) * W;
          const int ma = carried ? m : sw(jj - 1, m), my = sw(jj, m);
          const float* py = buf + jj * W;
          val[e] = demod<kV>(pa[ma], pa[ma + M], py[my], py[my + M], p);
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

  // 4. Decimating audio FIR, from the aud rows in the re halves; K3ag's
  //    band table in rows R.. of the buffer (free since the demod).
  audio_fir<M, kV, kAG>(buf, W, buf + R * W, p, t0);
}

// ---- M = 128 .. 1024: chain_tile_wide, the junction handed over ----------
//
// Past the flagship's 128 lanes the tile buffer of chain_tile does not fit
// (its (T + A + L-1) rows of 2M floats take 245,760 bytes at M = 192 and T =
// 64), so a block streams its rows through a pass of kR rows (wide_rows:
// 64 at P = 2, 32 to P = 7, 16 past it), from its top pass down, and keeps
// in shared memory the pass (the folded rows, swizzled; the planes FFT in
// place), Y of the pass above's first row (yp), its audio outputs'
// accumulators, the A audio taps and, up to P = 4, the ring of its input
// rows: 205,060 bytes at M = 1024 and the default tile of 128 rows.
//
// The junction is handed over, not rebuilt. A launch's blocks take
// segments of the stream from a ticket (take_tile): ticket 0 the junction,
// the A rows before the launch's first (what every block of the rebuilding
// design folded in front of its tile, here once a launch), ticket 1 + o
// tile o, its T rows. A block computes its own rows only: it folds, turns
// into Y and demodulates each of them once. What the block after it needs
// it publishes in its slot of device memory, in two levels, each raised on
// the slot's flag after a fence: after its top pass Y of its last row and
// (K5, K6) its last L-1 input rows (level 1); once its last A-1 aud rows
// (all of them, short of A-1) are done, those (level 2; at T = 128 after 5
// of its 8 passes at 16 rows a pass). The block after it waits for level 1
// before its lowest pass (Y[t0-1] for its first row's demod, the input
// rows for its fold), and for level 2 of the segments holding rows
// t0-(A-1) .. t0-1 (one at T >= A-1) only after its own rows, where it
// feeds those A-1 aud rows to the audio outputs that reach them: their
// taps come last in each output's sum (out[o] sums k = 0 .. A-1 from the
// highest row down), so every output is the rebuilding design's sum bit
// for bit. A block waits only for tickets before its own, which belong to
// blocks that have started and so are resident or done, in whatever order
// the card starts them, and no level waits on a later wait of its own
// block, so no wait chains through the launch, at any tile; a wait past
// ~0.5 s traps. The slots, flags and rings belong to the one launch: the
// wrapper allocates them for it on its stream and the launcher zeroes the
// flags before it (handoff_reset).
//
// The fold reads each input row once from memory. Up to P = 4 the block
// keeps a ring of a pass's rows + L-1 in shared memory (ring_on_chip): K3
// loads each pass's new rows into it 16 bytes at a time, K5 and K6 make
// them there four lanes a thread (GenRows.gen4), and each fold group of 16
// rows reads its 16 + L-1 rows from it. Past P = 4 the ring does not fit
// beside the pass: K3's fold reads its 16 + L-1 rows a group from [halo;
// vb] (the L-1 again from L2), and K5 and K6 make their rows once into a
// ring in device memory and fold from there. The rows below a tile come
// from the slot before (K5, K6), the junction block's from carry0 (K5) or
// the stream (K6). So a launch makes its own rows and A + L-1 more, where
// every rebuilding block made (T + A) (16 + L-1) / 16 for its T.
//
// The pass: 1. the fold, each lane's 16-row group's inputs and taps in
// registers (tile row e = stream row s0 + e, acc 0 before t_min); 2. the
// planes FFT (fft_row<P> at P <= 4, fft_tile_wide<P> at P = 5 .. 7,
// fft_tile_rt at P = 8 .. 16, P at run time); 3. each thread takes the
// positions pos of the row (channel chan(pos), whose Y the FFT left there),
// so a warp reads 32 consecutive lanes, and walks the pass's rows from its
// highest down, 16 at a time: the demod of aud[t] from Y[t-1] and Y[t] (the
// top row's Y[t] the pass above's row 0, kept in yp by position; the lowest
// row's Y[t-1] the segment before's) into registers, then each audio output
// within their taps adds them to its accumulator (by position, in shared
// memory; audio_rows). At P = 2 four groups of M threads demodulate four
// 16-row chunks at once and add them one group after the other. No thread
// reads another's positions after the FFT but across those groups, so the
// demod and the audio stage need no other barrier. Every value is computed
// by the operations the rebuilding design used, in its order: the outputs
// do not depend on the tile, the segment that computes a row, or the block
// that reads it. K3ag's bands change no output bit and take no part here:
// every thread sums its own outputs.
constexpr int kWideRows = 16;  // rows a fold group and a demod chunk

// Rows a pass of chain_tile_wide at P = kP (0: P = 8 .. 16, at run time):
// 64 at P = 2 and 32 up to P = 7, where a block's work a pass is small
// beside its barriers (fft_row<P> transforms 8 rows a warp); 16 past it,
// where the pass takes 128 KB of shared memory at M = 1024.
__host__ __device__ constexpr int wide_rows(int kP) {
  return kP == 0 ? 16 : kP == 2 ? 64 : 32;
}

// Whether a chain_tile_wide block at M = 64 P keeps its input rows' ring
// (a pass's rows + L-1) in shared memory beside the pass: up to P = 4 (at
// P = 8 it would fit, 224 KB, but measured slower than K3's reads from L2
// and K5's ring in device memory).
__host__ __device__ constexpr bool ring_on_chip(int P) { return P <= 4; }

// Threads of a chain_tile_wide block at P = kP: fft_row<P> holds 16 P
// values a thread, so P = 3, 4 keep 255 registers a thread; at P = 2 the
// 128 positions of a row take 4 groups of threads (wide_groups); past P =
// 7, 1024 threads would keep 64 and spill (K3 at M = 1024 0.6788 ms
// against 0.5445 at 512 threads on an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md §6).
__host__ __device__ constexpr int wide_threads(int kP) {
  return kP == 0 || kP == 2 || kP >= 5 ? 512 : 256;
}

// Groups of M threads that share a pass's demod, a 16-row chunk each: 4 at
// P = 2 (M = 128 positions, 512 threads), else 1.
__host__ __device__ constexpr int wide_groups(int kP) {
  return kP == 2 ? 4 : 1;
}

// The junction handoff of a wide launch, the segments' published rows:
// slot s (the junction's, then tile o's at 1 + o) holds Y of the
// segment's last row (natural), its last A-1 aud rows (M floats, by
// position; a tile shorter than A-1 rows fills its first T) and its last
// L-1 input rows (2M floats; K5, K6); flags[0] the ticket, flags[1 + s]
// slot s published; ring (K5 and K6 where it is not on chip,
// ring_on_chip) a segment's rb input rows,
// row r at r mod rb.
struct Hand {
  float* slots;
  unsigned* flags;
  float* ring;
  int slot;  // floats a slot: 2M + (A-1) M + (K5, K6) (L-1) 2M
  int rb;    // rows of a ring: a pass's rows + L-1
};

// A block's input rows, from its ring.
struct RingRows {
  const float* ring;
  int rb, w;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const int i = r % rb;
    return ring[(i < 0 ? i + rb : i) * w + k];
  }
};

// Where the planes FFT leaves logical lane k (< 2M: re of output k, or im
// of output k - M) of buffer row r: swizzled at P <= 4 (fft_row), at
// wide_lane's place at P = 5 .. 7 (fft_tile_wide), the plan's past it
// (fft_tile_rt); chan(pos): the channel whose Y is at position pos.
template <int kP>
struct WideMap {
  int M, P;
  const planes_fft::Plan* pl;
  const planes_fft::PlanTabs* tb;
  __device__ __forceinline__ int lane(int k) const {
    if constexpr (kP == 0)
      return pl->lane(k);
    else if constexpr (kP >= 5)
      return planes_fft::wide_lane<kP>(k);
    else
      return k;
  }
  __device__ __forceinline__ int ylane(int r, int k) const {
    return k < M ? sw(r, lane(k)) : M + sw(r, lane(k - M));
  }
  __device__ __forceinline__ int chan(int pos) const {
    if constexpr (kP == 0)
      return P * (pos & 63) + tb->chan[pos >> 6];
    else if constexpr (kP >= 5)
      return kP * (pos & 63) + (pos >> 6);
    else
      return pos;
  }
};

// A block's wait for slots s0 .. s1 to reach `level` (1: Y of the last
// row and the input rows published, 2: the aud rows too; thread 0 spins,
// the block then reads them through L2).
__device__ __forceinline__ void wait_slots(const unsigned* flags, int s0,
                                           int s1, unsigned level) {
  if (threadIdx.x == 0) {
    for (int s = s0; s <= s1; ++s)
      for (long long i = 0;
           *(volatile const unsigned*)(flags + 1 + s) < level; ++i) {
        if (i > (1LL << 22)) __trap();
        __nanosleep(128);
      }
    __threadfence();
  }
  __syncthreads();
}

// The new input rows of a pass, [r_lo, r_hi), into the block's ring (in
// shared or device memory), four lanes a thread, as row4(r, k) gives them;
// rows from pub_lo on also into the block's slot (`pub`).
template <int kT, class Row4>
__device__ __forceinline__ void fill_ring(const RingRows& rr, int r_lo,
                                          int r_hi, const Row4& row4,
                                          float* pub, int pub_lo) {
  const int W = rr.w, W4 = W / 4;
  float* ring = const_cast<float*>(rr.ring);
#pragma unroll 2
  for (int idx = threadIdx.x; idx < (r_hi - r_lo) * W4; idx += kT) {
    const int r = r_lo + idx / W4, k = 4 * (idx % W4);
    const float4 v = row4(r, k);
    const int i = r % rr.rb;
    *reinterpret_cast<float4*>(ring + (size_t)(i < 0 ? i + rr.rb : i) * W + k) =
        v;
    if (pub && r >= pub_lo)
      *reinterpret_cast<float4*>(pub + (size_t)(r - pub_lo) * W + k) = v;
  }
}

// The fold of a pass of kR rows: tile row e (swizzled) gets acc of stream
// row s0 + e, 0 before t_min; the sum chain_tile's fold_rows takes (c2[0]
// v, then fmaf in order), in groups of 16 rows a lane, each group's 16 +
// L-1 inputs and L taps in registers.
template <int kT, int kR, class Src>
__device__ __forceinline__ void fold_wide(float* tile, const Src& in,
                                          const Chain& p, int W, int s0,
                                          int t_min) {
  const int L = p.L;
  for (int kg = threadIdx.x; kg < W * (kR / kWideRows); kg += kT) {
    const int k = kg % W, e0 = kg / W * kWideRows;
    if (L == kFoldL) {
      float c[kFoldL], x[kWideRows + kFoldL - 1];
#pragma unroll
      for (int i = 0; i < kFoldL; ++i) c[i] = __ldg(p.c2 + i * W + k);
#pragma unroll
      for (int i = 0; i < kWideRows + kFoldL - 1; ++i)
        x[i] = in(s0 + e0 - (kFoldL - 1) + i, k);
#pragma unroll
      for (int e = 0; e < kWideRows; ++e) {
        float acc = 0.f;
        if (s0 + e0 + e >= t_min) {
          acc = c[0] * x[e];
#pragma unroll
          for (int i = 1; i < kFoldL; ++i) acc = fmaf(c[i], x[e + i], acc);
        }
        tile[(e0 + e) * W + sw(e0 + e, k)] = acc;
      }
    } else {
      for (int e = e0; e < e0 + kWideRows; ++e) {
        const int sr = s0 + e - (L - 1);
        float acc = 0.f;
        if (s0 + e >= t_min) {
          acc = __ldg(p.c2 + k) * in(sr, k);
          for (int i = 1; i < L; ++i)
            acc = fmaf(__ldg(p.c2 + i * W + k), in(sr + i, k), acc);
        }
        tile[e * W + sw(e, k)] = acc;
      }
    }
  }
}

// The planes FFT of the pass's kR rows (the block synchronised before and
// after by the caller).
template <int kP, int kT, int kR>
__device__ __forceinline__ void fft_wide(float* tile, const Chain& p,
                                         const planes_fft::Plan& pl,
                                         const planes_fft::PlanTabs& tb) {
  const int tid = threadIdx.x;
  if constexpr (kP == 0) {
    planes_fft::fft_tile_rt(tile, kR, tid, kT, p.tw, pl, tb);
  } else if constexpr (kP >= 5) {
    planes_fft::fft_tile_wide<kP>(tile, kR, tid, kT, p.tw);
  } else {
    constexpr int W = 128 * kP;
    const planes_fft::Tw<kP> tw(p.tw, tid & 7);
    for (int base = 4 * (tid >> 5); base < kR; base += kT / 8) {
      const int r = base + ((tid >> 3) & 3);
      planes_fft::fft_row<kP>(tile + r * W, r, tid & 7, tw, p.tw);
    }
  }
}

// The audio outputs o (of n_o; output o takes local rows o*decim - (A-1) ..
// o*decim) that reach the cnt aud rows v[i], local row u_hi - i: each
// output's accumulator (oacc, by position) read once, these rows summed
// into it from the highest down (k = o*decim - u upwards; the A taps in
// shared memory), written once.
__device__ __forceinline__ void audio_rows(float* oacc, int M, int pos,
                                           const float (&v)[kWideRows],
                                           int u_hi, int cnt, int n_o,
                                           const float* taps,
                                           const Chain& p) {
  const int A = p.A, decim = p.decim, u_lo = u_hi - cnt + 1;
  const int o0 = u_lo > 0 ? (u_lo + decim - 1) / decim : 0;
  const int o1 = min(n_o - 1, (u_hi + A - 1) / decim);
  for (int o = o0; o <= o1; ++o) {
    float acc = oacc[o * M + pos];
    const int k0 = o * decim - u_hi;  // the tap of v[0]
    if (cnt == kWideRows && k0 >= 0 && k0 + kWideRows <= A) {
#pragma unroll
      for (int i = 0; i < kWideRows; ++i)
        acc = fmaf(taps[k0 + i], v[i], acc);
    } else {
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) {
        const int k = k0 + i;
        if (i < cnt && k >= 0 && k < A) acc = fmaf(taps[k], v[i], acc);
      }
    }
    oacc[o * M + pos] = acc;
  }
}

// The segment of ticket j (0 the junction, 1 + o tile o) at 2M lanes, M =
// 64 P (P = kP, or p.w at kP = 0), nb tiles in the launch. `in` reads the
// fold's input rows (K3: [halo; vb]; K5, K6: the block's ring, filled by
// `gen` pass by pass).
template <int kP, int kT, class Src, class Gen>
__device__ __forceinline__ void chain_tile_wide(float* sm, const Chain& p,
                                                int t_min, int j, int nb,
                                                const Src& in, const Gen* gen,
                                                const Hand& h) {
  constexpr int kR = wide_rows(kP);
  const int W = kP ? 128 * kP : p.w, M = W / 2, P = M / 64;
  const int A = p.A, L = p.L, decim = p.decim, T = p.T, tid = threadIdx.x;
  const bool junction = j == 0;
  const int lo = junction ? -A : (j - 1) * T, hi = junction ? 0 : lo + T;
  const int dlo = junction ? lo + 1 : lo;  // the first row demodulated
  const int Ha = junction ? A - 1 : min(T, A - 1);  // aud rows published
  const int n_o = junction ? 0 : T / decim;
  const bool last = j == nb && p.prev_out != nullptr;
  float* tile = sm;           // kR x W, swizzled
  float* yp = tile + kR * W;  // Y of the pass above's row 0, by position
  float* oacc = yp + W;       // n_o x M, by position
  // the fold's input rows: at P = 2 .. 4 and 8 in a ring in shared memory
  // (K3's loaded 16 bytes at a time, K5's and K6's made), where it fits
  // beside the pass; else K5's and K6's in their ring in device memory,
  // K3's read from memory by the fold itself
  constexpr bool kGen = !std::is_same_v<Gen, void>;
  const bool on_chip = ring_on_chip(P);
  RingRows ring{oacc + n_o * M, kR + L - 1, W};
  float* taps = oacc + n_o * M + (on_chip ? (kR + L - 1) * W : 0);  // (A,)
  if constexpr (kGen) {
    if (!on_chip) ring = in;
  }
  __shared__ planes_fft::PlanTabs tb;
  const planes_fft::Plan pl = planes_fft::plan_of(kP ? 0 : P);
  if constexpr (kP == 0) planes_fft::fill_tabs(tb, pl, tid);
  const WideMap<kP> map{M, P, &pl, &tb};
  // past M < kT threads, G groups of M threads share the demod: thread tid
  // takes position gpos (channel gm) in group grp
  constexpr int G = wide_groups(kP);
  const int grp = tid / M, gpos = tid % M;
  const int gm = grp < G ? map.chan(gpos) : 0;
  float* mine = h.slots + (size_t)j * h.slot;
  float* my_aud = mine + W;
  const float* before = h.slots + (size_t)(j - 1) * h.slot;  // (j > 0)
  for (int idx = tid; idx < n_o * M; idx += kT) oacc[idx] = 0.f;
  for (int k = tid; k < A; k += kT) taps[k] = __ldg(p.ataps + k);
  philox::Keys keys{};
  if constexpr (kGen) keys = philox::round_keys(gen->s.k0, gen->s.k1);
  // input row r, lanes k .. k+3: K5 and K6 make the segment's own rows
  // (the junction block every row), take the L-1 below a tile from the
  // slot before, and zero the rows below those (read by no row of the
  // tile); K3 reads [halo; vb]
  const auto row4 = [&](int r, int k) -> float4 {
    if constexpr (kGen) {
      if (junction || r >= lo) return gen->gen4(r, k, keys);
      if (r >= lo - (L - 1))
        return __ldcg(reinterpret_cast<const float4*>(
            before + W + (A - 1) * M + (size_t)(r - (lo - (L - 1))) * W + k));
      return make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      if (in.vec) return in.load4(r, k);
      return make_float4(in(r, k), in(r, k + 1), in(r, k + 2), in(r, k + 3));
    }
  };
  const int jp = t_min - 1;  // the row of Y[t_min - 1]
  bool published = false;
  for (int s0 = hi - kR;; s0 -= kR) {
    const bool top = s0 + kR == hi, lowest = s0 <= lo;
    // Y[lo-1] and the input rows below the tile, in the slot before
    if (lowest && !junction) wait_slots(h.flags, j - 1, j - 1, 1u);
    // 1. the fold
    if (kGen || on_chip) {
      const int r_lo = s0 - (L - 1), r_hi = top ? hi : r_lo + kR;
      fill_ring<kT>(ring, r_lo, r_hi, row4,
                    kGen && top ? mine + W + (A - 1) * M : nullptr,
                    hi - (L - 1));
      __syncthreads();
      fold_wide<kT, kR>(tile, ring, p, W, s0, t_min);
    } else {
      if constexpr (!kGen) fold_wide<kT, kR>(tile, in, p, W, s0, t_min);
    }
    __syncthreads();
    // 2. Y of the pass's rows; Y[t_min - 1] is prev0; the segment's last
    //    row's Y into its slot (and the batch's prev_out)
    fft_wide<kP, kT, kR>(tile, p, pl, tb);
    __syncthreads();
    if (jp >= max(s0, lo) && jp < s0 + kR)
      for (int k = tid; k < W; k += kT)
        tile[(jp - s0) * W + map.ylane(jp - s0, k)] = p.prev0[k];
    if (top) {  // the slot's first level: Y of the last row, the input rows
      for (int k = tid; k < W; k += kT) {
        const float y = tile[(kR - 1) * W + map.ylane(kR - 1, k)];
        mine[k] = y;
        if (last) p.prev_out[k] = y;
      }
      __threadfence();
    }
    __syncthreads();
    if (top && tid == 0) atomicExch(h.flags + 1 + j, 1u);
    // 3. demod and audio, position by position, rows s0 + jhi down to
    //    s0 + jlo in chunks of 16 from the top: a chunk's aud rows in
    //    registers, then into the outputs that take them (audio_rows);
    //    rows before the stream take tail0; the batch's last A-1 aud rows
    //    are the carried tail
    const int jhi = top ? kR - 1 : kR;
    const int jlo = lowest ? dlo - s0 : 1;
    const auto demod_chunk = [&](float (&v)[kWideRows], int jc, int cnt,
                                 int pos, int m) {
#pragma unroll
      for (int i = 0; i < kWideRows; ++i) {
        const int jr = jc - i, t = s0 + jr;
        if constexpr (kP == 0) {  // a branch out: fewer registers live
          if (i >= cnt) break;
        }
        if (i < cnt) {
          if (t < t_min) {
            v[i] = p.tail0[(A - 1 + t - t_min) * W + m];
          } else {
            float ar, ai, yr, yi;
            if (t - 1 >= lo) {
              const int i0 = (jr - 1) * W + sw(jr - 1, pos);
              ar = tile[i0];
              ai = tile[i0 + M];
            } else {  // Y[lo - 1], the segment before's last row
              ar = __ldcg(before + m);
              ai = __ldcg(before + M + m);
            }
            if (jr < kR) {
              const int i1 = jr * W + sw(jr, pos);
              yr = tile[i1];
              yi = tile[i1 + M];
            } else {
              yr = yp[pos];
              yi = yp[M + pos];
            }
            v[i] = demod<kFull>(ar, ai, yr, yi, p);
          }
          if (t >= hi - Ha) my_aud[(t - (hi - Ha)) * M + pos] = v[i];
          if (last && t >= hi - (A - 1)) {
            const int it = t - (hi - (A - 1));
            p.tail_out[it * W + m] = v[i];
            p.tail_out[it * W + M + m] = v[i];
          }
        }
      }
    };
    const int nc = (jhi - jlo + kWideRows) / kWideRows;  // chunks
    if (G == 1) {
      for (int pos = tid; pos < M; pos += kT) {
        const int m = map.chan(pos);
        for (int jc = jhi; jc >= jlo; jc -= kWideRows) {
          const int cnt = min(kWideRows, jc - jlo + 1);
          float v[kWideRows];
          demod_chunk(v, jc, cnt, pos, m);
          audio_rows(oacc, M, pos, v, s0 + jc - lo, cnt, n_o, taps, p);
        }
        const int i = sw(0, pos);
        yp[pos] = tile[i];
        yp[M + pos] = tile[M + i];
      }
    } else {
      // G groups of M threads take G chunks at once, then add them to the
      // outputs one group after the other, the highest rows first
      for (int c0 = 0; c0 < nc; c0 += G) {
        const int c = c0 + grp, jc = jhi - c * kWideRows;
        const int cnt = grp < G && c < nc ? min(kWideRows, jc - jlo + 1) : 0;
        float v[kWideRows];
        demod_chunk(v, jc, cnt, gpos, gm);
        for (int g = 0; g < G; ++g) {
          __syncthreads();
          if (grp == g && cnt > 0)
            audio_rows(oacc, M, gpos, v, s0 + jc - lo, cnt, n_o, taps, p);
        }
      }
      if (grp == 0) {
        const int i = sw(0, gpos);
        yp[gpos] = tile[i];
        yp[M + gpos] = tile[M + i];
      }
    }
    if (!published && s0 + jlo <= hi - Ha) {  // the aud rows: the second
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicExch(h.flags + 1 + j, 2u);
      published = true;
    }
    __syncthreads();
    if (lowest) break;
  }
  if (junction) return;
  // 4. the aud rows below the tile, from the segments before (those
  //    holding rows lo-(A-1) .. lo-1), into the outputs that reach them:
  //    their last taps
  wait_slots(h.flags, lo - (A - 1) < 0 ? 0 : (lo - (A - 1)) / T + 1, j - 1,
             2u);
  const auto hand_chunk = [&](float (&v)[kWideRows], int tc, int cnt,
                              int pos, int m) {
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int t = tc - i;
      if constexpr (kP == 0) {
        if (i >= cnt) break;
      }
      if (i < cnt) {
        if (T >= A - 1) {  // every row below the tile in the slot before
          v[i] = __ldcg(before + W + (t - lo + A - 1) * M + pos);
        } else {
          const int o_t = t < 0 ? -1 : t / T;  // the tile holding row t
          const int hi_t = t < 0 ? 0 : (o_t + 1) * T;
          const int ha_t = t < 0 ? A - 1 : min(T, A - 1);
          v[i] = __ldcg(h.slots + (size_t)(o_t + 1) * h.slot + W +
                        (t - (hi_t - ha_t)) * M + pos);
        }
        if (last && t >= hi - (A - 1)) {
          const int it = t - (hi - (A - 1));
          p.tail_out[it * W + m] = v[i];
          p.tail_out[it * W + M + m] = v[i];
        }
      }
    }
  };
  const int nh = (A - 1 + kWideRows - 1) / kWideRows;  // chunks
  const auto hand_cnt = [&](int c) {
    return min(kWideRows, A - 1 - c * kWideRows);
  };
  if (G == 1) {
    for (int pos = tid; pos < M; pos += kT) {
      const int m = map.chan(pos);
      for (int c = 0; c < nh; ++c) {
        float v[kWideRows];
        hand_chunk(v, lo - 1 - c * kWideRows, hand_cnt(c), pos, m);
        audio_rows(oacc, M, pos, v, -1 - c * kWideRows, hand_cnt(c), n_o, taps,
                   p);
      }
    }
  } else {
    for (int c0 = 0; c0 < nh; c0 += G) {
      const int c = c0 + grp;
      const int cnt = grp < G && c < nh ? hand_cnt(c) : 0;
      float v[kWideRows];
      hand_chunk(v, lo - 1 - c * kWideRows, cnt, gpos, gm);
      for (int g = 0; g < G; ++g) {
        __syncthreads();
        if (grp == g && cnt > 0)
          audio_rows(oacc, M, gpos, v, -1 - c * kWideRows, cnt, n_o, taps, p);
      }
    }
    __syncthreads();
  }
  for (int pos = tid; pos < M; pos += kT)
    for (int o = 0; o < n_o; ++o)
      p.aud[((long long)lo / decim + o) * M + map.chan(pos)] =
          oacc[o * M + pos];
}

// Shared floats of a chain block (K3, K5, K6) at kW lanes: at the
// flagship's 128 the tile buffer, and with kAG > 1 room past its T + A rows
// for the band table; wider (kW = 0, w lanes), chain_tile_wide's pass, yp
// and the tile's T/decim x M audio accumulators.
template <int kW>
__host__ __device__ __forceinline__ int chain_smem_floats(int T, int A, int L,
                                                          int ag, int decim,
                                                          int w = kW) {
  if constexpr (kW == 0) {
    const int P = w / 128, rows = wide_rows(P > 7 ? 0 : P);
    return (rows + 1) * w + T / decim * (w / 2) +
           (ring_on_chip(P) ? (rows + L - 1) * w : 0) + A;
  } else {
    const int rows = tile_rows(T, A, L) * kW;
    if (ag == 1) return rows;
    const int tg = T / ag;
    const int need = (T + A) * kW + tg / decim * (tg + A - 1);
    return need > rows ? need : rows;
  }
}

// The flagship's tile of a kernel that rebuilds every junction (K3, K5,
// K6); the last block writes the end state where the kernel returns one.
// tile: the tile the block takes (its blockIdx, or take_tile's ticket).
template <int kV = kFull, int kAG = 1, class Row>
__device__ __forceinline__ void rebuilt_tile(float* buf, const Chain& p,
                                             int t_min, Row row, int tile) {
  const bool last = tile == (int)gridDim.x - 1 && p.prev_out != nullptr;
  chain_tile<true, kV, kAG>(buf, p, t_min, tile * p.T, last, nullptr, nullptr,
                            nullptr, row, [] {});
}

// K3: input rows read from memory, vp = [halo; vb]; kAG > 1 is K3ag.
template <int kAG>
__global__ void __launch_bounds__(kThreads)
fm_chain_kernel(const float* __restrict__ vb, const float* __restrict__ halo,
                int hrows, Chain p) {
  extern __shared__ __align__(16) float buf[];
  rebuilt_tile<kFull, kAG>(buf, p, p.t_min,
                           halo_rows<kFlagW>(vb, halo, hrows), blockIdx.x);
}

// The ablation probe: K3 with the stages of kV switched off; kFull is K3.
template <int kV>
__global__ void __launch_bounds__(kThreads)
fm_chain_ablate_kernel(const float* __restrict__ vb,
                       const float* __restrict__ halo, int hrows, Chain p) {
  extern __shared__ __align__(16) float buf[];
  rebuilt_tile<kV>(buf, p, p.t_min, halo_rows<kFlagW>(vb, halo, hrows),
                   blockIdx.x);
}

// K5: input rows generated in the block (and the batch's last H8 copied
// out as the next carry), the halo from carry0; the base group on the card.
// hand/flags: the junction handoff (gen_window_handoff), with the block's
// tile from a ticket (take_tile).
template <int kAG>
__global__ void __launch_bounds__(kThreads)
fm_chain_gen_kernel(philox::Stream s, const long long* __restrict__ group,
                    const float* __restrict__ amp,
                    const float* __restrict__ carry0,
                    float* __restrict__ carry_out, float* hand,
                    unsigned* flags, Chain p) {
  extern __shared__ __align__(16) float buf[];
  s.g0 = philox::group_at(group, 0);
  const int tile = hand ? take_tile(flags, buf) : (int)blockIdx.x;
  rebuilt_tile<kFull, kAG>(
      buf, p, p.t_min,
      GenRows<kFlagW>{s, amp[0], carry0, carry_out, p.H8, p.n, p.w, hand,
                      flags},
      tile);
}

// K6: K5 with nothing carried in or out: every row a block reads, before
// the batch too, generated from its signed offset to the base group (the
// stream masks groups before its start to 0). One launch takes the nd
// shards of a batch, n rows each: tile b is tile b mod (n/T) of shard d =
// b / (n/T), whose base is the batch's group counter on the card plus goff
// + d n/64 groups. The rows are one stream over the shards (row sr of the
// launch is row sr - d n of shard d, n a multiple of 64), so the junction
// handoff runs across the shards as within them. The stream's first row
// relative to a shard's base (t_min) follows from that base (k6_t_min):
// where a block can reach it (shard 0 of the first batch) it is -64 *
// base, else far in the past (kFarPast, which no block reaches). The blocks
// count rows from the first shard's base (t0 = b T), so each writes its
// audio at its place in the one (nd n/decim, M) output.
constexpr int kFarPast = -(1 << 30);

__device__ __forceinline__ int k6_t_min(const long long* group,
                                        long long goff, int d, int n) {
  const long long shift = (long long)d * n;  // shard d's first row
  const long long g = (long long)philox::group_at(
      group, goff + shift / philox::kGroupRows);  // shard d's base
  return g <= 0 ? (int)shift
         : g >= (1LL << 24) ? kFarPast
                            : (int)(shift - g * philox::kGroupRows);
}

template <int kAG>
__global__ void __launch_bounds__(kThreads)
fm_chain_gen_warm_kernel(philox::Stream s, const long long* __restrict__ group,
                         long long goff, const float* __restrict__ amp,
                         float* hand, unsigned* flags, const Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int tile = hand ? take_tile(flags, buf) : (int)blockIdx.x;
  const int t_min = k6_t_min(group, goff, tile / (p.n / p.T), p.n);
  s.g0 = philox::group_at(group, goff);  // row 0 of the launch
  rebuilt_tile<kFull, kAG>(
      buf, p, t_min,
      GenRows<kFlagW>{s, amp[0], nullptr, nullptr, p.H8, p.n, p.w, hand,
                      flags},
      tile);
}

// The wide kernels (chain_tile_wide, 2M > 128 lanes): a block a segment,
// nb tiles and the junction, its segment from the ticket.
template <int kP>
__global__ void __launch_bounds__(wide_threads(kP))
fm_chain_wide_kernel(const float* __restrict__ vb,
                     const float* __restrict__ halo, int hrows, Hand h, int nb,
                     Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int j = take_tile(h.flags, buf);
  chain_tile_wide<kP, wide_threads(kP), HaloRows<0>, void>(
      buf, p, p.t_min, j, nb, halo_rows<0>(vb, halo, hrows, p.w), nullptr, h);
}

template <int kP>
__global__ void __launch_bounds__(wide_threads(kP))
fm_chain_gen_wide_kernel(philox::Stream s, const long long* __restrict__ group,
                         const float* __restrict__ amp,
                         const float* __restrict__ carry0,
                         float* __restrict__ carry_out, Hand h, int nb,
                         Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int j = take_tile(h.flags, buf);
  s.g0 = philox::group_at(group, 0);
  const GenRows<0> gen{s, amp[0], carry0, carry_out, p.H8, p.n, p.w, nullptr,
                       nullptr};
  chain_tile_wide<kP, wide_threads(kP)>(
      buf, p, p.t_min, j, nb,
      RingRows{h.ring + (size_t)j * h.rb * p.w, h.rb, p.w}, &gen, h);
}

template <int kP>
__global__ void __launch_bounds__(wide_threads(kP))
fm_chain_gen_warm_wide_kernel(philox::Stream s,
                              const long long* __restrict__ group,
                              long long goff, const float* __restrict__ amp,
                              Hand h, int nb, const Chain p) {
  extern __shared__ __align__(16) float buf[];
  const int j = take_tile(h.flags, buf);
  const int d = j == 0 ? 0 : (j - 1) / (p.n / p.T);  // the segment's shard
  const int t_min = k6_t_min(group, goff, d, p.n);
  s.g0 = philox::group_at(group, goff);  // row 0 of the launch
  const GenRows<0> gen{s, amp[0], nullptr, nullptr, p.H8, p.n, p.w, nullptr,
                       nullptr};
  chain_tile_wide<kP, wide_threads(kP)>(
      buf, p, t_min, j, nb,
      RingRows{h.ring + (size_t)j * h.rb * p.w, h.rb, p.w}, &gen, h);
}

// K3p: a block walks G consecutive tiles of the batch, in the roles of a
// warp-specialised pipeline (the overlap the reference's `_kernel_pipe`
// describes: the fold and DFT of one tile beside the demod and audio FIR
// of the tile before):
//   - a producer warp keeps the fold's input windows coming: each 32-row
//     pass of the fold reads 32 + L-1 consecutive input rows, one bulk
//     copy (cp.async.bulk, the TMA's) into a ring of kPipeStages stages,
//     completion on the stage's `full` mbarrier, the stage reused once the
//     fold threads have arrived on its `empty` one (rows before the batch:
//     a second copy from the halo, and zeros before it);
//   - the fold group (4 warps) folds each pass into one of two Y slots
//     (fold_pass_to, the arithmetic of fold_rows), then transforms the
//     slot's rows (fft_row) and hands the slot over;
//   - the demod group (8 warps) demodulates the slot into a ring of aud
//     rows, keeps the slot's last Y row (Y[t0-1] of the next tile), hands
//     the slot back, and runs the tile's decimating audio FIR over the
//     ring, the A-1 rows before the tile included, its taps in shared
//     memory.
// The demod and the audio FIR are two thirds of a tile's work: with 8
// fold and 4 demod warps (PERF.md §6, `probes/stages.py k3p --split`) the
// fold group waited on the demod group, which alone took the whole time.
// A block's first chunk is its junction, the A stream rows before its
// first tile (the rows K3's block folds in front of its tile), and then
// its tiles, T rows each; the slot of chunk c is c mod 2. The two groups
// meet only at the slots, on named barriers (bar.arrive by the side that
// is done, bar.sync by the side that waits; kBarFull + s, kBarEmpty + s),
// never at a block-wide barrier. Every value is computed by the routines
// K3 runs, in their order, so the outputs are K3's bit for bit at any
// tile and G.
constexpr int kPipeStages = 2;       // windows in flight
constexpr int kPipeFold = 128;       // the fold group's threads (4 warps)
constexpr int kPipeDemod = 256;      // the demod group's threads (8 warps)
constexpr int kPipeThreads = kPipeFold + kPipeDemod + 32;
constexpr int kBarFold = 1, kBarDemod = 2, kBarFull = 3, kBarEmpty = 5;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// The producer's arrival on `full`, which then waits for `bytes` more of
// bulk copies.
__device__ __forceinline__ void expect_tx(uint64_t* full, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(full)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, its bytes counted on `full`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* full) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(full))
      : "memory");
}

// Shared memory of a K3p block, in floats: the mbarriers (16 floats),
// two Y slots of pad32(max(T, A)) rows, kPipeStages windows of 32 + L-1
// rows, the aud ring of A-1+T rows of M, two saved Y rows and the A audio
// taps.
__host__ __device__ __forceinline__ int pipe_slot_rows(int T, int A) {
  return pad_rows(T > A ? T : A);
}

__host__ __device__ __forceinline__ long long pipe_smem_floats(int T, int A,
                                                               int L) {
  constexpr int W = kFlagW;
  return 16 + 2LL * pipe_slot_rows(T, A) * W +
         (long long)kPipeStages * (kChunkRows + L - 1) * W +
         (long long)(A - 1 + T) * (W / 2) + 2 * W + A;
}

// A fold pass of the fold group (kPipeFold threads, the role's own index
// ft; groups of 16 rows of a lane, kG a thread): rows r0 .. r0+31 of slot
// `dst` (swizzled) from the window `src` (natural; its row jj + q the
// input of row jj's tap q), acc 0 where t_first + jj < t_min or jj >=
// nrows. Per lane fold_rows' sum: c2[0]*v, then fmaf in order. The
// window's reads come before `after_reads`.
constexpr int kPipeG = kChunkRows * kFlagW / (16 * kPipeFold);  // groups a
                                                                 // thread

// The fold group's taps: c[gi][q] = c2[q][lane of group gi], loaded once.
__device__ __forceinline__ void pipe_taps(float (&c)[kPipeG][kFoldL],
                                          const Chain& p, int ft) {
#pragma unroll
  for (int gi = 0; gi < kPipeG; ++gi)
#pragma unroll
    for (int q = 0; q < kFoldL; ++q)
      c[gi][q] = __ldg(p.c2 + q * kFlagW + (ft + gi * kPipeFold) % kFlagW);
}

template <int kL, class AfterReads>
__device__ __forceinline__ void fold_pass_to(const float* src, float* dst,
                                             int r0, const Chain& p,
                                             int t_min, int t_first,
                                             int nrows, int ft,
                                             const float (&c)[kPipeG][kFoldL],
                                             AfterReads after_reads) {
  constexpr int W = kFlagW, kPer = 16, kG = kPipeG;
  float o[kG][kPer];
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    const int gr = ft + gi * kPipeFold;
    const int k = gr % W, jw = gr / W * kPer;  // its lane, its window rows
    const int j0 = r0 + jw;
    if constexpr (kL > 0) {
      float v[kPer + kL - 1];
#pragma unroll
      for (int i = 0; i < kPer + kL - 1; ++i)
        v[i] = j0 + i < nrows + kL - 1 ? src[(jw + i) * W + k] : 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        float acc = 0.f;
        if (j0 + e < nrows && t_first + j0 + e >= t_min) {
          acc = c[gi][0] * v[e];
#pragma unroll
          for (int q = 1; q < kL; ++q) acc = fmaf(c[gi][q], v[e + q], acc);
        }
        o[gi][e] = acc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int jj = j0 + e;
        o[gi][e] = 0.f;
        if (jj < nrows && t_first + jj >= t_min) {
          float acc = __ldg(p.c2 + k) * src[(jw + e) * W + k];
          for (int q = 1; q < p.L; ++q)
            acc = fmaf(__ldg(p.c2 + q * W + k), src[(jw + e + q) * W + k],
                       acc);
          o[gi][e] = acc;
        }
      }
    }
  }
  after_reads();
#pragma unroll
  for (int gi = 0; gi < kG; ++gi) {
    const int gr = ft + gi * kPipeFold;
    const int k = gr % W, j0 = r0 + gr / W * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int r = j0 + e;
      dst[r * W + sw(r, k)] = o[gi][e];
    }
  }
}

__global__ void __launch_bounds__(kPipeThreads)
fm_chain_pipe_kernel(const float* __restrict__ vb,
                     const float* __restrict__ halo, int hrows, Chain p,
                     int G) {
  extern __shared__ __align__(16) float sm[];
  constexpr int W = kFlagW, M = W / 2;
  const int T = p.T, A = p.A, L = p.L;
  const int NT = p.n / T, g0 = blockIdx.x * G;
  const int g1 = min(g0 + G, NT);
  const int nchunks = 1 + g1 - g0;     // the junction, then the tiles
  const int RS = pipe_slot_rows(T, A), WR = kChunkRows + L - 1;
  const int Ra = A - 1 + T;            // the aud ring's rows
  const int base = g0 * T - A;         // the stream row of ring row 0
  uint64_t* full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* empty = full + kPipeStages;
  float* slots = sm + 16;
  float* stages = slots + 2 * RS * W;
  float* ring = stages + kPipeStages * WR * W;
  float* yp = ring + Ra * M;           // Y[t0-1] of the next chunk, by turns
  float* taps = yp + 2 * W;            // the audio FIR's A taps
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kPipeStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kPipeFold);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // chunk c: stream rows u0 .. u0 + nr - 1 (the junction: A rows before
  // the first tile)
  const auto chunk_u0 = [&](int c) { return c == 0 ? g0 * T - A : (g0 + c - 1) * T; };
  const auto chunk_rows = [&](int c) { return c == 0 ? A : T; };

  if (tid >= kPipeFold + kPipeDemod) {  // the producer warp
    const int lane = tid & 31;
    int q = 0;  // passes issued
    for (int c = 0; c < nchunks; ++c) {
      const int u0 = chunk_u0(c), np = (chunk_rows(c) + kChunkRows - 1) / kChunkRows;
      for (int pass = 0; pass < np; ++pass, ++q) {
        const int k = q % kPipeStages;
        mbar_wait(empty + k, ((q / kPipeStages) & 1) ^ 1);
        float* dst = stages + k * WR * W;
        // the window, stream rows lo .. hi-1: zeros before the halo, then
        // the halo's rows (stream rows -hrows .. -1), then vb's
        const int lo = u0 + pass * kChunkRows - (L - 1), hi = lo + WR;
        const int z1 = min(hi, -hrows), h0 = max(lo, -hrows), h1 = min(hi, 0);
        const int v0 = max(lo, 0);
        for (int idx = lane; idx < (z1 - lo) * W; idx += 32) dst[idx] = 0.f;
        const int nh = max(0, h1 - h0), nv = max(0, hi - v0);
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          if (nh + nv == 0) {
            mbar_arrive(full + k);
          } else {
            expect_tx(full + k, (unsigned)((nh + nv) * W * 4));
            if (nh)
              bulk_copy(dst + (h0 - lo) * W, halo + (long long)(h0 + hrows) * W,
                        (unsigned)(nh * W * 4), full + k);
            if (nv)
              bulk_copy(dst + (v0 - lo) * W, vb + (long long)v0 * W,
                        (unsigned)(nv * W * 4), full + k);
          }
        }
      }
    }
  } else if (tid < kPipeFold) {  // the fold group: fold, then the FFT
    const int ft = tid;
    const planes_fft::Tw<1> tw(p.tw, ft & 7);
    float ctaps[kPipeG][kFoldL] = {};  // the thread's lanes' fold taps
    if (L == kFoldL) pipe_taps(ctaps, p, ft);
    int q = 0;
    for (int c = 0; c < nchunks; ++c) {
      float* slot = slots + (c & 1) * RS * W;
      if (c >= 2) bar_sync(kBarEmpty + (c & 1), kPipeFold + kPipeDemod);
      const int u0 = chunk_u0(c), nr = chunk_rows(c);
      const int np = (nr + kChunkRows - 1) / kChunkRows;
      for (int pass = 0; pass < np; ++pass, ++q) {
        const int k = q % kPipeStages;
        mbar_wait(full + k, (q / kPipeStages) & 1);
        const float* src = stages + k * WR * W;
        const auto release = [&] { mbar_arrive(empty + k); };
        if (L == kFoldL)
          fold_pass_to<kFoldL>(src, slot, pass * kChunkRows, p, p.t_min, u0,
                               nr, ft, ctaps, release);
        else
          fold_pass_to<0>(src, slot, pass * kChunkRows, p, p.t_min, u0, nr,
                          ft, ctaps, release);
      }
      bar_sync(kBarFold, kPipeFold);
      for (int b = 4 * (ft >> 5); b < nr; b += kPipeFold / 8) {
        const int r = b + ((ft >> 3) & 3);
        planes_fft::fft_row<1>(slot + r * W, r, ft & 7, tw, p.tw);
      }
      const int jp = p.t_min - 1 - u0;  // the row of Y[t_min - 1]
      if (jp >= 0 && jp < nr) {
        bar_sync(kBarFold, kPipeFold);
        for (int k = ft; k < W; k += kPipeFold) slot[jp * W + sw(jp, k)] = p.prev0[k];
      }
      __threadfence_block();
      bar_arrive(kBarFull + (c & 1), kPipeFold + kPipeDemod);
    }
  } else {  // the demod group: demod, then the audio FIR
    const int dt = tid - kPipeFold;
    for (int k = dt; k < A; k += kPipeDemod) taps[k] = __ldg(p.ataps + k);
    bar_sync(kBarDemod, kPipeDemod);
    for (int c = 0; c < nchunks; ++c) {
      const float* slot = slots + (c & 1) * RS * W;
      bar_sync(kBarFull + (c & 1), kPipeFold + kPipeDemod);
      const int u0 = chunk_u0(c), nr = chunk_rows(c);
      const int j0 = c == 0 ? 1 : 0;  // the junction's first row: no aud
      const float* ya = yp + ((c - 1) & 1) * W;  // Y[u0 - 1], natural
      const int ring0 = (u0 - base) % Ra;  // ring row of stream row u0
      for (int idx = dt; idx < (nr - j0) * M; idx += kPipeDemod) {
        const int jj = j0 + idx / M, m = idx % M, t = u0 + jj;
        const int rr = ring0 + jj < Ra ? ring0 + jj : ring0 + jj - Ra;
        float val;
        if (t < p.t_min) {
          val = p.tail0[(A - 1 + t - p.t_min) * W + m];
        } else {
          const float* pa = jj == 0 ? ya : slot + (jj - 1) * W;
          const int ma = jj == 0 ? m : sw(jj - 1, m), my = sw(jj, m);
          const float* py = slot + jj * W;
          val = demod<kFull>(pa[ma], pa[ma + M], py[my], py[my + M], p);
        }
        ring[rr * M + m] = val;
      }
      for (int k = dt; k < W; k += kPipeDemod)
        yp[(c & 1) * W + k] = slot[(nr - 1) * W + sw(nr - 1, k)];
      if (c + 2 < nchunks) {
        __threadfence_block();
        bar_arrive(kBarEmpty + (c & 1), kPipeFold + kPipeDemod);
      }
      bar_sync(kBarDemod, kPipeDemod);
      if (c > 0) {  // the tile's audio: out[o] = sum_k ataps[k] aud[o d - k]
        const int n_o = T / p.decim;
        for (int idx = dt; idx < n_o * M; idx += kPipeDemod) {
          const int o = idx / M, m = idx % M;
          int r = ring0 + o * p.decim;  // the ring row of tap 0
          r = r < Ra ? r : r - Ra;
          // taps 0 .. r at rows r .. 0, then the rest from the ring's end
          const int k1 = r + 1 < A ? r + 1 : A;
          const float* col = ring + r * M + m;
          float acc = 0.f;
          for (int k = 0; k < k1; ++k) acc = fmaf(taps[k], col[-k * M], acc);
          col += Ra * M;
          for (int k = k1; k < A; ++k) acc = fmaf(taps[k], col[-k * M], acc);
          p.aud[((long long)u0 / p.decim + o) * M + m] = acc;
        }
        if (g0 + c == NT) {  // the batch's last tile: the carried state
          for (int k = dt; k < W; k += kPipeDemod) p.prev_out[k] = yp[(c & 1) * W + k];
          for (int idx = dt; idx < (A - 1) * M; idx += kPipeDemod) {
            const int i = idx / M, m = idx % M;
            const float v = ring[((p.n - (A - 1) + i - base) % Ra) * M + m];
            p.tail_out[i * W + m] = v;
            p.tail_out[i * W + M + m] = v;
          }
        }
        bar_sync(kBarDemod, kPipeDemod);  // before the next chunk's aud rows
      }
    }
  }
}

Chain make_chain(const float* prev0, const float* tail0, const float* c2,
                 const float* tw, const float* ataps, float* aud,
                 float* prev_out, float* tail_out, int n, int L, int H8,
                 int A, int decim, int T, int t_min, float gain,
                 const float* atan_coeffs, int ag = 1, int M = 64) {
  return Chain{c2,    tw,    ataps, prev0, tail0,
               aud,   prev_out, tail_out, n, L,
               H8,    A,     decim, T,     t_min,
               ag,    2 * M, gain,  mathfns::load_atan(atan_coeffs)};
}

// The chain kernels' launch: the shared memory the tile buffer takes
// (above 48 KB only once the kernel is allowed it), then one block of
// `threads` a tile.
template <class Kernel, class... Args>
int launch_blocks(Kernel kernel, int threads, size_t smem, int blocks,
                  void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <class Kernel, class... Args>
int launch_tiles(Kernel kernel, size_t smem, int blocks, void* stream,
                 Args... args) {
  return launch_blocks(kernel, kThreads, smem, blocks, stream, args...);
}

// The audio stage's bands a chain kernel takes: 1, or K3ag's 2 or 4, each
// band a whole number of output rows.
bool valid_bands(int ag, int T, int decim) {
  return (ag == 1 || ag == 2 || ag == 4) && T % ag == 0 && (T / ag) % decim == 0;
}

// One flagship chain kernel (K3, K5 or K6 at 128 lanes) at the audio
// stage's bands `ag`: the instance of the kernel template for them, with
// the shared memory it takes.
#define LAUNCH_BANDS(kernel, ag, T, A, L, decim, blocks, stream, ...)        \
  {                                                                          \
    const size_t smem_ =                                                     \
        (size_t)chain_smem_floats<kFlagW>(T, A, L, ag, decim) * sizeof(float); \
    switch (ag) {                                                            \
      case 1:                                                                \
        return launch_tiles(kernel<1>, smem_, blocks, stream, __VA_ARGS__);  \
      case 2:                                                                \
        return launch_tiles(kernel<2>, smem_, blocks, stream, __VA_ARGS__);  \
      default:                                                               \
        return launch_tiles(kernel<4>, smem_, blocks, stream, __VA_ARGS__);  \
    }                                                                        \
  }

// The launch of a chain kernel at M = 64 P channels: the flagship's
// instances at P = 1 (fn<1>), chain_tile_wide's for P = 2 .. 7 (fn<P>) and
// its run-time one at P = 8 .. 16 (fn<0>), or cudaErrorInvalidValue.
#define FOR_WIDTH(M, fn, ...)                                        \
  switch ((M) % 64 ? 0 : (M) / 64) {                                 \
    case 1: return fn<1>(__VA_ARGS__);                               \
    case 2: return fn<2>(__VA_ARGS__);                               \
    case 3: return fn<3>(__VA_ARGS__);                               \
    case 4: return fn<4>(__VA_ARGS__);                               \
    case 5: return fn<5>(__VA_ARGS__);                               \
    case 6: return fn<6>(__VA_ARGS__);                               \
    case 7: return fn<7>(__VA_ARGS__);                               \
    default:                                                         \
      if ((M) % 64 || (M) / 64 < 8 || (M) / 64 > 16)                \
        return (int)cudaErrorInvalidValue;                           \
      return fn<0>(__VA_ARGS__);                                     \
  }

// The handoff's flags zeroed on the launch's stream, before it: the
// ticket counter and one flag a tile (gen_window_handoff) or segment
// (chain_tile_wide).
int handoff_reset(unsigned* flags, int tiles, void* stream) {
  return (int)cudaMemsetAsync(flags, 0, (size_t)(tiles + 1) * sizeof(unsigned),
                              (cudaStream_t)stream);
}

// A wide launch's handoff memory (ops/cuda/fm_chain.py wide_plan lays out
// the same): nb + 1 slots, then (K5, K6) nb + 1 rings.
Hand make_hand(float* hand, unsigned* flags, int nb, int W, int A, int L,
               bool gen) {
  const int hx = gen ? L - 1 : 0, P = W / 128;
  const int rb = wide_rows(P > 7 ? 0 : P) + L - 1;
  const int slot = W + (A - 1) * (W / 2) + hx * W;
  return Hand{hand, flags,
              gen && !ring_on_chip(P) ? hand + (size_t)(nb + 1) * slot
                                      : nullptr,
              slot, rb};
}

// A wide kernel's launch over nb tiles: its flags zeroed, then the
// junction's block and a block a tile.
template <int kP, class Kernel, class... Args>
int launch_wide(Kernel kernel, const Chain& p, int nb, void* stream,
                const Hand& h, Args... args) {
  if (const int err = handoff_reset(h.flags, nb + 1, stream)) return err;
  const size_t smem =
      (size_t)chain_smem_floats<0>(p.T, p.A, p.L, 1, p.decim, p.w) *
      sizeof(float);
  return launch_blocks(kernel, wide_threads(kP), smem, nb + 1, stream,
                       args..., h, nb, p);
}

template <int kP>
int planes_launch(const float* vb, const float* halo, int hrows, int n,
                  int ag, float* hand, unsigned* flags, void* stream,
                  const Chain& p) {
  if constexpr (kP == 1) {
    LAUNCH_BANDS(fm_chain_kernel, ag, p.T, p.A, p.L, p.decim, n / p.T, stream,
                 vb, halo, hrows, p);
  } else {
    const int nb = n / p.T;
    return launch_wide<kP>(fm_chain_wide_kernel<kP>, p, nb, stream,
                           make_hand(hand, flags, nb, p.w, p.A, p.L, false),
                           vb, halo, hrows);
  }
}

template <int kP>
int gen_launch(const philox::Stream& s, const long long* group,
               const float* amp, const float* carry0, float* carry_out, int n,
               int ag, float* hand, unsigned* flags, void* stream,
               const Chain& p) {
  if constexpr (kP == 1) {
    if (hand)
      if (const int err = handoff_reset(flags, n / p.T, stream)) return err;
    LAUNCH_BANDS(fm_chain_gen_kernel, ag, p.T, p.A, p.L, p.decim, n / p.T,
                 stream, s, group, amp, carry0, carry_out, hand, flags, p);
  } else {
    const int nb = n / p.T;
    return launch_wide<kP>(fm_chain_gen_wide_kernel<kP>, p, nb, stream,
                           make_hand(hand, flags, nb, p.w, p.A, p.L, true), s,
                           group, amp, carry0, carry_out);
  }
}

template <int kP>
int gen_warm_launch(const philox::Stream& s, const long long* group,
                    long long goff, int nd, const float* amp, int n, int ag,
                    float* hand, unsigned* flags, void* stream,
                    const Chain& p) {
  const int nb = nd * (n / p.T);
  if constexpr (kP == 1) {
    if (hand)
      if (const int err = handoff_reset(flags, nb, stream)) return err;
    LAUNCH_BANDS(fm_chain_gen_warm_kernel, ag, p.T, p.A, p.L, p.decim, nb,
                 stream, s, group, goff, amp, hand, flags, p);
  } else {
    return launch_wide<kP>(fm_chain_gen_warm_wide_kernel<kP>, p, nb, stream,
                           make_hand(hand, flags, nb, p.w, p.A, p.L, true), s,
                           group, goff, amp);
  }
}

// The junction handoff's buffers: at 128 lanes K5's and K6's, both or
// neither (none: each block generates its whole window); wider every chain
// kernel's, both.
bool valid_handoff(const float* hand, const unsigned* flags, int M) {
  return 2 * M == kFlagW ? (hand == nullptr) == (flags == nullptr)
                         : hand != nullptr && flags != nullptr;
}

}  // namespace

extern "C" int fm_chain_planes_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* tw, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, int ag, int hrows, int t_min, float* hand,
    unsigned* flags, float gain, const float* atan_coeffs, void* stream) {
  // every block's window must lie in [halo; vb]; wider than the flagship,
  // the handoff's buffers
  if (hrows < H8 || (t_min < 0 && hrows < A + L - 1) ||
      !valid_bands(ag, T, decim) ||
      (2 * M != kFlagW && (hand == nullptr || flags == nullptr)))
    return (int)cudaErrorInvalidValue;
  FOR_WIDTH(M, planes_launch, vb, halo, hrows, n, ag, hand, flags, stream,
            make_chain(prev0, tail0, c2, tw, ataps, aud, prev_out, tail_out,
                       n, L, H8, A, decim, T, t_min, gain, atan_coeffs, ag,
                       M));
}

// The ablation probe's launch: K3's arguments (prev_out/tail_out may be
// null: the variant then writes the audio only) and the variant.
extern "C" int fm_chain_ablate_launch(
    int variant, const float* vb, const float* halo, const float* prev0,
    const float* tail0, const float* c2, const float* tw, const float* ataps,
    float* aud, float* prev_out, float* tail_out, int n, int M, int L, int H8,
    int A, int decim, int T, int hrows, int t_min, float gain,
    const float* atan_coeffs, void* stream) {
  if (2 * M != kFlagW || hrows < H8 || (t_min < 0 && hrows < A + L - 1) ||
      variant < 0 || variant >= kVariants || (prev_out == nullptr) !=
      (tail_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows(T, A, L) * kFlagW * sizeof(float);
  const Chain p = make_chain(prev0, tail0, c2, tw, ataps, aud, prev_out,
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
    const float* prev0, const float* tail0, const float* c2, const float* tw,
    const float* ataps, float* aud, float* prev_out, float* tail_out,
    float* carry_out, int n, int M, int L, int H8, int A, int decim, int T,
    int ag, float* hand, unsigned* flags, float gain,
    const float* atan_coeffs, void* stream) {
  if ((draws != 2 && draws != 3) || !valid_bands(ag, T, decim) ||
      !valid_handoff(hand, flags, M))
    return (int)cudaErrorInvalidValue;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, 0};
  FOR_WIDTH(M, gen_launch, s, group, amp, carry0, carry_out, n, ag, hand,
            flags, stream,
            make_chain(prev0, tail0, c2, tw, ataps, aud, prev_out, tail_out,
                       n, L, H8, A, decim, T, 0, gain, atan_coeffs, ag, M));
}

// K6 over nd shards of n rows each (aud: nd n/decim rows), one launch.
extern "C" int fm_chain_gen_warm_launch(
    const long long* group, long long goff, int nd, uint32_t k0, uint32_t k1,
    int draws, float mean, float inv_std, const float* amp, const float* prev0,
    const float* tail0, const float* c2, const float* tw, const float* ataps,
    float* aud, int n, int M, int L, int H8, int A, int decim, int T,
    int ag, float* hand, unsigned* flags, float gain,
    const float* atan_coeffs, void* stream) {
  if ((draws != 2 && draws != 3) || !valid_bands(ag, T, decim) || nd < 1 ||
      n % T || n % philox::kGroupRows || (long long)nd * n > (1LL << 30) ||
      !valid_handoff(hand, flags, M))
    return (int)cudaErrorInvalidValue;
  const philox::Stream s{0, k0, k1, draws, mean, inv_std, 1};
  FOR_WIDTH(M, gen_warm_launch, s, group, goff, nd, amp, n, ag, hand, flags,
            stream,
            make_chain(prev0, tail0, c2, tw, ataps, aud, nullptr, nullptr,
                       n, L, H8, A, decim, T, 0, gain, atan_coeffs, ag, M));
}

// The handoff's flags zeroed alone, as the launchers zero them before a
// launch of `tiles` tiles or segments (the probes time it).
extern "C" int fm_chain_handoff_reset(unsigned* flags, int tiles,
                                      void* stream) {
  return tiles < 1 ? (int)cudaErrorInvalidValue
                   : handoff_reset(flags, tiles, stream);
}

extern "C" int fm_chain_pipe_launch(
    const float* vb, const float* halo, const float* prev0, const float* tail0,
    const float* c2, const float* tw, const float* ataps, float* aud,
    float* prev_out, float* tail_out, int n, int M, int L, int H8, int A,
    int decim, int T, int hrows, int t_min, int G, float gain,
    const float* atan_coeffs, void* stream) {
  // tiles of whole fold passes; a window's rows inside vb past the halo
  if (2 * M != kFlagW || T % kChunkRows || T < A - 1 || T < L - 1 || n % T ||
      G < 1 || ((uintptr_t)vb | (uintptr_t)halo) % 16 || hrows < H8 ||
      L < 1 || A < 1 ||
      T % decim || (t_min < 0 && hrows < A + L - 1))
    return (int)cudaErrorInvalidValue;
  return launch_blocks(
      fm_chain_pipe_kernel, kPipeThreads,
      (size_t)pipe_smem_floats(T, A, L) * sizeof(float),
      (n / T + G - 1) / G, stream, vb, halo, hrows,
      make_chain(prev0, tail0, c2, tw, ataps, aud, prev_out, tail_out, n, L,
                 H8, A, decim, T, t_min, gain, atan_coeffs),
      G);
}

// K2's launch: float4 lanes where y, x and out all lie on the 16-byte grid
// (a torch allocation does; a view may not), else one element a thread.
extern "C" int atan2_launch(const float* y, const float* x, float* out,
                            long long n, const float* atan_coeffs,
                            void* stream) {
  const int threads = 256;
  const bool vec = (((uintptr_t)y | (uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const long long items = vec ? (n / 4 > 3 ? n / 4 : 3) : n;  // >= the tail
  long long blocks = (items + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  const AtanCoeffs co = mathfns::load_atan(atan_coeffs);
  if (vec)
    atan2_kernel<true><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        y, x, out, n, co);
  else
    atan2_kernel<false><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        y, x, out, n, co);
  return (int)cudaGetLastError();
}
