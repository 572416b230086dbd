// The polyphase channelizer front end for Hopper (sm_90a).
//
// Replaces the TPU kernels newsched_tpu/ops/pallas/channelizer.py
// `arm_fold` (`_kernel`; K7 here) and `arm_fold_dft` (`_fused_kernel`;
// K1 here). On the interleaved [re, im] float32 view of the commutator
// matrix v (rows of 2M lanes):
//
//   acc[t] = c2[0]*v[t] + c2[1]*v[t+1] + ... + c2[L-1]*v[t+L-1]   (K7)
//   Y[t]   = acc[t] @ W2                                          (K1)
//
// with W2 the (2M x 2M) interleaved DFT matrix (phase combine and
// twiddle in one real product). Rows of v past its end read as 0, so the
// caller pads nothing. Both compute each output as the same chain,
// acc = c2[0]*v[t], then acc = fmaf(c2[q], v[t+q], acc) for q = 1..L-1, so
// K7 equals K1's fold bit for bit, and neither depends on its tile size.
//
// The TPU kernels DMA one overlapping (T+H8)-row window per grid step and
// slide the taps over it in VMEM.
//
// K7 slides down the rows in registers instead. A thread owns kVec adjacent
// lanes (a float4 where W and the pointers allow it, else a float2 or one
// float; 32 threads span a 128-lane row) and a run of R consecutive output
// rows. It keeps its L taps in registers and a ring of the last L + kAhead
// input rows of its lanes: the loop over the run is unrolled by the ring's
// length, so every ring index is a constant, and each step loads the row
// kAhead steps ahead of its use with one 16-byte load, computes one output
// from the ring and stores it with one 16-byte store. Each input word is
// thus loaded once per run (R + L - 1 loads for R outputs), where a loop
// over each output's taps loads L words of input and L of
// taps for every output and leaves the reuse to L1. With no tile given, R
// is what makes one wave of runs on the card (fold_plan): the time follows
// the wave count more than the halo rows a run re-reads. The taps' count L
// is a template constant for 4, 8 and 16 (the flagship's), and the width W
// for 128, 256 and 512 lanes; any other L or W takes a generic instance of
// the same kernel (a runtime L loads each output's L rows in turn). The
// ring loads straight from device memory: staging the block's window in
// shared memory first (cp.async) measured no faster (PERF.md).
//
// Bounds on the H100 at the flagship shape (32768 x 128 rows): K7 moves
// 16.8 MB in and 16.8 MB out, ~10 us at 3.35 TB/s, against 2*L flops a
// lane (~2 flops/byte): memory-bound. K1 adds the phase combine; as an
// M-point FFT a row (~5 M log2 M flops) it stays memory-bound like K7
// (chip_smoke.py kernel_bounds), where the TPU's dense (2M x 2M) product,
// 2*128^2 flops a row at M = 64 (17x the FFT), made it compute-bound.
//
// K1 at M = 64 P, P = 1 .. 7 (64 to 448 channels; the FFT instance) is
// K7's register ring and the fused chains' FFT (planes_fft.cuh) in one
// block. A thread owns one channel q, lanes 2q and 2q+1 (a float2), G =
// 256/M groups of M threads at M <= 128 (one group of M threads above),
// and each group a run
// of consecutive rows, folded in registers as K7 folds them (the ring of L
// + kAhead rows, each input word loaded once a run, the same fmaf chain as
// K7's, so K1's fold is K7's output bit for bit). Every S = 32/G rows of
// its run a group has written the folded rows as planes rows (re lanes,
// then im, swizzled) into one of two 32-row tiles in shared memory; the
// block then transforms the tile's 32 rows (8 threads a row) and writes
// them interleaved, two channels a 16-byte store, while the next S rows
// fold into the other tile. The transform takes the host's twiddles
// (planes_fft_table) with every operation rounded on its own, so K1's
// output is the torch-float32 FFT replay of K7's fold bit for bit
// (channelizer.py fft_interleaved) and does not depend on the run length.
// At P <= 4 a row's 8 threads transform it alone (fft_row); at P = 5-7
// the block takes the tile in two passes, the radix-P columns and then
// the P 64-point FFTs a warp (fft_tile_wide), so that a thread holds 8
// complex values of a row, not 8 P, beside its fold's ring and taps
// (a block of 448 threads leaves 128 registers a thread: at M = 448 and
// 16 taps ptxas still spills 164 bytes, PERF.md). The two 32-row tiles
// take 512 M bytes: 229,376 at M = 448, inside the 232,448 a block may
// have, so every width up to 448 keeps them.
// At M = 64 P, P = 8 .. 16 (512 to 1024 channels) neither the two tiles
// nor a thread a channel fit (a block of M threads leaves 64 registers a
// thread at M = 1024, less than a channel's taps and ring), so one
// instance with P and M as run-time values (arm_fold_fft_rt_kernel) takes
// them: a block of kRtThreads threads walks its run of rows 16 at a time;
// for each 16 it folds every lane of the rows, a thread a lane at a time,
// its L taps and the 16 + L-1 input rows of the lane in registers (each
// input word loaded (16 + L-1)/16 times, the overlap from L2), the same
// chain as K7's; writes them as planes rows into one 16-row tile (128 KB
// at M = 1024); transforms it (planes_fft.cuh fft_tile_rt, the radix-P
// step in two passes and the 64-point FFTs) and writes it out as the FFT
// instance does. Its output is also fft_interleaved of K7's, bit for bit.
// Both keep the TPU kernel's HIGHEST accuracy (every product in FP32):
// bf16 passes left its DFT at 22 dB. The kernel takes no other width:
// the TPU kernel's dense (2M x 2M) product is no instance here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "planes_fft.cuh"

namespace {

// ---- K7 --------------------------------------------------------------------

constexpr int kFoldThreads = 64;  // threads of a K7 block

// The ring of L + kAhead rows: a load is issued kAhead steps before its row
// is first read, so each thread keeps kAhead 16-byte loads in flight.
template <int kL>
struct Ring {
  static constexpr int kAhead = kL < 8 ? 4 : kL / 2;
  static constexpr int kSlots = kL + kAhead;
};

// A block of G lane groups a row: gx groups side by side (the whole row
// where it fits in a block), ry runs stacked.
struct FoldGrid {
  int gx, ry;
};

__host__ __device__ constexpr FoldGrid fold_grid(int G) {
  return G >= kFoldThreads ? FoldGrid{kFoldThreads, 1}
                           : FoldGrid{G, kFoldThreads / G};
}

template <int kVec>
__device__ __forceinline__ void ld_lanes(float (&d)[kVec], const float* p) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void st_lanes(float* p, const float (&s)[kVec]) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  else if constexpr (kVec == 2)
    *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
  else
    *p = s[0];
}

// Rows [t0, t_end) of lanes k .. k+kVec-1: the ring, unrolled by its length.
template <int kL, int kVec, typename Load>
__device__ __forceinline__ void fold_run(const float* __restrict__ c2, int W,
                                         int k, long long t0, long long t_end,
                                         float* __restrict__ out,
                                         const Load& load) {
  constexpr int kS = Ring<kL>::kSlots;
  float tap[kL][kVec];
#pragma unroll
  for (int q = 0; q < kL; ++q) ld_lanes<kVec>(tap[q], c2 + q * W + k);
  float ring[kS][kVec];
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) load(ring[s], t0 + s);
  for (long long c = t0; c < t_end; c += kS) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      // row c + j + kS - 1 into the slot of row c + j - 1, read last step
      load(ring[(j + kS - 1) % kS], c + j + kS - 1);
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = tap[0][e] * ring[j][e];
#pragma unroll
      for (int q = 1; q < kL; ++q)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] = fmaf(tap[q][e], ring[(j + q) % kS][e], acc[e]);
      if (c + j < t_end) st_lanes<kVec>(out + (c + j) * W + k, acc);
    }
  }
}

// The generic instance for any other L: each output's L rows in turn.
template <int kVec, typename Load>
__device__ __forceinline__ void fold_run_any(const float* __restrict__ c2,
                                             int W, int L, int k, long long t0,
                                             long long t_end,
                                             float* __restrict__ out,
                                             const Load& load) {
  for (long long t = t0; t < t_end; ++t) {
    float acc[kVec], x[kVec], c[kVec];
    load(x, t);
    ld_lanes<kVec>(c, c2 + k);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = c[e] * x[e];
    for (int q = 1; q < L; ++q) {
      load(x, t + q);
      ld_lanes<kVec>(c, c2 + q * W + k);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(c[e], x[e], acc[e]);
    }
    st_lanes<kVec>(out + t * W + k, acc);
  }
}

// K7: block (bx, by) holds runs bx*ry .. bx*ry + ry-1 of lane groups
// by*gx .. by*gx + gx-1. kWidth, kL: the width and tap count when nonzero (else
// the arguments w, l); kVec: lanes a thread.
template <int kWidth, int kL, int kVec>
__global__ void __launch_bounds__(kFoldThreads)
arm_fold_kernel(const float* __restrict__ v, long long n_in,
                const float* __restrict__ c2, float* __restrict__ out,
                long long n_out, int w, int l, int R) {
  const int W = kWidth ? kWidth : w;
  const int L = kL ? kL : l;
  const FoldGrid fg = fold_grid(W / kVec);
  const int tx = threadIdx.x % fg.gx, ty = threadIdx.x / fg.gx;
  const int k = (blockIdx.y * fg.gx + tx) * kVec;  // the thread's first lane
  const long long t0 = ((long long)blockIdx.x * fg.ry + ty) * R;
  if (k >= W || t0 >= n_out) return;
  const long long t_end = min(t0 + R, n_out);
  const long long r_end = min(t_end + L - 1, n_in);  // rows this run reads
  const auto load = [&](float (&d)[kVec], long long r) {
    if (r < r_end) {
      ld_lanes<kVec>(d, v + r * W + k);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    }
  };
  if constexpr (kL > 0)
    fold_run<kL, kVec>(c2, W, k, t0, t_end, out, load);
  else
    fold_run_any<kVec>(c2, W, L, k, t0, t_end, out, load);
}

using FoldKernel = void (*)(const float*, long long, const float*, float*,
                            long long, int, int, int);

template <int kWidth, int kVec>
FoldKernel fold_instance(int L) {
  switch (L) {
    case 4: return arm_fold_kernel<kWidth, 4, kVec>;
    case 8: return arm_fold_kernel<kWidth, 8, kVec>;
    case 16: return arm_fold_kernel<kWidth, 16, kVec>;
    default: return arm_fold_kernel<kWidth, 0, kVec>;
  }
}

// Blocks of a K7 instance at `threads` a block that one SM of the current
// device holds, and the device's SMs: the occupancy calculator, asked once
// per instance, block size and device.
int resident_blocks(FoldKernel fn, int threads, int& blocks, int& sms) {
  static std::mutex mu;
  static std::map<std::tuple<uintptr_t, int, int>, std::pair<int, int>> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<uintptr_t>(fn), threads, dev);
  auto it = seen.find(key);
  if (it == seen.end()) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                          threads, 0);
    if (err != cudaSuccess) return (int)err;
    it = seen.emplace(key, std::make_pair(blocks, sms)).first;
  }
  blocks = it->second.first;
  sms = it->second.second;
  return 0;
}

// One K7 launch: its instance, lanes a thread, rows a run and grid. T: rows
// a block, or 0: one wave (as many runs as the card holds at once, each as
// long as that makes it). The pointers decide the lanes' width (16-byte
// words need 16-byte alignment).
struct FoldPlan {
  FoldKernel fn;
  int vec, R;
  dim3 grid, block;
};

int fold_plan(uintptr_t ptrs, int W, int L, int T, long long n_out,
              FoldPlan& p) {
  if (W < 1 || L < 1 || T < 0 || n_out < 0) return (int)cudaErrorInvalidValue;
  p.vec = W % 4 == 0 && ptrs % 16 == 0 ? 4 : W % 2 == 0 && ptrs % 8 == 0 ? 2 : 1;
  if (p.vec == 4) {
    switch (W) {  // the flagship's 128 lanes, and M = 128, 256 channels
      case 128: p.fn = fold_instance<128, 4>(L); break;
      case 256: p.fn = fold_instance<256, 4>(L); break;
      case 512: p.fn = fold_instance<512, 4>(L); break;
      default: p.fn = fold_instance<0, 4>(L);
    }
  } else {
    p.fn = p.vec == 2 ? fold_instance<0, 2>(L) : fold_instance<0, 1>(L);
  }
  const int G = W / p.vec;
  const FoldGrid g = fold_grid(G);
  const int lane_blocks = (G + g.gx - 1) / g.gx;
  p.block = dim3(g.gx * g.ry);
  if (T > 0) {
    p.R = T / g.ry > 0 ? T / g.ry : 1;
  } else {
    int blocks = 0, sms = 0;
    const int err = resident_blocks(p.fn, (int)p.block.x, blocks, sms);
    if (err) return err;
    const long long wave_runs =
        (long long)g.ry * std::max(1, blocks * sms / lane_blocks);
    p.R = (int)std::max(1LL, (n_out + wave_runs - 1) / wave_runs);
  }
  const long long runs = (n_out + p.R - 1) / p.R;
  p.grid = dim3((unsigned)((runs + g.ry - 1) / g.ry), lane_blocks);
  return 0;
}

// ---- K1, the FFT instance ---------------------------------------------------

// Rows a group of an M-channel K1 block folds between two transforms of
// the block's 32-row tile, the block's threads, and the ring of the fold
// at kL taps: L + kAhead rows, kAhead >= kL/2 (4 at kL = 4), rounded up to
// a multiple of the step so that every step's end is a constant place of
// the unrolled loop (24 rows at M = 64, 16 taps; 32 at M >= 128).
template <int M, int kL>
struct FftFold {
  static constexpr int kG = M <= 128 ? 256 / M : 1;  // groups a block
  static constexpr int kThreads = M * kG;
  static constexpr int kS = 32 / kG;                 // rows a step
  static constexpr int kTileRows = 32;
  static constexpr int kMin = kL + (kL < 8 ? 4 : kL / 2);
  static constexpr int kSlots = kL ? (kMin + kS - 1) / kS * kS : kS;
};

// Block b, group g folds rows [(b G + g) R, +R) of its channel q in
// registers (kL > 0: K7's ring; 0: any L, each output's rows in turn),
// R a multiple of kSlots, into the tile, kS rows a step; each full tile is
// transformed and written.
template <int M, int kL>
__global__ void __launch_bounds__(FftFold<M, kL>::kThreads)
arm_fold_fft_kernel(const float* __restrict__ v, long long n_in,
                    const float* __restrict__ c2,
                    const float* __restrict__ tab, float* __restrict__ out,
                    long long n_out, int l, int R) {
  using F = FftFold<M, kL>;
  constexpr int W = 2 * M, P = M / 64, kS = F::kS, kSl = F::kSlots;
  extern __shared__ __align__(16) float sm[];  // two tiles of 32 x W
  const int L = kL ? kL : l;
  const int tid = threadIdx.x, q = tid % M, g = tid / M;
  const int k = 2 * q;
  const long long run0 = (long long)blockIdx.x * F::kG * R;
  const long long t0 = run0 + (long long)g * R;
  const long long r_end = min(t0 + R + L - 1, n_in);  // rows this run reads
  const auto load = [&](float (&d)[2], long long r) {
    if (r < r_end) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(v + r * W + k));
      d[0] = x.x, d[1] = x.y;
    } else {
      d[0] = d[1] = 0.f;
    }
  };
  // row i of step `step` into its tile (the tiles alternate by step)
  const auto put = [&](int step, int i, const float (&acc)[2]) {
    float* b = sm + (step & 1) * F::kTileRows * W;
    const int slot = g * kS + i;
    b[slot * W + planes_fft::sw(slot, q)] = acc[0];
    b[slot * W + M + planes_fft::sw(slot, q)] = acc[1];
  };
  // the step's tile is full: transform it, write its rows
  const auto flush = [&](int step) {
    float* b = sm + (step & 1) * F::kTileRows * W;
    __syncthreads();
    if constexpr (P <= 4) {
      const planes_fft::Tw<P> tw(tab, tid & 7);
      for (int base = 4 * (tid >> 5); base < F::kTileRows;
           base += F::kThreads / 8) {
        const int r = base + ((tid >> 3) & 3);
        planes_fft::fft_row<P>(b + r * W, r, tid & 7, tw, tab);
      }
    } else {
      planes_fft::fft_tile_wide<P>(b, F::kTileRows, tid, F::kThreads, tab);
    }
    __syncthreads();
    for (int e = tid; e < F::kTileRows * (M / 2); e += F::kThreads) {
      const int j = e / (M / 2), qq = 2 * (e % (M / 2));
      const long long t = run0 + (long long)(j / kS) * R + step * kS + j % kS;
      if (t < n_out) {
        const float* row = b + j * W;
        int i0, i1;  // where the transform left channels qq, qq + 1
        if constexpr (P <= 4) {
          i0 = planes_fft::sw(j, qq), i1 = planes_fft::sw(j, qq + 1);
        } else {
          i0 = planes_fft::sw(j, planes_fft::wide_lane<P>(qq));
          i1 = planes_fft::sw(j, planes_fft::wide_lane<P>(qq + 1));
        }
        *reinterpret_cast<float4*>(out + t * W + 2 * qq) =
            make_float4(row[i0], row[M + i0], row[i1], row[M + i1]);
      }
    }
  };
  int step = 0;
  if constexpr (kL > 0) {
    float tap[kL][2];
#pragma unroll
    for (int qq = 0; qq < kL; ++qq) {
      const float2 c = __ldg(reinterpret_cast<const float2*>(c2 + qq * W + k));
      tap[qq][0] = c.x, tap[qq][1] = c.y;
    }
    float ring[kSl][2];
#pragma unroll
    for (int s = 0; s < kSl - 1; ++s) load(ring[s], t0 + s);
    for (long long c = t0; c < t0 + R; c += kSl) {
#pragma unroll
      for (int j = 0; j < kSl; ++j) {
        // row c + j + kSl - 1 into the slot of row c + j - 1, read last step
        load(ring[(j + kSl - 1) % kSl], c + j + kSl - 1);
        float acc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[e] = tap[0][e] * ring[j][e];
#pragma unroll
        for (int qq = 1; qq < kL; ++qq)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[e] = fmaf(tap[qq][e], ring[(j + qq) % kSl][e], acc[e]);
        put(step, j % kS, acc);
        if (j % kS == kS - 1) flush(step++);
      }
    }
  } else {
    for (long long c = t0; c < t0 + R; c += kS) {
      for (int i = 0; i < kS; ++i) {
        const long long t = c + i;
        float acc[2], x[2];
        load(x, t);
        const float2 c0 = __ldg(reinterpret_cast<const float2*>(c2 + k));
        acc[0] = c0.x * x[0], acc[1] = c0.y * x[1];
        for (int qq = 1; qq < L; ++qq) {
          load(x, t + qq);
          const float2 cq =
              __ldg(reinterpret_cast<const float2*>(c2 + qq * W + k));
          acc[0] = fmaf(cq.x, x[0], acc[0]);
          acc[1] = fmaf(cq.y, x[1], acc[1]);
        }
        put(step, i, acc);
      }
      flush(step++);
    }
  }
}

using FftFoldKernel = void (*)(const float*, long long, const float*,
                               const float*, float*, long long, int, int);

template <int M>
FftFoldKernel fft_fold_instance(int L) {
  switch (L) {
    case 4: return arm_fold_fft_kernel<M, 4>;
    case 8: return arm_fold_fft_kernel<M, 8>;
    case 16: return arm_fold_fft_kernel<M, 16>;
    default: return arm_fold_fft_kernel<M, 0>;
  }
}

// The ring's rows at L taps: a run is a whole number of them.
template <int M>
int fold_fft_slots(int L) {
  switch (L) {
    case 4: return FftFold<M, 4>::kSlots;
    case 8: return FftFold<M, 8>::kSlots;
    case 16: return FftFold<M, 16>::kSlots;
    default: return FftFold<M, 0>::kSlots;
  }
}

// One K1 FFT-instance launch: rows a run R (the hint, or one wave of the
// card's resident blocks, rounded up to whole rings), its shared memory,
// its grid.
template <int M>
int launch_fold_fft(const float* v, long long n_in, const float* c2,
                    const float* tab, float* out, long long n_out, int L,
                    int R, cudaStream_t stream) {
  using F = FftFold<M, 0>;  // the block's shape, the same at every L
  const FftFoldKernel fn = fft_fold_instance<M>(L);
  const int unit = fold_fft_slots<M>(L);  // R a whole number of rings
  const size_t smem = (size_t)2 * F::kTileRows * 2 * M * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) {
    int dev = 0, sms = 0, blocks = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                          F::kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long runs = (long long)F::kG * std::max(1, blocks * sms);
    R = (int)std::max(1LL, (n_out + runs - 1) / runs);
  }
  R = (R + unit - 1) / unit * unit;
  const long long per_block = (long long)F::kG * R;
  const unsigned grid =
      (unsigned)std::max(1LL, (n_out + per_block - 1) / per_block);
  fn<<<grid, F::kThreads, smem, stream>>>(v, n_in, c2, tab, out, n_out, L, R);
  return (int)cudaGetLastError();
}

// ---- K1 at M = 512 .. 1024 (P and M at run time) ---------------------------

constexpr int kRtThreads = 512;  // threads of a block
constexpr int kRtRows = 16;      // rows a pass: the tile, and a lane's fold

// Block b walks rows [b R, b R + R) of the output, R a multiple of
// kRtRows, a pass of kRtRows rows at a time: the fold of every lane k into
// the tile (planes row e, lane k's channel k/2 in the re half at even k,
// the im half at odd), the transform, the rows out (two channels a 16-byte
// store; by lane instead, 8 bytes a store, it measured slower on the H100).
// kL = 16: a lane's taps and 16 + kL-1 input rows in registers;
// kL = 0: any L, each output's rows and taps loaded in turn. Both sum
// K7's chain: c2[0] v[t], then fmaf for q = 1 .. L-1.
template <int kL>
__global__ void __launch_bounds__(kRtThreads)
arm_fold_fft_rt_kernel(const float* __restrict__ v, long long n_in,
                       const float* __restrict__ c2,
                       const float* __restrict__ tab, float* __restrict__ out,
                       long long n_out, int M, int l, int R) {
  extern __shared__ __align__(16) float tile[];  // kRtRows x 2M
  __shared__ planes_fft::PlanTabs tb;
  const planes_fft::Plan pl = planes_fft::plan_of(M / 64);
  const int W = 2 * M, L = kL ? kL : l, tid = threadIdx.x;
  planes_fft::fill_tabs(tb, pl, tid);
  const long long run0 = (long long)blockIdx.x * R;
  const long long run1 = min(run0 + R, n_out);
  for (long long t0 = run0; t0 < run1; t0 += kRtRows) {
    for (int k = tid; k < W; k += kRtThreads) {
      const int q = k >> 1;
      float* col = tile + (k & 1) * M;
      if constexpr (kL > 0) {
        float c[kL], x[kRtRows + kL - 1];
#pragma unroll
        for (int i = 0; i < kL; ++i) c[i] = __ldg(c2 + i * W + k);
#pragma unroll
        for (int i = 0; i < kRtRows + kL - 1; ++i)
          x[i] = t0 + i < n_in ? __ldg(v + (t0 + i) * W + k) : 0.f;
#pragma unroll
        for (int e = 0; e < kRtRows; ++e) {
          float acc = c[0] * x[e];
#pragma unroll
          for (int i = 1; i < kL; ++i) acc = fmaf(c[i], x[e + i], acc);
          col[e * W + planes_fft::sw(e, q)] = acc;
        }
      } else {
        for (int e = 0; e < kRtRows; ++e) {
          float acc = 0.f;
          for (int i = 0; i < L; ++i) {
            const long long r = t0 + e + i;
            const float x = r < n_in ? __ldg(v + r * W + k) : 0.f;
            acc = i ? fmaf(__ldg(c2 + i * W + k), x, acc) : __ldg(c2 + k) * x;
          }
          col[e * W + planes_fft::sw(e, q)] = acc;
        }
      }
    }
    __syncthreads();
    planes_fft::fft_tile_rt(tile, kRtRows, tid, kRtThreads, tab, pl, tb);
    __syncthreads();
    for (int e = tid; e < kRtRows * (M / 2); e += kRtThreads) {
      const int j = e / (M / 2), qq = 2 * (e % (M / 2));
      const long long t = t0 + j;
      if (t < n_out) {
        const float* row = tile + j * W;
        const int i0 = planes_fft::sw(j, pl.lane(qq));
        const int i1 = planes_fft::sw(j, pl.lane(qq + 1));
        *reinterpret_cast<float4*>(out + t * W + 2 * qq) =
            make_float4(row[i0], row[M + i0], row[i1], row[M + i1]);
      }
    }
    __syncthreads();
  }
}

// One launch of the run-time instance: R rows a block (the hint rounded up
// to whole passes, or one wave of the card's resident blocks).
int launch_fold_fft_rt(const float* v, long long n_in, const float* c2,
                       const float* tab, float* out, long long n_out, int M,
                       int L, int R, cudaStream_t stream) {
  const auto fn = L == 16 ? arm_fold_fft_rt_kernel<16> : arm_fold_fft_rt_kernel<0>;
  const size_t smem = (size_t)kRtRows * 2 * M * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) {
    int dev = 0, sms = 0, blocks = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                          kRtThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long wave = std::max(1, blocks * sms);
    R = (int)std::max(1LL, (n_out + wave - 1) / wave);
  }
  R = (R + kRtRows - 1) / kRtRows * kRtRows;
  const unsigned grid = (unsigned)std::max(1LL, (n_out + R - 1) / R);
  fn<<<grid, kRtThreads, smem, stream>>>(v, n_in, c2, tab, out, n_out, M, L, R);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 (M = 64 P, P = 1 .. 16): tab the (4, M) table of planes_fft_table;
// R rows a run of each group (P <= 7) or block (0: one wave).
extern "C" int arm_fold_fft_launch(const float* v, long long n_in,
                                   const float* c2, const float* tab,
                                   float* out, long long n_out, int M, int L,
                                   int R, void* stream) {
  if (L < 1 || R < 0 || n_out < 0 ||
      (((uintptr_t)v | (uintptr_t)c2) & 7) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 64: return launch_fold_fft<64>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 128: return launch_fold_fft<128>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 192: return launch_fold_fft<192>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 256: return launch_fold_fft<256>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 320: return launch_fold_fft<320>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 384: return launch_fold_fft<384>(v, n_in, c2, tab, out, n_out, L, R, s);
    case 448: return launch_fold_fft<448>(v, n_in, c2, tab, out, n_out, L, R, s);
    default:
      if (M % 64 || M / 64 < 8 || M / 64 > 16) return (int)cudaErrorInvalidValue;
      return launch_fold_fft_rt(v, n_in, c2, tab, out, n_out, M, L, R, s);
  }
}

// T: rows a block (0: one wave, see fold_plan).
extern "C" int arm_fold_launch(const float* v, long long n_in, const float* c2,
                               float* out, long long n_out, int W, int L,
                               int T, void* stream) {
  FoldPlan p;
  const int err = fold_plan((uintptr_t)v | (uintptr_t)c2 | (uintptr_t)out, W,
                            L, T, n_out, p);
  if (err) return err;
  p.fn<<<p.grid, p.block, 0, (cudaStream_t)stream>>>(v, n_in, c2, out, n_out,
                                                     W, L, p.R);
  return (int)cudaGetLastError();
}

// The geometry K7 takes for (W, L, T) and n_out rows on aligned tensors,
// for the fold probe (newsched_tpu_torch/probes/run.py): info = {blocks an
// SM can hold, threads a block, rows a run, lanes a thread, registers a
// thread}.
extern "C" int arm_fold_geometry(int W, int L, int T, long long n_out,
                                 int* info) {
  FoldPlan p;
  int err = fold_plan(0, W, L, T, n_out, p);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, p.fn, (int)p.block.x, 0);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, p.fn);
  if (err) return err;
  const int vals[5] = {blocks, (int)p.block.x, p.R, p.vec, attr.numRegs};
  for (int i = 0; i < 5; ++i) info[i] = vals[i];
  return 0;
}
