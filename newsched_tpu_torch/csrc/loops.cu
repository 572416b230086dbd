// S1 costas_loop and S2 clock_recovery_mm for Hopper (sm_90a): the
// digital receiver's carrier and symbol-timing feedback loops.
//
// Neither has a TPU kernel. Each replaces a per-sample `lax.scan` of the
// reference: newsched_tpu/ops/loops.py `costas_loop` (the scan at :121)
// and `clock_recovery_mm` (the scan at :218). Both loops are nonlinear
// (each step decides on the previous corrected output), so there is no
// associative form: a stream is one serial chain of dependent
// instructions, and the only parallelism is across streams.
//
// What bounds them on the H100 is that chain, not bytes: S1 moves 16 bytes
// a sample and S2 8 a sample plus 8 a symbol, 2.4-4.8 ns a sample at
// 3.35 TB/s for ONE stream only if the card had one stream's worth of
// bandwidth; per step the chain is sincosf, a complex product, the
// detector, the two clamps and the phase wrap (S1) or the interpolation,
// slicer, timing error and the floor (S2), some hundreds of cycles of
// latency. So the design keeps everything off that chain but the
// arithmetic:
//   - one thread a stream, 32 streams a block (one warp): C = 1 runs one
//     thread, C = 64 two blocks;
//   - S1 stages its streams' samples in chunks of 64 through shared
//     memory with cp.async, the next chunk in flight while the current
//     one runs, so the loop never waits on device memory;
//   - S2 reads a window [hist | x] at a position that only its own loop
//     knows. It runs in chunks of `chunk_steps` symbols, each reading a
//     slice of 256 window samples a stream staged by cp.async while the
//     chunk before it ran: from the position that chunk started at plus
//     chunk_steps * sps, less a margin of 16 (the position moves forward
//     by about sps a symbol for the reference's gains). A read outside the
//     staged slice falls back to device memory, so any gain stays correct;
//   - a stream's row in shared memory has an odd stride in 8-byte words,
//     so the warp's 32 reads of a step hit 32 distinct banks; the outputs
//     go to shared memory too, and leave at the end of a chunk in
//     coalesced stores;
//   - every multiply and add is a separately rounded __fmul_rn/__fadd_rn
//     in the reference's order (no FMA contraction), `rintf` rounds half
//     to even as jnp.round does, `floorf` as jnp.floor. S1's sincosf is
//     the accurate one (not __sincosf); that is where it differs from the
//     plain version's torch sin/cos.
// The loop gains come from the card when the wrapper passes a pointer
// (the blocks' settable parameters), else from the host values.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStreams = 32;      // streams a block, one per thread
constexpr int kChunk = 64;        // S1: samples of a stream staged a round
constexpr int kSlice = 256;       // S2: window samples of a stream a chunk
constexpr int kMargin = 16;       // S2: a slice starts this far before the
                                  // predicted read position
// A stream's row in shared memory is one float2 longer than its samples:
// an odd stride in 8-byte words, so the 32 lanes reading the same step of
// their 32 rows hit distinct banks.
constexpr int kChunkStride = kChunk + 1;
constexpr int kSliceStride = kSlice + 1;
constexpr int kMaxChunkSteps = 64;  // S2: symbols a chunk, at most
constexpr int kYStride = kMaxChunkSteps + 1;

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The detector of an order-2, 4 or 8 PSK loop (reference `_costas_error`).
template <int ORDER>
__device__ __forceinline__ float costas_error(float re, float im, float k8) {
  const float sre = re >= 0.f ? 1.f : -1.f;
  const float sim = im >= 0.f ? 1.f : -1.f;
  if (ORDER == 2) return __fmul_rn(re, im);
  if (ORDER == 4) return __fsub_rn(__fmul_rn(sre, im), __fmul_rn(sim, re));
  if (fabsf(re) >= fabsf(im))
    return __fsub_rn(__fmul_rn(sre, im), __fmul_rn(__fmul_rn(sim, re), k8));
  return __fsub_rn(__fmul_rn(__fmul_rn(sre, im), k8), __fmul_rn(sim, re));
}

// Chunk `k` of the block's streams into buf (kStreams x kChunk samples).
__device__ __forceinline__ void costas_stage(float2 (*buf)[kChunkStride],
                                             const float2* __restrict__ x,
                                             int c0, int nst, long long N,
                                             long long k) {
  const long long n0 = k * kChunk;
  const int len = (int)min((long long)kChunk, N - n0);
  for (int j = 0; j < nst; ++j) {
    const float2* src = x + (long long)(c0 + j) * N + n0;
    for (int i = threadIdx.x; i < len; i += kStreams)
      cp_async8(&buf[j][i], src + i);
  }
}

template <int ORDER>
__global__ void __launch_bounds__(kStreams)
    costas_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float* __restrict__ phase_in,
                  const float* __restrict__ freq_in,
                  float* __restrict__ phase_out, float* __restrict__ freq_out,
                  const float* __restrict__ bw_ptr, float alpha, float beta,
                  float maxf, float damping, float k8, float two_pi, int C,
                  long long N) {
  __shared__ __align__(16) float2 buf[2][kStreams][kChunkStride];  // 33 KB
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kStreams;
  const int nst = min(kStreams, C - c0);
  const bool live = lane < nst;
  const int c = c0 + lane;
  if (bw_ptr != nullptr) {
    // the reference's float32 design of a traced loop_bw
    const float bw = *bw_ptr;
    const float denom =
        __fadd_rn(__fadd_rn(1.f, __fmul_rn(__fmul_rn(2.f, damping), bw)),
                  __fmul_rn(bw, bw));
    alpha = __fdiv_rn(__fmul_rn(__fmul_rn(4.f, damping), bw), denom);
    beta = __fdiv_rn(__fmul_rn(__fmul_rn(4.f, bw), bw), denom);
  }
  float phase = live ? phase_in[c] : 0.f;
  float freq = live ? freq_in[c] : 0.f;
  const long long nchunks = (N + kChunk - 1) / kChunk;
  costas_stage(buf[0], x, c0, nst, N, 0);
  cp_async_commit();
  for (long long k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) costas_stage(buf[(k + 1) & 1], x, c0, nst, N, k + 1);
    cp_async_commit();
    cp_async_wait1();  // chunk k has landed (every group but the newest)
    __syncwarp();
    const long long n0 = k * kChunk;
    const int len = (int)min((long long)kChunk, N - n0);
    if (live) {
      float2* row = buf[k & 1][lane];  // each output replaces its input
      for (int i = 0; i < len; ++i) {
        float s, co;
        sincosf(-phase, &s, &co);
        const float2 v = row[i];
        const float re = __fsub_rn(__fmul_rn(v.x, co), __fmul_rn(v.y, s));
        const float im = __fadd_rn(__fmul_rn(v.x, s), __fmul_rn(v.y, co));
        row[i] = make_float2(re, im);
        const float e = clampf(costas_error<ORDER>(re, im, k8), -1.f, 1.f);
        freq = clampf(__fadd_rn(freq, __fmul_rn(beta, e)), -maxf, maxf);
        const float p = __fadd_rn(__fadd_rn(phase, freq), __fmul_rn(alpha, e));
        phase = __fsub_rn(p, __fmul_rn(two_pi, rintf(__fdiv_rn(p, two_pi))));
      }
    }
    __syncwarp();
    // the chunk's outputs leave row by row, in coalesced stores
    for (int j = 0; j < nst; ++j) {
      float2* yrow = y + (long long)(c0 + j) * N + n0;
      for (int i = lane; i < len; i += kStreams) yrow[i] = buf[k & 1][j][i];
    }
    __syncwarp();  // buf[k & 1] is refilled with chunk k + 2 next round
  }
  if (live) {
    phase_out[c] = phase;
    freq_out[c] = freq;
  }
}

// window[i] of [hist | x] for stream c (hist H samples, x N samples)
__device__ __forceinline__ const float2* window_ptr(
    const float2* __restrict__ hist, const float2* __restrict__ x, int c,
    int H, long long N, long long i) {
  return i < H ? hist + (long long)c * H + i : x + (long long)c * N + (i - H);
}

// Each stream's slice window[base_j, base_j + kSlice) into dst, base_j
// lane j's `base`, by cp.async: the copies of every stream are in flight
// at once.
__device__ __forceinline__ void mm_stage(float2* dst,
                                         const float2* __restrict__ hist,
                                         const float2* __restrict__ x, int c0,
                                         int nst, int H, long long N,
                                         long long wlen, long long base) {
  for (int j = 0; j < nst; ++j) {
    const long long bj = __shfl_sync(0xffffffffu, base, j);
    for (int i = threadIdx.x; i < kSlice && bj + i < wlen; i += kStreams)
      cp_async8(dst + j * kSliceStride + i,
                window_ptr(hist, x, c0 + j, H, N, bj + i));
  }
}

__global__ void __launch_bounds__(kStreams)
    mm_kernel(const float2* __restrict__ x, const float2* __restrict__ hist,
              const long long* __restrict__ pos_in,
              const float* __restrict__ mu_in,
              const float* __restrict__ om_in,
              const float2* __restrict__ p1_in,
              const float2* __restrict__ p2_in,
              const float2* __restrict__ c1_in,
              const float2* __restrict__ c2_in, float2* __restrict__ y,
              long long* __restrict__ pos_out, float* __restrict__ mu_out,
              float* __restrict__ om_out, float2* __restrict__ p1_out,
              float2* __restrict__ p2_out, float2* __restrict__ c1_out,
              float2* __restrict__ c2_out, const float* __restrict__ g_om_ptr,
              const float* __restrict__ g_mu_ptr, float g_om, float g_mu,
              float om_mid, float om_lim, int sps, int C, long long N, int H,
              int chunk_steps) {
  extern __shared__ __align__(16) float2 slices[];  // 2 x kStreams rows
  float2* ybuf = slices + 2 * kStreams * kSliceStride;  // kStreams x kYStride
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kStreams;
  const int nst = min(kStreams, C - c0);
  const bool live = lane < nst;
  const int c = c0 + lane;
  if (g_om_ptr != nullptr) g_om = *g_om_ptr;
  if (g_mu_ptr != nullptr) g_mu = *g_mu_ptr;
  const long long wlen = (long long)H + N;
  const long long nout = N / sps;
  long long pos = live ? pos_in[c] : 0;
  float mu = live ? mu_in[c] : 0.f, om = live ? om_in[c] : 0.f;
  float2 p1 = live ? p1_in[c] : make_float2(0.f, 0.f);
  float2 p2 = live ? p2_in[c] : make_float2(0.f, 0.f);
  float2 c1 = live ? c1_in[c] : make_float2(0.f, 0.f);
  float2 c2 = live ? c2_in[c] : make_float2(0.f, 0.f);
  // chunk 0's slice starts at the read position itself (clamped as
  // dynamic_slice clamps a start into the window); a later chunk's at the
  // position the chunk before it predicts at the nominal sps, kMargin
  // earlier, staged while that chunk runs
  long long base = min(max(pos, 0LL), wlen - 2);
  mm_stage(slices, hist, x, c0, nst, H, N, wlen, base);
  cp_async_commit();
  for (long long k0 = 0, it = 0; k0 < nout; k0 += chunk_steps, ++it) {
    const long long next = min(
        max(pos + (long long)chunk_steps * sps - kMargin, 0LL), wlen - 2);
    if (k0 + chunk_steps < nout)
      mm_stage(slices + ((it + 1) & 1) * kStreams * kSliceStride, hist, x, c0,
               nst, H, N, wlen, next);
    cp_async_commit();
    cp_async_wait1();  // this chunk's slices have landed
    __syncwarp();
    const float2* mine =
        slices + (it & 1) * kStreams * kSliceStride + lane * kSliceStride;
    const long long k1 = live ? min(nout, k0 + chunk_steps) : k0;
    for (long long k = k0; k < k1; ++k) {
      const long long i0 = min(max(pos, 0LL), wlen - 2);
      const long long off = i0 - base;
      float2 a0, a1;
      if (off >= 0 && off + 1 < kSlice) {
        a0 = mine[off];
        a1 = mine[off + 1];
      } else {  // outside the staged slice: device memory
        a0 = *window_ptr(hist, x, c, H, N, i0);
        a1 = *window_ptr(hist, x, c, H, N, i0 + 1);
      }
      const float p0r = __fadd_rn(a0.x, __fmul_rn(__fsub_rn(a1.x, a0.x), mu));
      const float p0i = __fadd_rn(a0.y, __fmul_rn(__fsub_rn(a1.y, a0.y), mu));
      const float c0r = p0r >= 0.f ? 1.f : -1.f;
      const float c0i = p0i >= 0.f ? 1.f : -1.f;
      // e = Re{(p0 - p2) conj(c1) - (c0 - c2) conj(p1)}, clipped
      const float d1r = __fsub_rn(p0r, p2.x), d1i = __fsub_rn(p0i, p2.y);
      const float d2r = __fsub_rn(c0r, c2.x), d2i = __fsub_rn(c0i, c2.y);
      const float ua = __fadd_rn(__fmul_rn(d1r, c1.x), __fmul_rn(d1i, c1.y));
      const float ub = __fadd_rn(__fmul_rn(d2r, p1.x), __fmul_rn(d2i, p1.y));
      const float e = clampf(__fsub_rn(ua, ub), -1.f, 1.f);
      om = __fadd_rn(om_mid,
                     clampf(__fsub_rn(__fadd_rn(om, __fmul_rn(g_om, e)), om_mid),
                            -om_lim, om_lim));
      const float step = __fadd_rn(__fadd_rn(mu, om), __fmul_rn(g_mu, e));
      const float ip = floorf(step);
      mu = __fsub_rn(step, ip);
      pos += (long long)ip;
      ybuf[lane * kYStride + (k - k0)] = make_float2(p0r, p0i);
      p2 = p1;
      p1 = make_float2(p0r, p0i);
      c2 = c1;
      c1 = make_float2(c0r, c0i);
    }
    __syncwarp();
    // the chunk's symbols leave row by row, in coalesced stores
    const int len = (int)(min(nout, k0 + chunk_steps) - k0);
    for (int j = 0; j < nst; ++j) {
      float2* yrow = y + (long long)(c0 + j) * nout + k0;
      for (int i = lane; i < len; i += kStreams) yrow[i] = ybuf[j * kYStride + i];
    }
    __syncwarp();  // the slices are refilled with the chunk after next
    base = next;
  }
  if (live) {
    // rebase for the next batch, whose window is [window[-H:] | next x]
    pos_out[c] = min(max(pos - (wlen - H), 0LL), 2LL * H);
    mu_out[c] = mu;
    om_out[c] = om;
    p1_out[c] = p1;
    p2_out[c] = p2;
    c1_out[c] = c1;
    c2_out[c] = c2;
  }
}

}  // namespace

extern "C" int costas_launch(const float2* x, float2* y, const float* phase_in,
                             const float* freq_in, float* phase_out,
                             float* freq_out, const float* bw, float alpha,
                             float beta, float maxf, float damping, float k8,
                             float two_pi, int order, int C, long long N,
                             void* stream) {
  if (C <= 0 || N < 0 || (order != 2 && order != 4 && order != 8))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kStreams - 1) / kStreams);
  const cudaStream_t st = (cudaStream_t)stream;
  if (order == 2)
    costas_kernel<2><<<grid, kStreams, 0, st>>>(
        x, y, phase_in, freq_in, phase_out, freq_out, bw, alpha, beta, maxf,
        damping, k8, two_pi, C, N);
  else if (order == 4)
    costas_kernel<4><<<grid, kStreams, 0, st>>>(
        x, y, phase_in, freq_in, phase_out, freq_out, bw, alpha, beta, maxf,
        damping, k8, two_pi, C, N);
  else
    costas_kernel<8><<<grid, kStreams, 0, st>>>(
        x, y, phase_in, freq_in, phase_out, freq_out, bw, alpha, beta, maxf,
        damping, k8, two_pi, C, N);
  return (int)cudaGetLastError();
}

extern "C" int mm_launch(const float2* x, const float2* hist,
                         const long long* pos_in, const float* mu_in,
                         const float* om_in, const float2* p1_in,
                         const float2* p2_in, const float2* c1_in,
                         const float2* c2_in, float2* y, long long* pos_out,
                         float* mu_out, float* om_out, float2* p1_out,
                         float2* p2_out, float2* c1_out, float2* c2_out,
                         const float* g_om_ptr, const float* g_mu_ptr,
                         float g_om, float g_mu, float om_mid, float om_lim,
                         int sps, int C, long long N, int H, int chunk_steps,
                         void* stream) {
  if (C <= 0 || N < 0 || sps <= 0 || H < 2 || chunk_steps <= 0 ||
      chunk_steps > kMaxChunkSteps)
    return (int)cudaErrorInvalidValue;
  // two slice buffers and the symbols' buffer, 146 KB
  const int smem =
      (2 * kSliceStride + kYStride) * kStreams * (int)sizeof(float2);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((C + kStreams - 1) / kStreams);
  mm_kernel<<<grid, kStreams, smem, (cudaStream_t)stream>>>(
      x, hist, pos_in, mu_in, om_in, p1_in, p2_in, c1_in, c2_in, y, pos_out,
      mu_out, om_out, p1_out, p2_out, c1_out, c2_out, g_om_ptr, g_mu_ptr, g_om,
      g_mu, om_mid, om_lim, sps, C, N, H, chunk_steps);
  return (int)cudaGetLastError();
}
