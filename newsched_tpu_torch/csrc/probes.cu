// The bench probes, for Hopper (sm_90a): H100 counterparts of the TPU
// probe kernels under bench/, answering their questions at shapes that fit
// this card.
//
// window_copy replaces bench/exp_dma.py `kern` (a double-buffered and a
// single-slot HBM->VMEM window copy over a tile sweep), bench/exp_dma64.py
// `kern` (re and im as two 64-lane planes against one 128-lane window),
// bench/exp_dma2.py `kern` (a per-row copy at 128-1024 lanes) and `kern2`
// (the auto-pipelined BlockSpec read of a (T, 512) tile). planes_unpack
// replaces bench/exp_prep.py `rk` (can a kernel unpack the packed stream
// itself, deleting the prep pass). The third probe, K3 with stages
// switched off (bench/exp_ablate.py), is fm_chain.cu's
// fm_chain_ablate_kernel.
//
// window_copy: tile t of the input is the window of rows [t*T, t*T + T + H)
// (H rows of halo, as K3's window has); block b walks tiles b*G .. b*G+G-1
// in order. Staged variants copy each window into shared memory with
// cp.async (16 bytes a thread and copy); the double-buffered one issues
// tile t+1's copies before it waits on tile t, the single-slot one issues
// and waits on each in turn. The direct variant stages nothing: each thread
// reads its 16-byte words of the tile straight from global memory
// (ld.global.nc, volatile, so nothing is elided). The TPU probes write the
// same (8, W) output block from every tile, so their result is the last
// tile's; CUDA blocks run in no order, so here tile t writes its own first
// 8 rows into its own slot out[t] (8, W): the plain version is a strided
// slice, and every tile is checked.
//
// Bound: bytes. Each variant reads the input once (plus the H rows the
// windows share) and writes 8 rows a tile, so its least time is the
// input's bytes at 3.35 TB/s; the reported rate is the input's bytes over
// the time, as the TPU probes report it.
//
// planes_unpack: the interleaved cf32 stream (re, im pairs) and the M-1
// samples carried from the batch before become the planes rows of the fused
// chain, row k = [re | im] of stream samples kM-(M-1) .. kM, as
// blocks/vector_dsp.py cplx_to_planes builds them with torch ops, and the
// last M-1 samples of the batch become the next skew. At M = 64 row k >= 1
// is x[64k - 63 .. 64k]: its channels 2c, 2c+1 are x[2q+1] and x[2q+2] for
// q = 32(k-1) + c, the second sample of x's 16-byte word q and the first of
// word q+1. So a thread loads kUnpack words q (one 16-byte load each, all
// before any store), takes word q+1's first sample from the next lane
// (__shfl_down_sync; lane 31 loads it), and writes the re and im pairs
// straight from registers to the two 256-byte halves of row q/32 + 1: a
// warp writes 256 contiguous bytes of each half, and nothing passes through
// shared memory. Block 0 also writes row 0 (skew and x[0]) and the next
// skew, so one launch does the whole job. A stream that starts 8 bytes off
// a 16-byte boundary takes the same kernel with two 8-byte loads a word.
// Bound: bytes, one read of the stream and one write of the rows. At the
// flagship's batch the grid is two waves of blocks (8 an SM), each thread
// with its kUnpack = 2 loads in flight: the speed of a plain copy of the
// same bytes (chip_smoke.py phase 34 beside the probes' torch_clone).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutRows = 8;  // rows of each tile's slot

enum CopyVariant { kDbuf = 0, kSingle, kSplit, kDirect };

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 ld_nc4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// The copies of one window (rows r0 .. r0+rows-1 of a (., lanes) plane)
// into dst, committed by the caller.
template <int kLanes>
__device__ __forceinline__ void issue_window(float* dst, const float* x,
                                             long long r0, int rows) {
  const float* src = x + r0 * kLanes;
  for (int i = threadIdx.x * 4; i < rows * kLanes; i += kThreads * 4)
    cp_async16(dst + i, src + i);
}

// kLanes: lanes of a row of the output slot (and of x, but for kSplit:
// two planes of kLanes / 2). kSlots: 2 double-buffered, 1 single-slot.
template <int kVariant, int kLanes>
__global__ void __launch_bounds__(kThreads)
window_copy_kernel(const float* __restrict__ x, const float* __restrict__ xi,
                   float* __restrict__ out, int NT, int T, int H, int G) {
  extern __shared__ __align__(16) float sm[];
  const int t_begin = blockIdx.x * G;
  const int t_end = min(t_begin + G, NT);
  const int tid = threadIdx.x;
  if constexpr (kVariant == kDirect) {
    for (int t = t_begin; t < t_end; ++t) {
      const float* tile = x + (long long)t * T * kLanes;
      float* slot = out + (long long)t * kOutRows * kLanes;
      for (int i = tid * 4; i < T * kLanes; i += kThreads * 4) {
        const float4 v = ld_nc4(tile + i);
        if (i < kOutRows * kLanes) *reinterpret_cast<float4*>(slot + i) = v;
      }
    }
    return;
  }
  const int rows = T + H;
  constexpr int kPlane = kVariant == kSplit ? kLanes / 2 : kLanes;
  const int slot_floats = rows * kLanes;  // both planes for kSplit
  auto issue = [&](int t, int s) {
    float* dst = sm + s * slot_floats;
    if constexpr (kVariant == kSplit) {
      issue_window<kPlane>(dst, x, (long long)t * T, rows);
      issue_window<kPlane>(dst + rows * kPlane, xi, (long long)t * T, rows);
    } else {
      issue_window<kLanes>(dst, x, (long long)t * T, rows);
    }
    cp_commit();
  };
  if (t_begin >= t_end) return;
  if constexpr (kVariant != kSingle) issue(t_begin, 0);
  for (int t = t_begin; t < t_end; ++t) {
    int s = 0;
    if constexpr (kVariant == kSingle) {
      issue(t, 0);
      cp_wait<0>();
    } else {
      s = (t - t_begin) & 1;
      if (t + 1 < t_end) {
        issue(t + 1, s ^ 1);  // the next window's copies, before the wait
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    }
    __syncthreads();
    const float* win = sm + s * slot_floats;
    float* slot = out + (long long)t * kOutRows * kLanes;
    for (int i = tid; i < kOutRows * kLanes; i += kThreads) {
      const int r = i / kLanes, c = i % kLanes;
      if constexpr (kVariant == kSplit)
        slot[i] = c < kPlane ? win[r * kPlane + c]
                             : win[rows * kPlane + r * kPlane + c - kPlane];
      else
        slot[i] = win[i];
    }
    __syncthreads();  // the slot is read before it is copied into again
  }
}

template <int kVariant, int kLanes>
int launch_copy(const float* x, const float* xi, float* out, int NT, int T,
                int H, int G, int slots, void* stream) {
  const size_t smem = kVariant == kDirect
                          ? 0
                          : (size_t)slots * (T + H) * kLanes * sizeof(float);
  auto kernel = window_copy_kernel<kVariant, kLanes>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(NT + G - 1) / G, kThreads, smem, (cudaStream_t)stream>>>(
      x, xi, out, NT, T, H, G);
  return (int)cudaGetLastError();
}

// planes_unpack at M = 64: block b holds words [b*kThreads*kUnpack, ...).
constexpr int kUnpack = 2;  // 16-byte words a thread

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
planes_unpack_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ skew, float* __restrict__ out,
                     float2* __restrict__ skew_out, int n_rows) {
  constexpr int kM = 64, kW = 2 * kM;
  const long long n_words = (long long)(n_rows - 1) * (kM / 2);
  const long long q0 = (long long)blockIdx.x * kThreads * kUnpack + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // x[2q+1] and x[2q+2] of each word q; with 16-byte words, f holds x[2q]
  // for lane-1 and e lane 31's x[2q+2]
  float2 a[kUnpack], b[kUnpack], f[kUnpack], e[kUnpack];
#pragma unroll
  for (int u = 0; u < kUnpack; ++u) {
    const long long q = q0 + u * kThreads;
    if constexpr (kWords) {
      // the word after the last row's last is x[64(n-1)], still in x
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q <= n_words)
        w = __ldg(reinterpret_cast<const float4*>(x + 2 * q));
      f[u] = make_float2(w.x, w.y);
      a[u] = make_float2(w.z, w.w);
      e[u] = lane == 31 && q < n_words ? __ldg(x + 2 * q + 2) : f[u];
    } else if (q < n_words) {
      a[u] = __ldg(x + 2 * q + 1);
      b[u] = __ldg(x + 2 * q + 2);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnpack; ++u) {
    const long long q = q0 + u * kThreads;
    if constexpr (kWords) {
      const float bx = __shfl_down_sync(0xffffffffu, f[u].x, 1);
      const float by = __shfl_down_sync(0xffffffffu, f[u].y, 1);
      b[u] = lane < 31 ? make_float2(bx, by) : e[u];
    }
    if (q < n_words) {
      float* row = out + (q / 32 + 1) * kW + 2 * (q % 32);
      *reinterpret_cast<float2*>(row) = make_float2(a[u].x, b[u].x);
      *reinterpret_cast<float2*>(row + kM) = make_float2(a[u].y, b[u].y);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < kM) {
    const int j = threadIdx.x;
    const float2 s = j < kM - 1 ? skew[j] : x[0];
    out[j] = s.x;
    out[kM + j] = s.y;
    if (j < kM - 1) skew_out[j] = x[(long long)n_rows * kM - (kM - 1) + j];
  }
}

}  // namespace

// variant: 0 double-buffered, 1 single-slot, 2 split planes (x and xi, 64
// lanes each, double-buffered), 3 direct loads; lanes: the row width of x
// (of the output slot for variant 2). x holds NT*T + H rows.
extern "C" int window_copy_launch(int variant, const float* x, const float* xi,
                                  float* out, long long rows, int T, int H,
                                  int G, int lanes, void* stream) {
  if (T <= 0 || H < 0 || G <= 0 || rows < T + H || (variant == kSplit) !=
      (xi != nullptr) || (variant == kDirect && H != 0) || T < kOutRows)
    return (int)cudaErrorInvalidValue;
  const int NT = (int)((rows - H) / T);
  switch (variant * 10000 + lanes) {
    case kDbuf * 10000 + 128:
      return launch_copy<kDbuf, 128>(x, xi, out, NT, T, H, G, 2, stream);
    case kDbuf * 10000 + 256:
      return launch_copy<kDbuf, 256>(x, xi, out, NT, T, H, G, 2, stream);
    case kDbuf * 10000 + 512:
      return launch_copy<kDbuf, 512>(x, xi, out, NT, T, H, G, 2, stream);
    case kDbuf * 10000 + 1024:
      return launch_copy<kDbuf, 1024>(x, xi, out, NT, T, H, G, 2, stream);
    case kSingle * 10000 + 128:
      return launch_copy<kSingle, 128>(x, xi, out, NT, T, H, G, 1, stream);
    case kSplit * 10000 + 128:
      return launch_copy<kSplit, 128>(x, xi, out, NT, T, H, G, 2, stream);
    case kDirect * 10000 + 512:
      return launch_copy<kDirect, 512>(x, xi, out, NT, T, H, G, 0, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x: n_rows * M complex samples as (re, im) floats; skew: the M-1 samples
// before them; out: (n_rows, 2M); skew_out: the last M-1 samples of x. M =
// 64 (the fused chain's 128 lanes).
extern "C" int planes_unpack_launch(const float* x, const float* skew,
                                    float* out, float* skew_out, int n_rows,
                                    int M, void* stream) {
  if (M != 64 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const long long words = (long long)(n_rows - 1) * (M / 2) + 1;
  const unsigned blocks =
      (unsigned)((words + kThreads * kUnpack - 1) / (kThreads * kUnpack));
  const auto x2 = reinterpret_cast<const float2*>(x);
  const auto s2 = reinterpret_cast<const float2*>(skew);
  const auto o2 = reinterpret_cast<float2*>(skew_out);
  const cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)x % 16 == 0)
    planes_unpack_kernel<true><<<blocks, kThreads, 0, s>>>(x2, s2, out, o2,
                                                           n_rows);
  else
    planes_unpack_kernel<false><<<blocks, kThreads, 0, s>>>(x2, s2, out, o2,
                                                            n_rows);
  return (int)cudaGetLastError();
}
