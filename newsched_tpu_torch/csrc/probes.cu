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
// blocks/vector_dsp.py cplx_to_planes builds them with torch ops. A block
// stages T rows' samples into shared memory as planes rows (the layout K3's
// window holds), then writes the rows out with 16-byte stores. Bound:
// bytes, one read of the stream and one write of the rows.

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

// planes_unpack: block b builds rows [b*T, b*T + T) in shared memory.
template <int kM>
__global__ void __launch_bounds__(kThreads)
planes_unpack_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ skew, float* __restrict__ out,
                     int n_rows, int T) {
  extern __shared__ __align__(16) float rows_sm[];
  constexpr int kW = 2 * kM;
  const int r0 = blockIdx.x * T;
  const int nr = min(T, n_rows - r0);
  // sample f of [skew; x] is full-stream index f: row f / M, channel f % M
  for (int e = threadIdx.x; e < nr * kM; e += kThreads) {
    const long long f = (long long)r0 * kM + e;
    const float2 v = f < kM - 1 ? skew[f] : x[f - (kM - 1)];
    const int r = e / kM, j = e % kM;
    rows_sm[r * kW + j] = v.x;
    rows_sm[r * kW + kM + j] = v.y;
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + (long long)r0 * kW);
  const float4* src = reinterpret_cast<const float4*>(rows_sm);
  for (int i = threadIdx.x; i < nr * kW / 4; i += kThreads) dst[i] = src[i];
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
// before them; out: (n_rows, 2M). M = 64 (the fused chain's 128 lanes).
extern "C" int planes_unpack_launch(const float* x, const float* skew,
                                    float* out, int n_rows, int M,
                                    void* stream) {
  constexpr int kT = 64;  // rows a block: 32 KB of shared memory
  if (M != 64 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  planes_unpack_kernel<64><<<(n_rows + kT - 1) / kT, kThreads,
                             (size_t)kT * 2 * 64 * sizeof(float),
                             (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<const float2*>(skew),
      out, n_rows, kT);
  return (int)cudaGetLastError();
}
