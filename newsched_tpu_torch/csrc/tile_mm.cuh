// The register-tiled FP32 product of a shared-memory tile with a constant
// matrix, shared by the fused chain (fm_chain.cu, K3/K5, a 128 x 128
// matrix) and the channelizer front end (channelizer.cu, K1, any multiple
// of 128 lanes, one 128-column block at a time).
//
// One pass covers kPassRows = 32 rows and 128 output columns with 256
// threads: thread (ty, tx), ty = tid / 32 and tx = tid % 32, owns rows
// 4*ty..4*ty+3 of the pass and columns 4*tx..4*tx+3, and keeps its 4 x 4
// outputs in registers. The matrix is read through the read-only cache as
// float4. Every output is the same chain of fmaf over k = 0..K-1, whichever
// block or pass computes it, so a result never depends on the tile size.

#pragma once

namespace tile_mm {

constexpr int kW = 128;        // lanes of a row (2M for M = 64 channels)
constexpr int kThreads = 256;  // threads per block
constexpr int kPassRows = 32;  // rows per pass: 8 row groups x 4

// o[i][j] = sum_{k<K} a[(4*ty + i) * lda + k] * w[k * ldw + 4*tx + j],
// where a points at the pass's first row and w at its first column.
__device__ __forceinline__ void pass(const float* a, int lda,
                                     const float* __restrict__ w, int ldw,
                                     int K, float o[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  const float* arow = a + 4 * ty * lda;
  for (int k = 0; k < K; ++k) {
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k * ldw + 4 * tx));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = arow[i * lda + k];
      o[i][0] = fmaf(x, wv.x, o[i][0]);
      o[i][1] = fmaf(x, wv.y, o[i][1]);
      o[i][2] = fmaf(x, wv.z, o[i][2]);
      o[i][3] = fmaf(x, wv.w, o[i][3]);
    }
  }
}

// The 128 x 128 case: rows of kW lanes against a kW x kW matrix.
__device__ __forceinline__ void pass(const float* a,
                                     const float* __restrict__ w,
                                     float o[4][4]) {
  pass(a, kW, w, kW, kW, o);
}

}  // namespace tile_mm
