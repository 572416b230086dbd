// The position-pure Gaussian stream element, shared by the noise kernel
// (noise.cu, K4) and the generating chain kernel (fm_chain.cu, K5), so the
// two produce the same bits for the same (seed, row, lane).
//
// Element (row, k) of a stream of `width` lanes, with row counted from the
// first row of group g0 (of either sign: a row before g0 lies in an
// earlier group):
//   key     = the stream seed (low, high 32 bits),
//   counter = ((row mod 64) * width + k, group lo, group hi, 0),
//             group = g0 + floor(row / 64) (64-bit, two's complement),
// then Philox4x32-10, and the Irwin-Hall N = 2*draws transform of its first
// `draws` words (sum of their uint16 halves, then (S - mean) * inv_std).
// The sum is an exact integer and the transform one correctly rounded
// subtract and one multiply, so the plain PyTorch version
// (ops/cuda/noise.py) reproduces it bit for bit.

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kGroupRows = 64;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c[0]), lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]), lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The stream's parameters, as the wrappers pass them.
struct Stream {
  uint64_t g0;     // absolute 64-row group of row 0
  uint32_t k0, k1; // seed
  int draws;       // 2 or 3 Philox words per element
  float mean, inv_std;
  int mask_pre;    // groups negative as signed (before the stream) read 0
};

// The stream's 64-bit group counter, kept on the card as one int64 (two's
// complement, so the signed pre-stream region reads negative), plus a
// signed offset of whole groups (a time shard's distance from its batch's
// base); the sum wraps at 2^64 as the reference's (hi, lo) int32 pair.
__device__ __forceinline__ uint64_t group_at(const long long* group,
                                             long long off) {
  return (uint64_t)group[0] + (uint64_t)off;
}

// Standard-normal element (row, k), row counted from group g0. C division
// truncates toward zero, so the group of a negative row is taken by floor
// division: row -1 is the last row of group g0 - 1, not row -1 of g0.
__device__ __forceinline__ float gauss(const Stream& s, long long row, int k,
                                       int width) {
  const long long q = (row >= 0 ? row : row - (kGroupRows - 1)) / kGroupRows;
  const uint64_t g = s.g0 + (uint64_t)q;
  if (s.mask_pre && (long long)g < 0) return 0.f;
  uint32_t c[4] = {(uint32_t)((row - q * kGroupRows) * width + k), (uint32_t)g,
                   (uint32_t)(g >> 32), 0u};
  philox4x32_10(c, s.k0, s.k1);
  uint32_t sum = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    if (d < s.draws) sum += (c[d] & 0xFFFFu) + (c[d] >> 16);
  return __fmul_rn(__fsub_rn((float)sum, s.mean), s.inv_std);
}

// The same generator with its key schedule hoisted: the ten round keys of
// a seed, computed once a thread, then the rounds alone (the noise kernel,
// K4, which runs the generator many times a thread). Bit for bit
// philox4x32_10.
struct Keys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ Keys round_keys(uint32_t k0, uint32_t k1) {
  Keys k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0 + (uint32_t)r * kW0;
    k.k1[r] = k1 + (uint32_t)r * kW1;
  }
  return k;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], const Keys& k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c[0]), lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]), lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k.k0[r], n2 = hi0 ^ c[3] ^ k.k1[r];
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The Irwin-Hall transform of gauss() with `draws` fixed at compile time:
// the element of counter (c0, group lo, group hi, 0).
template <int DRAWS>
__device__ __forceinline__ float gauss_at(uint32_t c0, uint32_t glo,
                                          uint32_t ghi, const Keys& k,
                                          float mean, float inv_std) {
  uint32_t c[4] = {c0, glo, ghi, 0u};
  philox4x32_10(c, k);
  uint32_t sum = 0;
#pragma unroll
  for (int d = 0; d < DRAWS; ++d) sum += (c[d] & 0xFFFFu) + (c[d] >> 16);
  return __fmul_rn(__fsub_rn((float)sum, mean), inv_std);
}

}  // namespace philox
