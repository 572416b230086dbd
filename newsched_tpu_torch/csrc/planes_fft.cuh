// The planes DFT as a shared-memory FFT, for M = 64 P channels, P = 1 .. 16
// (64 to 1024): the phase combine of the fused chains (fm_chain.cu: stage 2
// of chain_tile at P = 1, chain_tile_wide past it) and of the channelizer
// front end (channelizer.cu, K1, every P).
//
// A planes row holds a[k] = re at lane k and im at lane M + k (k < M); the
// routine replaces it with Y[j] = e^{-2 pi i j/M} sum_k a[k] e^{-2 pi i jk/M}
// (ops/cuda/fm_chain.py planes_dft_matrix). The transform is a radix-P
// step, decimation in frequency, then P 64-point FFTs of 8 x 8:
//
//   y_r[n] = W_M^(n r) sum_j a[n + 64 j] W_P^(j r)     n < 64, r < P
//   X[P k + r] = sum_n y_r[n] W_64^(n k)              (the 8 x 8 FFT)
//
// 8 threads take a row, 4 rows a warp. Thread t holds a[t + 8 n2 + 64 j]
// (n2 < 8, j < P), does the P-point DFTs and their twiddles, then for each
// r a radix-8 DFT over n2, times W_64^(t k1), an exchange through the row
// itself (__syncwarp between every read and write of the row; sub-FFT r
// takes lanes 64 r .. 64 r + 63 of each half), a radix-8 DFT over n1, and
// the post-twiddle e^{-2 pi i j/M} of its outputs j = P (t + 8 k2) + r. At
// P = 1 that is the 64-point FFT alone, ~2,000 flops a row in place of the
// dense product's 32 KFLOP; at P = 4 ~11,000 in place of 524 KFLOP.
//
// The twiddles are the host's (planes_fft_table: float64, cast to float32;
// row 0/1 W_64^(n1 k1) at n1 * 8 + k1, n1, k1 < 8, then zeros; row 2/3
// e^{-2 pi i j/M} at j < M, which are also the radix-P step's W_M^(n r)).
// Every multiply and add is rounded on its own (__fadd_rn, __fmul_rn,
// never contracted), so the arithmetic is fixed whatever the compiler does
// and a row's Y never depends on the block, tile or kernel that transforms
// it; ops/cuda/planes_fft.py fft_planes repeats it in torch float32.
//
// Rows of 2M floats all start at bank 0, so a row's lanes are kept
// swizzled: logical lane k of buffer row r sits at k ^ ((r & 3) << 3) (sw),
// which puts the 4 rows of a warp on 4 disjoint sets of 8 banks when its
// threads read a[t + 8 n2 + 64 j]; the exchange has its own conflict-free
// layout (xch), the same in each 64-lane part of the row.
//
// Past P = 4 (fft_tile_wide, K1 at M = 320, 384, 448) a thread holding
// 8 P complex values of a row would not fit the registers a block of M
// threads leaves it beside K1's fold (168 a thread at M = 320 and 384,
// 128 at 448), so the same operations are spread over the block in two
// passes: (a) the radix-P step, one column n of one row a thread (P
// values), in place; (b) the P 64-point FFTs of each row, sub-FFT q of 4
// rows a warp (8 values a thread), each in its own 64-lane part of the
// row, with its outputs Y[P (t + 8 k2) + q] left at logical lane
// 64 q + t + 8 k2 of that part (wide_lane): every pass then touches only
// its own part, so the passes of one row need no barrier between them.
// The P-point DFTs: P = 5 and 7 from the pairs x[m] +- x[P-m] (t_k = x0 +
// sum_m cos(2 pi mk/P) s_m, u_k = sum_m sin(2 pi mk/P) d_m, y_k, y_{P-k} =
// t_k -+ i u_k), their cos and sin the table's post-twiddle at j = 64 a
// (e^{-2 pi i a/P}); P = 6 as 2 x 3 by the prime-factor map (no
// twiddles): the 3-point DFTs of x[0, 2, 4] and x[3, 5, 1], then 2-point
// DFTs, y at (3 k1 + 4 k2) mod 6.
//
// Past P = 7 (fft_tile_rt: K1 and the chains at M = 512 .. 1024) P and M
// are run-time values, one code for the nine widths, and the radix-P step
// is two passes over the block, P = P1 x P2 (Plan, plan_of): pass 1 the
// P1-point DFTs of each column n, pass 2 the P2-point DFTs, then the P
// 64-point FFTs of pass (b) above, sub-FFT q in the row's 64-lane part
// Plan::part(q). Where P1 and P2 are coprime (10 = 2 x 5, 12 = 4 x 3, 14 =
// 2 x 7, 15 = 3 x 5) the prime-factor map takes the input j from part
// (P2 j1 + P1 j2) mod P and needs no twiddles between the passes; 9 = 3 x 3
// and 16 = 4 x 4 take the input j = P2 j1 + j2 and the twiddles W_P^(j2
// k1); 8 (dft8), 11 and 13 (the pairs' form, dft_odd) are one pass. A
// thread holds one column's P1 or P2 values, at most 13, not a row's P: a
// block of 256 threads leaves each at most 255 registers, but K1 at M =
// 448 already spilled with 7. Pass 1 leaves its outputs in the parts it
// read, pass 2 in the parts it read, so neither needs more than its own
// column. Every operation is rounded on its own as above;
// ops/cuda/planes_fft.py _radix_two_pass repeats the passes.

#pragma once

namespace planes_fft {

// Single operations, each rounded to nearest on its own (never contracted).
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }

// (re, im) *= (cr, ci), each product and sum rounded on its own.
__device__ __forceinline__ void cmul(float& re, float& im, float cr, float ci) {
  const float r = rsub(rmul(re, cr), rmul(im, ci));
  im = radd(rmul(re, ci), rmul(im, cr));
  re = r;
}

// Logical lane k of buffer row r.
__device__ __forceinline__ int sw(int r, int k) { return k ^ ((r & 3) << 3); }

// Where the exchange keeps A[a][b] (a the writing thread, b the reading
// one) in a row whose swizzle key is s = r & 3: (a ^ s, b ^ s ^ (a & 4)) as
// 8 x 8, so the 32 lanes of a warp (4 rows x 8 threads) touch 32 distinct
// banks both when thread a writes A[a][b] and when thread b reads it.
__device__ __forceinline__ int xch(int s, int a, int b) {
  return 8 * (a ^ s) + (b ^ s ^ (a & 4));
}

// y[k] = sum_n y[n] (-i)^(nk), in place, n, k = 0..3.
__device__ __forceinline__ void dft4(float* yr, float* yi) {
  const float s0r = radd(yr[0], yr[2]), s0i = radd(yi[0], yi[2]);
  const float d0r = rsub(yr[0], yr[2]), d0i = rsub(yi[0], yi[2]);
  const float s1r = radd(yr[1], yr[3]), s1i = radd(yi[1], yi[3]);
  const float d1r = rsub(yr[1], yr[3]), d1i = rsub(yi[1], yi[3]);
  yr[0] = radd(s0r, s1r); yi[0] = radd(s0i, s1i);
  yr[2] = rsub(s0r, s1r); yi[2] = rsub(s0i, s1i);
  yr[1] = radd(d0r, d1i); yi[1] = rsub(d0i, d1r);
  yr[3] = rsub(d0r, d1i); yi[3] = radd(d0i, d1r);
}

// x[k] = sum_n x[n] W8^(nk) in place, n, k = 0..7, W8 = e^{-2 pi i/8}:
// a = x[n] + x[n+4] gives the even k, b = (x[n] - x[n+4]) W8^n the odd.
__device__ __forceinline__ void dft8(float* xr, float* xi, float c) {
  float ar[4], ai[4], br[4], bi[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    ar[n] = radd(xr[n], xr[n + 4]); ai[n] = radd(xi[n], xi[n + 4]);
    br[n] = rsub(xr[n], xr[n + 4]); bi[n] = rsub(xi[n], xi[n + 4]);
  }
  float r = rmul(radd(br[1], bi[1]), c);  // W8 = c (1 - i)
  bi[1] = rmul(rsub(bi[1], br[1]), c);
  br[1] = r;
  r = bi[2];                              // W8^2 = -i
  bi[2] = -br[2];
  br[2] = r;
  r = rmul(rsub(bi[3], br[3]), c);        // W8^3 = -c (1 + i)
  bi[3] = -rmul(radd(br[3], bi[3]), c);
  br[3] = r;
  dft4(ar, ai);
  dft4(br, bi);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xr[2 * k] = ar[k]; xi[2 * k] = ai[k];
    xr[2 * k + 1] = br[k]; xi[2 * k + 1] = bi[k];
  }
}

// y[r] = sum_j x[j] W_P^(jr) in place, P = 1 .. 4. P = 3: s = x1 + x2,
// d = x1 - x2, y0 = x0 + s, y1,2 = (x0 - s/2) -+ i h d with h = sin(pi/3).
template <int P>
__device__ __forceinline__ void dftp(float* xr, float* xi, float h) {
  if constexpr (P == 2) {
    const float r = rsub(xr[0], xr[1]), i = rsub(xi[0], xi[1]);
    xr[0] = radd(xr[0], xr[1]);
    xi[0] = radd(xi[0], xi[1]);
    xr[1] = r;
    xi[1] = i;
  } else if constexpr (P == 3) {
    const float sr = radd(xr[1], xr[2]), si = radd(xi[1], xi[2]);
    const float dr = rsub(xr[1], xr[2]), di = rsub(xi[1], xi[2]);
    const float tr = rsub(xr[0], rmul(0.5f, sr));
    const float ti = rsub(xi[0], rmul(0.5f, si));
    xr[0] = radd(xr[0], sr);
    xi[0] = radd(xi[0], si);
    const float hr = rmul(h, dr), hi = rmul(h, di);
    xr[1] = radd(tr, hi); xi[1] = rsub(ti, hr);
    xr[2] = rsub(tr, hi); xi[2] = radd(ti, hr);
  } else if constexpr (P == 4) {
    dft4(xr, xi);
  }
}

// A thread's twiddles, loaded once (tab: the (4, M) table): W_64^(t k1),
// cos(pi/4) and sin(pi/3); at P = 1 also its outputs' post-twiddles, which
// wider rows read through the read-only cache.
template <int P>
struct Tw {
  static constexpr int M = 64 * P;
  float in_re[8], in_im[8];      // W_64^(t k1), k1 = 0..7
  float post_re[P == 1 ? 8 : 1], post_im[P == 1 ? 8 : 1];
  float c, h;
  __device__ __forceinline__ Tw(const float* tab, int t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      in_re[i] = __ldg(tab + t * 8 + i);
      in_im[i] = __ldg(tab + M + t * 8 + i);
      if constexpr (P == 1) {
        post_re[i] = __ldg(tab + 2 * M + t + 8 * i);
        post_im[i] = __ldg(tab + 3 * M + t + 8 * i);
      }
    }
    c = __ldg(tab + 2 * M + M / 8);            // Re e^{-2 pi i/8}
    h = P == 3 ? -__ldg(tab + 3 * M + M / 3) : 0.f;  // -Im e^{-2 pi i/3}
  }
};

// One row (buffer row r at `row`, 2M floats, swizzled), thread t = 0..7 of
// its 8: a in, Y out. The whole warp calls it (its 4 rows), for the
// __syncwarp()s.
template <int P>
__device__ __forceinline__ void fft_row(float* row, int r, int t,
                                        const Tw<P>& w, const float* tab) {
  constexpr int M = 64 * P;
  const int s = r & 3;
  float xr[P][8], xi[P][8];
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = sw(r, t + 8 * n2 + 64 * j);
      xr[j][n2] = row[i];
      xi[j][n2] = row[M + i];
    }
  if constexpr (P > 1) {
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      float yr[P], yi[P];
#pragma unroll
      for (int j = 0; j < P; ++j) yr[j] = xr[j][n2], yi[j] = xi[j][n2];
      dftp<P>(yr, yi, w.h);
#pragma unroll
      for (int q = 1; q < P; ++q) {
        const int m = (t + 8 * n2) * q;  // W_M^(n q), n = t + 8 n2
        cmul(yr[q], yi[q], __ldg(tab + 2 * M + m), __ldg(tab + 3 * M + m));
      }
#pragma unroll
      for (int j = 0; j < P; ++j) xr[j][n2] = yr[j], xi[j][n2] = yi[j];
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    dft8(xr[q], xi[q], w.c);  // A[t][k1], k1 = 0..7
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1)
      cmul(xr[q][k1], xi[q][k1], w.in_re[k1], w.in_im[k1]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      const int i = 64 * q + xch(s, t, k1);
      row[i] = xr[q][k1];
      row[M + i] = xi[q][k1];
    }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int i = 64 * q + xch(s, n1, t);
      xr[q][n1] = row[i];
      xi[q][n1] = row[M + i];
    }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    dft8(xr[q], xi[q], w.c);  // X[P (t + 8 k2) + q], k2 = 0..7
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      const int j = P * (t + 8 * k2) + q;
      if constexpr (P == 1)
        cmul(xr[q][k2], xi[q][k2], w.post_re[k2], w.post_im[k2]);
      else
        cmul(xr[q][k2], xi[q][k2], __ldg(tab + 2 * M + j),
             __ldg(tab + 3 * M + j));
      const int i = sw(r, j);
      row[i] = xr[q][k2];
      row[M + i] = xi[q][k2];
    }
  }
}

// ---- P = 5, 6, 7: the tile in two passes (fft_tile_wide) ------------------

// cos and sin of 2 pi a / P, a = 0 .. P-1: the table's e^{-2 pi i j/M} at
// j = 64 a.
template <int P>
struct WP {
  float cs[P], sn[P], h;
  __device__ __forceinline__ explicit WP(const float* tab) {
    constexpr int M = 64 * P;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      cs[a] = __ldg(tab + 2 * M + 64 * a);
      sn[a] = -__ldg(tab + 3 * M + 64 * a);
    }
    h = P == 6 ? sn[2] : 0.f;  // sin(2 pi 2/6) = sin(pi/3), dftp<3>'s at P = 6
  }
};

// The cos and sin of 2 pi a / P read from the table where they are used
// (the post-twiddle's e^{-2 pi i j/M} at j = a step), so that a P-point
// DFT past P = 7 holds no copy of them in registers.
struct TabCosSin {
  const float* re;  // the table's row 2
  const float* im;  // its row 3
  int step;
  __device__ __forceinline__ float cos_at(int a) const { return __ldg(re + a * step); }
  __device__ __forceinline__ float sin_at(int a) const { return -__ldg(im + a * step); }
};

// Arrays of cos and sin, as WP holds them.
struct ArrCosSin {
  const float* cs;
  const float* sn;
  __device__ __forceinline__ float cos_at(int a) const { return cs[a]; }
  __device__ __forceinline__ float sin_at(int a) const { return sn[a]; }
};

// y[k] = sum_j x[j] W_P^(jk) in place for an odd P >= 5, from the pairs
// x[m] +- x[P-m]; w.cos_at(a), w.sin_at(a) the cos and sin of 2 pi a / P.
template <int P, class CS>
__device__ __forceinline__ void dft_odd(float* xr, float* xi, const CS& w) {
  constexpr int H = (P - 1) / 2;
  float sr[H + 1], si[H + 1], dr[H + 1], di[H + 1];
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    sr[m] = radd(xr[m], xr[P - m]); si[m] = radd(xi[m], xi[P - m]);
    dr[m] = rsub(xr[m], xr[P - m]); di[m] = rsub(xi[m], xi[P - m]);
  }
  float y0r = xr[0], y0i = xi[0];
#pragma unroll
  for (int m = 1; m <= H; ++m) y0r = radd(y0r, sr[m]), y0i = radd(y0i, si[m]);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float tr = xr[0], ti = xi[0], ur = 0.f, ui = 0.f;
#pragma unroll
    for (int m = 1; m <= H; ++m) {
      const int a = m * k % P;
      const float c = w.cos_at(a), sa = w.sin_at(a);
      tr = radd(tr, rmul(c, sr[m]));
      ti = radd(ti, rmul(c, si[m]));
      const float pr = rmul(sa, dr[m]), pi = rmul(sa, di[m]);
      ur = m == 1 ? pr : radd(ur, pr);
      ui = m == 1 ? pi : radd(ui, pi);
    }
    xr[k] = radd(tr, ui); xi[k] = rsub(ti, ur);
    xr[P - k] = rsub(tr, ui); xi[P - k] = radd(ti, ur);
  }
  xr[0] = y0r;
  xi[0] = y0i;
}

// y[r] = sum_j x[j] W_P^(jr) in place, P = 5, 7 (odd, from the pairs) and
// P = 6 (2 x 3, the prime-factor map).
template <int P>
__device__ __forceinline__ void dftp_wide(float* xr, float* xi, const WP<P>& w) {
  if constexpr (P == 6) {
    float ar[3] = {xr[0], xr[2], xr[4]}, ai[3] = {xi[0], xi[2], xi[4]};
    float br[3] = {xr[3], xr[5], xr[1]}, bi[3] = {xi[3], xi[5], xi[1]};
    dftp<3>(ar, ai, w.h);
    dftp<3>(br, bi, w.h);
#pragma unroll
    for (int k2 = 0; k2 < 3; ++k2) {  // y at (3 k1 + 4 k2) % 6, k1 = 0, 1
      const int lo = 4 * k2 % 6, hi = (3 + 4 * k2) % 6;
      xr[lo] = radd(ar[k2], br[k2]);
      xi[lo] = radd(ai[k2], bi[k2]);
      xr[hi] = rsub(ar[k2], br[k2]);
      xi[hi] = rsub(ai[k2], bi[k2]);
    }
  } else {
    dft_odd<P>(xr, xi, ArrCosSin{w.cs, w.sn});
  }
}

// Where sub-FFT q leaves output j = P (t + 8 k2) + q: logical lane
// 64 q + t + 8 k2 of the row.
template <int P>
__device__ __forceinline__ int wide_lane(int j) {
  return 64 * (j % P) + j / P;
}

// The planes DFT of `rows` rows of the tile (rows of 2M floats, swizzled,
// rows a multiple of 4) by all `threads` threads of the block, thread tid;
// the caller has synchronised the block before. Row r's output j is left
// at logical lane wide_lane<P>(j) of row r; a __syncthreads() comes before
// it is read.
template <int P>
__device__ __forceinline__ void fft_tile_wide(float* tile, int rows, int tid,
                                              int threads, const float* tab) {
  constexpr int M = 64 * P, W = 2 * M;
  {  // (a) the radix-P step: column n of row r, n = e % 64 (a constant
     // of the thread when threads is a multiple of 64)
    const WP<P> wp(tab);
    for (int e = tid; e < rows * 64; e += threads) {
      const int r = e >> 6, n = e & 63;
      float* row = tile + r * W;
      float xr[P], xi[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int i = sw(r, n + 64 * j);
        xr[j] = row[i];
        xi[j] = row[M + i];
      }
      dftp_wide<P>(xr, xi, wp);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q > 0)
          cmul(xr[q], xi[q], __ldg(tab + 2 * M + n * q),
               __ldg(tab + 3 * M + n * q));
        const int i = sw(r, n + 64 * q);
        row[i] = xr[q];
        row[M + i] = xi[q];
      }
    }
  }
  __syncthreads();
  // (b) sub-FFT q of rows 4 g .. 4 g + 3, one task a warp
  const int t = tid & 7, lane_row = (tid >> 3) & 3;
  const Tw<P> w(tab, t);
  for (int task = tid >> 5; task < (rows / 4) * P; task += threads >> 5) {
    const int q = task % P, r = 4 * (task / P) + lane_row, s = r & 3;
    float* row = tile + r * W;
    float xr[8], xi[8];
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      const int i = sw(r, t + 8 * n2 + 64 * q);
      xr[n2] = row[i];
      xi[n2] = row[M + i];
    }
    dft8(xr, xi, w.c);  // A[t][k1], k1 = 0..7
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) cmul(xr[k1], xi[k1], w.in_re[k1], w.in_im[k1]);
    __syncwarp();
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      const int i = 64 * q + xch(s, t, k1);
      row[i] = xr[k1];
      row[M + i] = xi[k1];
    }
    __syncwarp();
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int i = 64 * q + xch(s, n1, t);
      xr[n1] = row[i];
      xi[n1] = row[M + i];
    }
    __syncwarp();
    dft8(xr, xi, w.c);  // X[P (t + 8 k2) + q], k2 = 0..7
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      const int j = P * (t + 8 * k2) + q;
      cmul(xr[k2], xi[k2], __ldg(tab + 2 * M + j), __ldg(tab + 3 * M + j));
      const int i = sw(r, 64 * q + t + 8 * k2);
      row[i] = xr[k2];
      row[M + i] = xi[k2];
    }
  }
}

// ---- P = 8 .. 16: P and M at run time (fft_tile_rt) -----------------------

// The radix-P step's two passes, P = P1 x P2 (the header). slot(a, b): the
// 64-lane part of a row holding the passes' value (a, b), the input j at
// slot(j1, j2); out(k1, k2): the radix output q that pass 2 leaves at
// slot(k1, k2); part(q): where sub-FFT q runs; lane(j): the logical lane of
// output j < M in a row.
struct Plan {
  int P, P1, P2, pfa, e1, e2;
  __host__ __device__ __forceinline__ int slot(int a, int b) const {
    return pfa ? (P2 * a + P1 * b) % P : P2 * a + b;
  }
  __host__ __device__ __forceinline__ int out(int k1, int k2) const {
    return pfa ? (e1 * k1 + e2 * k2) % P : k1 + P1 * k2;
  }
  __host__ __device__ __forceinline__ int part(int q) const {
    return slot(q % P1, pfa ? q % P2 : q / P1);
  }
  __host__ __device__ __forceinline__ int lane(int j) const {
    return 64 * part(j % P) + j / P;
  }
};

// The plan at P = 8 .. 16 (P1 = 0 elsewhere): ops/cuda/planes_fft.py
// FACTORS; e1 = P2 (P2^-1 mod P1) and e2 = P1 (P1^-1 mod P2) by the
// prime-factor map, which puts output q at (q mod P1, q mod P2).
__host__ __device__ __forceinline__ Plan plan_of(int P) {
  int P1 = 0, P2 = 1;
  switch (P) {
    case 8: P1 = 8; break;
    case 9: P1 = 3, P2 = 3; break;
    case 10: P1 = 2, P2 = 5; break;
    case 11: P1 = 11; break;
    case 12: P1 = 4, P2 = 3; break;
    case 13: P1 = 13; break;
    case 14: P1 = 2, P2 = 7; break;
    case 15: P1 = 3, P2 = 5; break;
    case 16: P1 = 4, P2 = 4; break;
    default: break;
  }
  int g = P1, h = P2;
  while (h) { const int t = g % h; g = h; h = t; }
  const int pfa = P2 > 1 && g == 1;
  int e1 = 0, e2 = 0;
  if (pfa) {
    int i1 = 1, i2 = 1;
    while (P2 * i1 % P1 != 1) ++i1;
    while (P1 * i2 % P2 != 1) ++i2;
    e1 = P2 * i1 % P;
    e2 = P1 * i2 % P;
  }
  return Plan{P, P1, P2, pfa, e1, e2};
}

// The plan's maps as tables, in a block's shared memory, so the passes
// index them in place of the run-time divisions: slot[a P2 + b], out[k1
// P2 + k2], part[q] and chan[s] (the sub-FFT q in part s). A kernel fills
// them once (fill_tabs, threads 0 .. 15) before its first barrier.
struct PlanTabs {
  int slot[16], out[16], part[16], chan[16];
};

__device__ __forceinline__ void fill_tabs(PlanTabs& tb, const Plan& pl,
                                          int tid) {
  if (tid < pl.P) {
    const int a = tid / pl.P2, b = tid % pl.P2;
    tb.slot[tid] = pl.slot(a, b);
    tb.out[tid] = pl.out(a, b);
    tb.part[tid] = pl.part(tid);
    tb.chan[pl.part(tid)] = tid;
  }
}

// An F-point DFT in place (F = 2, 3, 4, 5, 7, 8, 11, 13), its constants
// from the table of M channels: cos(pi/4) at M/8, sin(pi/3) at M/3, and
// the cos and sin of 2 pi a / F at a M/F.
template <int F>
__device__ __forceinline__ void dft_f(float* xr, float* xi, const float* tab,
                                      int M) {
  if constexpr (F == 2 || F == 4) {
    dftp<F>(xr, xi, 0.f);
  } else if constexpr (F == 3) {
    dftp<3>(xr, xi, -__ldg(tab + 3 * M + M / 3));
  } else if constexpr (F == 8) {
    dft8(xr, xi, __ldg(tab + 2 * M + M / 8));
  } else {
    dft_odd<F>(xr, xi, TabCosSin{tab + 2 * M, tab + 3 * M, M / F});
  }
}

// Pass 1, F = P1: column n of part group j2 of row r a thread; at P2 = 1
// also the radix twiddles W_M^(n k) of its outputs k > 0.
template <int F>
__device__ __forceinline__ void radix_pass1(float* tile, int rows, int tid,
                                            int threads, const float* tab,
                                            const Plan& pl,
                                            const PlanTabs& tb) {
  const int M = 64 * pl.P, W = 2 * M, P2 = pl.P2, n = tid & 63;
  for (int rb = tid >> 6; rb < rows * P2; rb += threads >> 6) {
    const int r = rb / P2, b = rb - r * P2;
    float* row = tile + r * W;
    float xr[F], xi[F];
#pragma unroll
    for (int a = 0; a < F; ++a) {
      const int i = sw(r, n + 64 * tb.slot[a * P2 + b]);
      xr[a] = row[i];
      xi[a] = row[M + i];
    }
    dft_f<F>(xr, xi, tab, M);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      if (P2 == 1 && k > 0)
        cmul(xr[k], xi[k], __ldg(tab + 2 * M + n * k), __ldg(tab + 3 * M + n * k));
      const int i = sw(r, n + 64 * tb.slot[k * P2 + b]);
      row[i] = xr[k];
      row[M + i] = xi[k];
    }
  }
}

// Pass 2, F = P2: column n of part group k1 of row r a thread: the
// twiddles W_P^(j2 k1) (none by the prime-factor map), the F-point DFT,
// the radix twiddles W_M^(n q) of its outputs q > 0.
template <int F>
__device__ __forceinline__ void radix_pass2(float* tile, int rows, int tid,
                                            int threads, const float* tab,
                                            const Plan& pl,
                                            const PlanTabs& tb) {
  const int M = 64 * pl.P, W = 2 * M, P1 = pl.P1, n = tid & 63;
  for (int rk = tid >> 6; rk < rows * P1; rk += threads >> 6) {
    const int r = rk / P1, k1 = rk - r * P1;
    float* row = tile + r * W;
    float xr[F], xi[F];
#pragma unroll
    for (int b = 0; b < F; ++b) {
      const int i = sw(r, n + 64 * tb.slot[k1 * F + b]);
      xr[b] = row[i];
      xi[b] = row[M + i];
    }
    if (!pl.pfa && k1 > 0) {
#pragma unroll
      for (int b = 1; b < F; ++b)
        cmul(xr[b], xi[b], __ldg(tab + 2 * M + 64 * b * k1),
             __ldg(tab + 3 * M + 64 * b * k1));
    }
    dft_f<F>(xr, xi, tab, M);
#pragma unroll
    for (int k2 = 0; k2 < F; ++k2) {
      const int q = tb.out[k1 * F + k2];
      if (q > 0)
        cmul(xr[k2], xi[k2], __ldg(tab + 2 * M + n * q), __ldg(tab + 3 * M + n * q));
      const int i = sw(r, n + 64 * tb.slot[k1 * F + k2]);
      row[i] = xr[k2];
      row[M + i] = xi[k2];
    }
  }
}

// The planes DFT of `rows` rows of the tile (rows of 2M floats, swizzled,
// rows a multiple of 4, M = 64 pl.P) by all `threads` threads of the
// block (a multiple of 64), thread tid, the plan's tables tb filled; the
// caller has synchronised the block before. Row r's output j is left at
// logical lane pl.lane(j) of row r (j = P (k & 63) + tb.chan[k >> 6] at
// lane k); a __syncthreads() comes before it is read.
__device__ __forceinline__ void fft_tile_rt(float* tile, int rows, int tid,
                                            int threads, const float* tab,
                                            const Plan& pl,
                                            const PlanTabs& tb) {
  const int P = pl.P, M = 64 * P, W = 2 * M;
  switch (pl.P1) {
    case 2: radix_pass1<2>(tile, rows, tid, threads, tab, pl, tb); break;
    case 3: radix_pass1<3>(tile, rows, tid, threads, tab, pl, tb); break;
    case 4: radix_pass1<4>(tile, rows, tid, threads, tab, pl, tb); break;
    case 8: radix_pass1<8>(tile, rows, tid, threads, tab, pl, tb); break;
    case 11: radix_pass1<11>(tile, rows, tid, threads, tab, pl, tb); break;
    default: radix_pass1<13>(tile, rows, tid, threads, tab, pl, tb); break;
  }
  if (pl.P2 > 1) {
    __syncthreads();
    switch (pl.P2) {
      case 3: radix_pass2<3>(tile, rows, tid, threads, tab, pl, tb); break;
      case 4: radix_pass2<4>(tile, rows, tid, threads, tab, pl, tb); break;
      case 5: radix_pass2<5>(tile, rows, tid, threads, tab, pl, tb); break;
      default: radix_pass2<7>(tile, rows, tid, threads, tab, pl, tb); break;
    }
  }
  __syncthreads();
  // (b) sub-FFT q of rows 4 g .. 4 g + 3 in part pl.part(q), one task a
  // warp, as fft_tile_wide's
  const int t = tid & 7, lane_row = (tid >> 3) & 3;
  float in_re[8], in_im[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    in_re[i] = __ldg(tab + t * 8 + i);
    in_im[i] = __ldg(tab + M + t * 8 + i);
  }
  const float c = __ldg(tab + 2 * M + M / 8);
  for (int task = tid >> 5; task < (rows / 4) * P; task += threads >> 5) {
    const int g = task / P, q = task - g * P, r = 4 * g + lane_row, s = r & 3;
    const int base = 64 * tb.part[q];
    float* row = tile + r * W;
    float xr[8], xi[8];
#pragma unroll
    for (int n2 = 0; n2 < 8; ++n2) {
      const int i = sw(r, base + t + 8 * n2);
      xr[n2] = row[i];
      xi[n2] = row[M + i];
    }
    dft8(xr, xi, c);  // A[t][k1], k1 = 0..7
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) cmul(xr[k1], xi[k1], in_re[k1], in_im[k1]);
    __syncwarp();
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      const int i = base + xch(s, t, k1);
      row[i] = xr[k1];
      row[M + i] = xi[k1];
    }
    __syncwarp();
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int i = base + xch(s, n1, t);
      xr[n1] = row[i];
      xi[n1] = row[M + i];
    }
    __syncwarp();
    dft8(xr, xi, c);  // X[P (t + 8 k2) + q], k2 = 0..7
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2) {
      const int j = P * (t + 8 * k2) + q;
      cmul(xr[k2], xi[k2], __ldg(tab + 2 * M + j), __ldg(tab + 3 * M + j));
      const int i = sw(r, base + t + 8 * k2);
      row[i] = xr[k2];
      row[M + i] = xi[k2];
    }
  }
}

}  // namespace planes_fft
