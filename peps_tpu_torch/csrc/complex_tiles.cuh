// Complex tile products of the complex bodies of K1 (col_transfer.cu) and K3
// (pair_transfer.cu), one copy for both. A value is float2 / double2: (re,
// im) interleaved, the layout of torch.complex64 / torch.complex128; there is
// no conjugate anywhere. A CTA has kThreads threads; a product P = X^T Y has
// both operands K-major in shared memory (X [K][M], Y [K][N], each row's
// values contiguous), and its values go to dst[ro[m] + co[n]] through
// per-CTA offset tables.
//
//  - complex64, on the FP32 CUDA cores: each thread owns a 4 x 4 complex
//    tile, the lanes of a warp a block of 16 x 32 (lane & 3 the rows, lane >>
//    2 the columns), so each k-step loads two 32-byte fragments, which a
//    quarter-warp reads as 4 and 2 distinct chunks on distinct bank groups,
//    and issues 64 FMAs (four real FMAs a complex multiply-add).
//  - complex128, on the DMMA tensor cores: mma.sync.m16n8k8.f64 (the m8n8k4
//    shape reaches only half the DMMA peak on the H100), four real MMAs a
//    complex tile product, the imaginary part of the A fragment negated in
//    registers for the real output; each fragment value is one 16-byte load
//    of (re, im), so a leading dim of 2 mod 8 elements puts a quarter-warp's
//    loads (row lane & 3, column lane >> 2) on 8 distinct bank groups. K is
//    padded to 8 with zeroed rows; columns past M or N are read and dropped.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cx_tiles {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

// PTX helpers.
// c += a b on one 16 x 8 x 8 tile: lane l (g = l >> 2, q = l & 3) holds
// a = A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4], b = B[q][g],
// B[q + 4][g], c = C[g][2q], C[g][2q + 1], C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void dmma16(double (&c)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=d"(c[0]), "=d"(c[1]), "=d"(c[2]), "=d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]),
        "d"(c[0]), "d"(c[1]), "d"(c[2]), "d"(c[3]));
}
// End of PTX helpers.

// ------------------------------------- complex64: SIMT complex products --

// Four complex values (32 bytes) as two 16-byte loads.
__device__ __forceinline__ void load_cx4(float2 (&v)[4], const float2* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = make_float2(a.x, a.y);
  v[1] = make_float2(a.z, a.w);
  v[2] = make_float2(b.x, b.y);
  v[3] = make_float2(b.z, b.w);
}

// acc[i][j] += x[i] y[j]: four real FMAs a complex multiply-add.
__device__ __forceinline__ void cfma_tile(float2 (&acc)[4][4],
                                          const float2 (&x)[4],
                                          const float2 (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j].x = fmaf(x[i].x, y[j].x, acc[i][j].x);
      acc[i][j].x = fmaf(-x[i].y, y[j].y, acc[i][j].x);
      acc[i][j].y = fmaf(x[i].x, y[j].y, acc[i][j].y);
      acc[i][j].y = fmaf(x[i].y, y[j].x, acc[i][j].y);
    }
}

// acc[4][4] += sum_k x[k][0:4] y[k][0:4], x and y K-major complex in shared
// memory and offset to the tile: 64 FMAs per 16 floats loaded; the next k's
// fragments load before this k's FMAs.
__device__ __forceinline__ void csimt_acc(float2 (&acc)[4][4], const float2* x,
                                          int ldx, const float2* y, int ldy,
                                          int K) {
  if (K <= 0) return;
  float2 x0[4], y0[4], x1[4], y1[4];
  load_cx4(x0, x);
  load_cx4(y0, y);
  for (int k = 0; k < K; k += 2) {
    const bool two = k + 1 < K;
    if (two) {
      load_cx4(x1, x + ldx);
      load_cx4(y1, y + ldy);
    }
    cfma_tile(acc, x0, y0);
    x += 2 * ldx;
    y += 2 * ldy;
    if (k + 2 < K) {
      load_cx4(x0, x);
      load_cx4(y0, y);
    }
    if (two) cfma_tile(acc, x1, y1);
  }
}

// The origin (m0, n0) of the thread's 4 x 4 tile in warp block s (16 x 32)
// of a product with n_sm blocks along M: lane & 3 picks the rows and lane
// >> 2 the columns, so that a quarter-warp reads 4 X fragments and 2 Y
// fragments, each 32 contiguous bytes, on distinct bank groups.
__device__ __forceinline__ void cx_tile_of(int s, int n_sm, int& m0,
                                           int& n0) {
  const int lane = threadIdx.x & 31;
  m0 = (s % n_sm) * 16 + (lane & 3) * 4;
  n0 = (s / n_sm) * 32 + (lane >> 2) * 4;
}

// P[m][n] -> dst[ro[m] + co[n]] for the tile at (m0, n0), m0 < M, n0 < N:
// 16 bytes (two values) a store along n, or along m, where the tile's pairs
// of positions are contiguous and aligned there, else 8. With kStagger, the
// lanes whose bit 2 is set store their two pairs along m in the other order:
// where the 16 rows of a warp block are contiguous in dst, a quarter-warp's
// two column groups then fill the even and the odd bank groups in each
// store.
template <bool kStagger = false>
__device__ __forceinline__ void cx_store(const float2 (&acc)[4][4], int m0,
                                         int n0, int M, int N, float2* dst,
                                         const int* ro, const int* co) {
  const bool vn = n0 + 4 <= N && co[n0 + 1] == co[n0] + 1 &&
                  co[n0 + 3] == co[n0 + 2] + 1;
  const bool vm = !vn && m0 + 4 <= M && ro[m0 + 1] == ro[m0] + 1 &&
                  ro[m0 + 3] == ro[m0 + 2] + 1;
  if (vn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + i >= M) continue;
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        float2* const d = dst + ro[m0 + i] + co[n0 + h];
        if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
          *reinterpret_cast<float4*>(d) = make_float4(
              acc[i][h].x, acc[i][h].y, acc[i][h + 1].x, acc[i][h + 1].y);
        } else {
          d[0] = acc[i][h];
          d[1] = acc[i][h + 1];
        }
      }
    }
  } else if (vm) {
    const bool flip = kStagger && (threadIdx.x & 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j >= N) continue;
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        const float2 a = flip ? acc[2 - h][j] : acc[h][j];
        const float2 b = flip ? acc[3 - h][j] : acc[h + 1][j];
        float2* const d = dst + ro[m0 + (flip ? 2 - h : h)] + co[n0 + j];
        if ((reinterpret_cast<uintptr_t>(d) & 15) == 0) {
          *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
        } else {
          d[0] = a;
          d[1] = b;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m0 + i < M && n0 + j < N) dst[ro[m0 + i] + co[n0 + j]] = acc[i][j];
  }
}

// dst <- X^T Y for an M x N complex product (K-major operands in shared
// memory), warp blocks of 16 x 32, 4 x 4 tiles per thread.
template <bool kStagger = false>
__device__ __forceinline__ void cx_product(const float2* X, int ldx,
                                           const float2* Y, int ldy, int K,
                                           int M, int N, float2* dst,
                                           const int* ro, const int* co) {
  const int n_sm = cdiv(M, 16), total = n_sm * cdiv(N, 32);
  for (int s = threadIdx.x >> 5; s < total; s += kWarps) {
    int m0, n0;
    cx_tile_of(s, n_sm, m0, n0);
    if (m0 >= M || n0 >= N) continue;
    float2 acc[4][4] = {};
    csimt_acc(acc, X + m0, ldx, Y + n0, ldy, K);
    cx_store<kStagger>(acc, m0, n0, M, N, dst, ro, co);
  }
}

// ------------------------------ complex128: m16n8k8 DMMA tensor cores --

// A warp's fragments of WM x WN tiles at one k-step of 8: x and y point at
// the lane's first value (row lane & 3 of K, column lane >> 2 of the tile);
// each value is one 16-byte load of (re, im).
template <int WM, int WN>
__device__ __forceinline__ void zmma_frags(double2 (&a)[WM][4],
                                           double2 (&b)[WN][2],
                                           const double2* x, int ldx,
                                           const double2* y, int ldy) {
#pragma unroll
  for (int i = 0; i < WM; ++i) {
    a[i][0] = x[16 * i];
    a[i][1] = x[16 * i + 8];
    a[i][2] = x[4 * ldx + 16 * i];
    a[i][3] = x[4 * ldx + 16 * i + 8];
  }
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    b[j][0] = y[8 * j];
    b[j][1] = y[4 * ldy + 8 * j];
  }
}

// c += a b in complex arithmetic on one 16 x 8 x 8 tile: four real MMAs,
// c[0] += ar br + (-ai) bi and c[1] += ar bi + ai br, a's imaginary part
// negated in registers.
__device__ __forceinline__ void zmma(double (&c)[2][4], const double2 (&a)[4],
                                     const double2 (&b)[2]) {
  const double ar[4] = {a[0].x, a[1].x, a[2].x, a[3].x};
  const double ai[4] = {a[0].y, a[1].y, a[2].y, a[3].y};
  const double an[4] = {-a[0].y, -a[1].y, -a[2].y, -a[3].y};
  const double br[2] = {b[0].x, b[1].x};
  const double bi[2] = {b[0].y, b[1].y};
  dmma16(c[0], ar, br);
  dmma16(c[0], an, bi);
  dmma16(c[1], ar, bi);
  dmma16(c[1], ai, br);
}

// acc += the warp tile's complex product, K a multiple of 8; with kPrefetch
// the next k-step's fragments load before this one's MMAs (a caller that
// keeps large accumulators live goes without, to stay inside the 255
// registers a thread has).
template <int WM, int WN, bool kPrefetch = true>
__device__ __forceinline__ void zmma_acc(double (&acc)[WM][WN][2][4],
                                         const double2* x, int ldx,
                                         const double2* y, int ldy, int K) {
  if (K <= 0) return;
  const int sx = 8 * ldx, sy = 8 * ldy;
  if constexpr (!kPrefetch) {
    double2 a[WM][4], b[WN][2];
    for (int k = 0; k < K; k += 8, x += sx, y += sy) {
      zmma_frags<WM, WN>(a, b, x, ldx, y, ldy);
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) zmma(acc[i][j], a[i], b[j]);
    }
    return;
  }
  double2 a0[WM][4], b0[WN][2], a1[WM][4], b1[WN][2];
  zmma_frags<WM, WN>(a0, b0, x, ldx, y, ldy);
  for (int k = 0; k < K; k += 16) {
    const bool two = k + 8 < K;
    if (two) zmma_frags<WM, WN>(a1, b1, x + sx, ldx, y + sy, ldy);
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) zmma(acc[i][j], a0[i], b0[j]);
    x += 2 * sx;
    y += 2 * sy;
    if (k + 16 < K) zmma_frags<WM, WN>(a0, b0, x, ldx, y, ldy);
    if (two) {
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) zmma(acc[i][j], a1[i], b1[j]);
    }
  }
}

// Where value v (0-3) of a lane's accumulator fragment lies in its 16 x 8
// tile: row g + 8 (v >> 1), column 2 q + (v & 1).
__device__ __forceinline__ int zrow(int lane, int v) {
  return (lane >> 2) + 8 * (v >> 1);
}
__device__ __forceinline__ int zcol(int lane, int v) {
  return 2 * (lane & 3) + (v & 1);
}

// dst <- X^T Y for an M x N complex product (K-major operands in shared
// memory, K padded to 8), warp tiles of WM x WN MMA tiles of 16 x 8; P[m][n]
// -> dst[ro[m] + co[n]].
template <int WM, int WN>
__device__ __forceinline__ void zmma_product(const double2* X, int ldx,
                                             const double2* Y, int ldy, int K,
                                             int M, int N, double2* dst,
                                             const int* ro, const int* co) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_wm = cdiv(M, 16 * WM), n_wn = cdiv(N, 8 * WN);
  for (int w = warp; w < n_wm * n_wn; w += kWarps) {
    const int m0 = (w % n_wm) * 16 * WM, n0 = (w / n_wm) * 8 * WN;
    double acc[WM][WN][2][4] = {};
    zmma_acc<WM, WN>(acc, X + q * ldx + m0 + g, ldx, Y + q * ldy + n0 + g,
                     ldy, K);
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int m = m0 + 16 * i + zrow(lane, v);
          const int n = n0 + 8 * j + zcol(lane, v);
          if (m < M && n < N)
            dst[ro[m] + co[n]] = make_double2(acc[i][j][0][v],
                                              acc[i][j][1][v]);
        }
  }
}

}  // namespace cx_tiles
