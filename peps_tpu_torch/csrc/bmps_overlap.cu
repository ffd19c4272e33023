// K5: the closure of a top-type and a bottom-type boundary MPS on one
// horizontal bond layer, hand-written for Hopper (sm_90a).
//
// Replaces: peps_tpu/algorithm/measure_fermion.py:_bmps_overlap (386), a
// lax.scan over the columns that XLA fused on the TPU:
//
//   m_0 = e0 e0^T
//   m_{x+1}[b, d] = sum_{a,c,v} m_x[a, c] A[x][a, v, b] B[x][c, v, d] / n_x
//   n_x = max(||.||_F, tiny),   log_w = sum_x log n_x
//
// returning (m_Lx[0, 0], log_w) per item. A and B are [Lx, chi, D, chi]
// slabs; an item's B slab may be shared by other items (batch stride 0: one
// excited bottom serves every start lane of its column).
//
// What bounds it: operations. Each column is 2 chi^3 D multiply-adds (four
// real FMAs each for complex) on chi D chi inputs from each operand.
//
// Design (the staged body). One CTA takes the items ("lanes") that share a
// B slab, up to the plan's lanes a CTA, and keeps each lane's m and its
// column accumulator in shared memory across all Lx columns, so a whole
// scan is one launch. A column runs per vertical index v as two products
// on chi x chi slabs staged in shared memory:
//   T[c, b]    = sum_a m[a, c] A[x][a, v, b]      (T = m^T A_v)
//   acc[b, d] += sum_c T[c, b] B[x][c, v, d]      (acc += T^T B_v)
// B_v is staged once per v for all the CTA's lanes; each lane's A_v
// follows. Both arrive by cp.async into two buffers, so the next (v, lane)
// stage lands while this one is multiplied (one buffer where two do not
// fit); T alternates between two buffers, so a stage takes two barriers.
// The products: f32 and complex64 a TS x TS register tile a thread
// (TS = chi_p / 16, chi padded to chi_p, a multiple of 16, with zeros),
// fed from shared memory; f64 and complex128 mma.sync.m16n8k8.f64 tiles of
// 16 x 8 dealt over the warps (complex128: four real MMAs a complex tile
// product, complex_tiles.cuh). Then the Frobenius norm of each lane's acc
// by warp shuffles and a block reduction, and m = acc / n. The plan (lanes
// a CTA, buffers, shared bytes) is chosen in Python
// (kernels/bmps_overlap.py:overlap_plan).
//
// The simple body (the kernel's first body; the plan takes it only where
// the staged body's buffers do not fit a CTA, complex128 at chi > 48): one
// CTA an item, m and one T_v in shared memory, operands read from global
// memory in the product loops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "complex_ops.cuh"
#include "complex_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 16;       // chi^2 <= kThreads * kMaxOut: chi <= 64
constexpr int kMaxBatch = 4;
constexpr int kMaxLanes = 16;     // lanes a CTA of the staged body
// meta layout (int64), written by kernels/bmps_overlap.py
constexpr int kMetaLen = 3 * kMaxBatch + 3 + kMaxBatch + 6;

struct OverlapMeta {
  int64_t size[kMaxBatch];        // batch sizes, leading 1s for unused dims
  int64_t sa[kMaxBatch];          // a's batch strides in elements
  int64_t sb[kMaxBatch];          // b's batch strides in elements
  int64_t lx, chi, dv;
  int32_t lane[kMaxBatch];        // 1: a lane dim (b broadcast over it)
  int32_t body, lanes, nbuf, vec, chi_p;   // the plan
  int64_t lane_items, groups, chunks;      // lanes a group, chunks a group
};

// PTX helpers.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n groups are pending
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// End of PTX helpers.

template <typename T> struct Real { using type = T; };
template <> struct Real<float2> { using type = float; };
template <> struct Real<double2> { using type = double; };

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return cx_zero<float2>();
}
template <> __device__ __forceinline__ double2 zero<double2>() {
  return cx_zero<double2>();
}

template <typename T> __device__ __forceinline__ T one() { return T(1); }
template <> __device__ __forceinline__ float2 one<float2>() {
  return make_float2(1.f, 0.f);
}
template <> __device__ __forceinline__ double2 one<double2>() {
  return make_double2(1.0, 0.0);
}

// acc + x y: one FMA real, four complex
__device__ __forceinline__ float fma_(float acc, float x, float y) {
  return fmaf(x, y, acc);
}
__device__ __forceinline__ double fma_(double acc, double x, double y) {
  return fma(x, y, acc);
}
__device__ __forceinline__ float2 fma_(float2 acc, float2 x, float2 y) {
  acc.x = fmaf(x.x, y.x, acc.x);
  acc.x = fmaf(-x.y, y.y, acc.x);
  acc.y = fmaf(x.x, y.y, acc.y);
  acc.y = fmaf(x.y, y.x, acc.y);
  return acc;
}
__device__ __forceinline__ double2 fma_(double2 acc, double2 x, double2 y) {
  acc.x = fma(x.x, y.x, acc.x);
  acc.x = fma(-x.y, y.y, acc.x);
  acc.y = fma(x.x, y.y, acc.y);
  acc.y = fma(x.y, y.x, acc.y);
  return acc;
}

__device__ __forceinline__ float abs2(float v) { return v * v; }
__device__ __forceinline__ double abs2(double v) { return v * v; }
__device__ __forceinline__ float abs2(float2 v) { return v.x * v.x + v.y * v.y; }
__device__ __forceinline__ double abs2(double2 v) {
  return v.x * v.x + v.y * v.y;
}

__device__ __forceinline__ float scale(float v, float s) { return v * s; }
__device__ __forceinline__ double scale(double v, double s) { return v * s; }
__device__ __forceinline__ float2 scale(float2 v, float s) {
  return cx_scale(v, s);
}
__device__ __forceinline__ double2 scale(double2 v, double s) {
  return cx_scale(v, s);
}

__device__ __forceinline__ float tiny_of(float) { return 1.17549435e-38f; }
__device__ __forceinline__ double tiny_of(double) {
  return 2.2250738585072014e-308;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
overlap_simple(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ mant, typename Real<T>::type* __restrict__ logw,
               OverlapMeta m) {
  using R = typename Real<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chi = static_cast<int>(m.chi);
  const int dv = static_cast<int>(m.dv);
  const int n2 = chi * chi;
  T* sm = reinterpret_cast<T*>(smem_raw);          // m [a, c], chi^2
  T* st = sm + n2;                                 // T_v [c, b], chi^2
  R* red = reinterpret_cast<R*>(st + n2);          // kThreads / 32 partials

  // this item's slabs
  int64_t rest = blockIdx.x, off_a = 0, off_b = 0;
  for (int k = kMaxBatch - 1; k >= 0; --k) {
    const int64_t i = rest % m.size[k];
    rest /= m.size[k];
    off_a += i * m.sa[k];
    off_b += i * m.sb[k];
  }
  const T* pa = a + off_a;
  const T* pb = b + off_b;
  const int64_t col = static_cast<int64_t>(chi) * dv * chi;

  for (int o = threadIdx.x; o < n2; o += kThreads)
    sm[o] = o == 0 ? one<T>() : zero<T>();
  R log_acc = 0;
  __syncthreads();

  for (int64_t x = 0; x < m.lx; ++x) {
    const T* ax = pa + x * col;
    const T* bx = pb + x * col;
    T acc[kMaxOut];
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) acc[j] = zero<T>();
    for (int v = 0; v < dv; ++v) {
      // T_v[c, b] = sum_a m[a, c] A[a, v, b]
      for (int o = threadIdx.x; o < n2; o += kThreads) {
        const int c = o / chi, bb = o - c * chi;
        T s = zero<T>();
        const T* ap = ax + static_cast<int64_t>(v) * chi + bb;
        for (int aa = 0; aa < chi; ++aa)
          s = fma_(s, sm[aa * chi + c], ap[static_cast<int64_t>(aa) * dv * chi]);
        st[o] = s;
      }
      __syncthreads();
      // acc[b, d] += sum_c T_v[c, b] B[c, v, d]
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        const int o = threadIdx.x + j * kThreads;
        if (o < n2) {
          const int bb = o / chi, d = o - bb * chi;
          const T* bp = bx + static_cast<int64_t>(v) * chi + d;
          T s = acc[j];
          for (int c = 0; c < chi; ++c)
            s = fma_(s, st[c * chi + bb], bp[static_cast<int64_t>(c) * dv * chi]);
          acc[j] = s;
        }
      }
      __syncthreads();
    }
    // n = max(||acc||_F, tiny); m = acc / n
    R part = 0;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j)
      if (threadIdx.x + j * kThreads < n2) part += abs2(acc[j]);
    for (int s = 16; s > 0; s >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, s);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
    __syncthreads();
    R total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    const R nrm = fmax(sqrt(total), tiny_of(total));
    const R inv = R(1) / nrm;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = threadIdx.x + j * kThreads;
      if (o < n2) sm[o] = scale(acc[j], inv);
    }
    log_acc += log(nrm);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    mant[blockIdx.x] = sm[0];
    logw[blockIdx.x] = log_acc;
  }
}

// ------------------------------------------------------- the staged body

// an element copy of 4, 8 or 16 bytes
template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 16)
    cp_async16(dst, src);
  else if constexpr (sizeof(T) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}

// Copy a chi x chi slab (rows `row` apart in global memory, each row chi
// contiguous values) into shared rows of leading dim ld: 16-byte copies
// where vec (rows 16-byte aligned, chi * sizeof(T) a multiple of 16),
// else one element a copy.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      int64_t row, int chi, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const int rc = chi / per;
    for (int e = threadIdx.x; e < chi * rc; e += kThreads) {
      const int r = e / rc, c = (e - r * rc) * per;
      cp_async16(dst + r * ld + c, src + r * row + c);
    }
  } else {
    for (int e = threadIdx.x; e < chi * chi; e += kThreads) {
      const int r = e / chi, c = e - r * chi;
      cp_elem(dst + r * ld + c, src + r * row + c);
    }
  }
}

// dst[i][j] (+)= sum_k X[k][i] Y[k][j] over chi_p x chi_p, K-major operands
// of leading dim ld: a TS x TS register tile a thread (f32, complex64).
template <typename T, int TS>
__device__ __forceinline__ void prod_simt(const T* X, const T* Y, int ld,
                                          int K, T* dst, bool accumulate) {
  const int tj = threadIdx.x & 15, ti = threadIdx.x >> 4;
  const int i0 = ti * TS, j0 = tj * TS;
  T acc[TS][TS];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int j = 0; j < TS; ++j)
      acc[i][j] = accumulate ? dst[(i0 + i) * ld + j0 + j] : zero<T>();
  for (int k = 0; k < K; ++k) {
    T x[TS], y[TS];
#pragma unroll
    for (int i = 0; i < TS; ++i) x[i] = X[k * ld + i0 + i];
#pragma unroll
    for (int j = 0; j < TS; ++j) y[j] = Y[k * ld + j0 + j];
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) acc[i][j] = fma_(acc[i][j], x[i], y[j]);
  }
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int j = 0; j < TS; ++j) dst[(i0 + i) * ld + j0 + j] = acc[i][j];
}

// The same product on mma.sync.m16n8k8.f64 (f64, complex128): 16 x 8 tiles
// dealt over the warps, K a multiple of 8.
__device__ __forceinline__ void mma_tile(double (&c)[4], const double* X,
                                         const double* Y, int ld, int K,
                                         int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const double* x = X + (k0 + q) * ld + m0 + g;
    const double* y = Y + (k0 + q) * ld + n0 + g;
    const double a[4] = {x[0], x[8], x[4 * ld], x[4 * ld + 8]};
    const double b[2] = {y[0], y[4 * ld]};
    cx_tiles::dmma16(c, a, b);
  }
}

__device__ __forceinline__ void mma_tile(double (&c)[2][4], const double2* X,
                                         const double2* Y, int ld, int K,
                                         int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const double2* x = X + (k0 + q) * ld + m0 + g;
    const double2* y = Y + (k0 + q) * ld + n0 + g;
    const double2 a[4] = {x[0], x[8], x[4 * ld], x[4 * ld + 8]};
    const double2 b[2] = {y[0], y[4 * ld]};
    cx_tiles::zmma(c, a, b);
  }
}

__device__ __forceinline__ void frag_set(double (&c)[4], const double* d,
                                         int ld, int m0, int n0, bool load) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    c[v] = load ? d[(m0 + g + 8 * (v >> 1)) * ld + n0 + 2 * q + (v & 1)] : 0.0;
}
__device__ __forceinline__ void frag_set(double (&c)[2][4], const double2* d,
                                         int ld, int m0, int n0, bool load) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const double2 e = load ? d[(m0 + g + 8 * (v >> 1)) * ld + n0 + 2 * q +
                               (v & 1)]
                           : make_double2(0.0, 0.0);
    c[0][v] = e.x;
    c[1][v] = e.y;
  }
}
__device__ __forceinline__ void frag_put(const double (&c)[4], double* d,
                                         int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    d[(m0 + g + 8 * (v >> 1)) * ld + n0 + 2 * q + (v & 1)] = c[v];
}
__device__ __forceinline__ void frag_put(const double (&c)[2][4], double2* d,
                                         int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    d[(m0 + g + 8 * (v >> 1)) * ld + n0 + 2 * q + (v & 1)] =
        make_double2(c[0][v], c[1][v]);
}

template <typename T> struct Frag { using type = double[4]; };
template <> struct Frag<double2> { using type = double[2][4]; };

template <typename T>
__device__ __forceinline__ void prod_mma(const T* X, const T* Y, int ld,
                                         int K, int chi_p, T* dst,
                                         bool accumulate) {
  const int nti = chi_p / 16, nt = nti * (chi_p / 8);
  for (int t = threadIdx.x >> 5; t < nt; t += kWarps) {
    const int m0 = (t % nti) * 16, n0 = (t / nti) * 8;
    typename Frag<T>::type c;
    frag_set(c, dst, ld, m0, n0, accumulate);
    mma_tile(c, X, Y, ld, K, m0, n0);
    frag_put(c, dst, ld, m0, n0);
  }
}

// f64 and complex128 take the DMMA tensor cores, f32 and complex64 the FP32
// CUDA cores; the padding of the leading dims (elements) keeps each row
// 16-byte aligned and puts the MMA fragment loads on distinct banks
template <typename T> struct Staged;
template <> struct Staged<float> { static constexpr bool mma = false; static constexpr int pad = 4; };
template <> struct Staged<float2> { static constexpr bool mma = false; static constexpr int pad = 2; };
template <> struct Staged<double> { static constexpr bool mma = true; static constexpr int pad = 4; };
template <> struct Staged<double2> { static constexpr bool mma = true; static constexpr int pad = 2; };

template <typename T>
__device__ __forceinline__ void product(const T* X, const T* Y, int ld,
                                        int chi, int chi_p, T* dst,
                                        bool accumulate) {
  if constexpr (Staged<T>::mma) {
    prod_mma<T>(X, Y, ld, (chi + 7) / 8 * 8, chi_p, dst, accumulate);
  } else {
    switch (chi_p / 16) {
      case 1: prod_simt<T, 1>(X, Y, ld, chi, dst, accumulate); break;
      case 2: prod_simt<T, 2>(X, Y, ld, chi, dst, accumulate); break;
      case 3: prod_simt<T, 3>(X, Y, ld, chi, dst, accumulate); break;
      default: prod_simt<T, 4>(X, Y, ld, chi, dst, accumulate); break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
overlap_staged(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ mant, typename Real<T>::type* __restrict__ logw,
               const __grid_constant__ OverlapMeta m) {
  using R = typename Real<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chi = static_cast<int>(m.chi), dv = static_cast<int>(m.dv);
  const int chi_p = m.chi_p, ld = chi_p + Staged<T>::pad;
  const int blk = chi_p * ld;
  const int nbuf = m.nbuf;
  // this CTA's group and lanes
  const int64_t group = blockIdx.x / m.chunks;
  const int l0 = static_cast<int>(blockIdx.x % m.chunks) * m.lanes;
  const int nl = static_cast<int>(
      min(static_cast<int64_t>(m.lanes), m.lane_items - l0));
  T* sm_m = reinterpret_cast<T*>(smem_raw);   // nl x blk: m of each lane
  T* sm_acc = sm_m + m.lanes * blk;           // nl x blk: the accumulators
  T* sm_b = sm_acc + m.lanes * blk;           // nbuf x blk: B_v
  T* sm_a = sm_b + nbuf * blk;                // nbuf x blk: A_v of a lane
  T* sm_t = sm_a + nbuf * blk;                // 2 x blk: T, by stage parity
  R* red = reinterpret_cast<R*>(sm_t + 2 * blk);  // kWarps partial sums
  R* logs = red + kWarps;                     // nl log weights

  // offsets: b's from the group, a's and the output's from each lane
  int64_t off_b = 0, off_a[kMaxLanes], out_i[kMaxLanes];
  {
    int64_t g = group, lin = 0, stride = 1;
    int64_t idx[kMaxBatch];
    for (int d = kMaxBatch - 1; d >= 0; --d) {
      if (!m.lane[d]) {
        idx[d] = g % m.size[d];
        g /= m.size[d];
      } else {
        idx[d] = 0;
      }
    }
    for (int d = 0; d < kMaxBatch; ++d) off_b += idx[d] * m.sb[d];
    for (int l = 0; l < kMaxLanes; ++l) {
      off_a[l] = 0;
      out_i[l] = 0;
      if (l >= nl) continue;
      int64_t r = l0 + l;
      int64_t id[kMaxBatch];
      for (int d = kMaxBatch - 1; d >= 0; --d) {
        id[d] = idx[d];
        if (m.lane[d]) {
          id[d] = r % m.size[d];
          r /= m.size[d];
        }
      }
      lin = 0;
      stride = 1;
      for (int d = kMaxBatch - 1; d >= 0; --d) {
        off_a[l] += id[d] * m.sa[d];
        lin += id[d] * stride;
        stride *= m.size[d];
      }
      out_i[l] = lin;
    }
  }

  // zero every region (the padding past chi stays zero), m_l = e0 e0^T
  for (int e = threadIdx.x; e < (2 * m.lanes + 2 * nbuf + 2) * blk;
       e += kThreads)
    sm_m[e] = zero<T>();
  if (threadIdx.x < kMaxLanes && threadIdx.x < nl) logs[threadIdx.x] = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < nl; l += kThreads) sm_m[l * blk] = one<T>();

  const int64_t col = static_cast<int64_t>(chi) * dv * chi;
  const int64_t row = static_cast<int64_t>(dv) * chi;
  const bool vec = m.vec;
  // stage s = (x * dv + v) * nl + l: B_v of (x, v) when l == 0, A_v of lane l
  const int64_t stages = m.lx * dv * nl;
  auto issue = [&](int64_t s) {
    const int l = static_cast<int>(s % nl);
    const int64_t xv = s / nl;
    const int64_t x = xv / dv;
    const int v = static_cast<int>(xv - x * dv);
    if (l == 0)
      stage(sm_b + (xv % nbuf) * blk, ld, b + off_b + x * col + v * chi, row,
            chi, vec);
    stage(sm_a + (s % nbuf) * blk, ld, a + off_a[l] + x * col + v * chi, row,
          chi, vec);
    cp_async_commit();
  };
  issue(0);
  for (int64_t s = 0; s < stages; ++s) {
    const int l = static_cast<int>(s % nl);
    const int64_t xv = s / nl;
    cp_async_wait<0>();
    // stage s landed for every thread, and every thread is past the last
    // stage's products: its buffers and the other T are free
    __syncthreads();
    if (nbuf == 2 && s + 1 < stages) issue(s + 1);
    // T = m_l^T A_v; acc_l += T^T B_v
    T* t = sm_t + (s & 1) * blk;
    product(sm_m + l * blk, sm_a + (s % nbuf) * blk, ld, chi, chi_p, t,
            false);
    __syncthreads();
    product(t, sm_b + (xv % nbuf) * blk, ld, chi, chi_p, sm_acc + l * blk,
            true);
    if (nbuf == 1 && s + 1 < stages) {
      __syncthreads();
      issue(s + 1);
    }
    if (l == nl - 1 && (xv + 1) % dv == 0) {
      __syncthreads();   // every lane's acc is complete
      // the column's end: n = max(||acc||_F, tiny), m = acc / n, acc = 0
      for (int ll = 0; ll < nl; ++ll) {
        T* acc = sm_acc + ll * blk;
        R part = 0;
        for (int e = threadIdx.x; e < blk; e += kThreads) part += abs2(acc[e]);
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
        __syncthreads();
        R total = 0;
        for (int w = 0; w < kWarps; ++w) total += red[w];
        const R nrm = fmax(sqrt(total), tiny_of(total));
        const R inv = R(1) / nrm;
        T* mm = sm_m + ll * blk;
        for (int e = threadIdx.x; e < blk; e += kThreads) {
          mm[e] = scale(acc[e], inv);
          acc[e] = zero<T>();
        }
        if (threadIdx.x == 0) logs[ll] += log(nrm);
        __syncthreads();
      }
    }
  }
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    mant[out_i[l]] = sm_m[l * blk];
    logw[out_i[l]] = logs[l];
  }
}

template <typename T>
size_t staged_smem(int chi_p, int lanes, int nbuf) {
  const int ld = chi_p + Staged<T>::pad;
  using R = typename Real<T>::type;
  return static_cast<size_t>(2 * lanes + 2 * nbuf + 2) * chi_p * ld *
             sizeof(T) +
         (kWarps + kMaxLanes) * sizeof(R);
}

template <typename T>
int launch(const T* a, const T* b, T* mant, void* logw, const int64_t* meta,
           void* stream) {
  using R = typename Real<T>::type;
  OverlapMeta m;
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) {
    m.size[k] = meta[k];
    m.sa[k] = meta[kMaxBatch + k];
    m.sb[k] = meta[2 * kMaxBatch + k];
    m.lane[k] = static_cast<int32_t>(meta[3 * kMaxBatch + 3 + k]);
    items *= m.size[k];
  }
  m.lx = meta[3 * kMaxBatch];
  m.chi = meta[3 * kMaxBatch + 1];
  m.dv = meta[3 * kMaxBatch + 2];
  const int64_t* pl = meta + 4 * kMaxBatch + 3;
  m.body = static_cast<int32_t>(pl[0]);
  m.lanes = static_cast<int32_t>(pl[1]);
  m.nbuf = static_cast<int32_t>(pl[2]);
  m.vec = static_cast<int32_t>(pl[3]);
  m.chi_p = static_cast<int32_t>(pl[4]);
  const int64_t smem_plan = pl[5];
  if (items <= 0) return 0;
  if (items >= (int64_t{1} << 31) || m.chi < 1 || m.dv < 1 || m.lx < 1 ||
      m.chi * m.chi > int64_t{kThreads} * kMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (m.body == 0) {
    const size_t smem =
        2 * m.chi * m.chi * sizeof(T) + kThreads / 32 * sizeof(R);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(overlap_simple<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    overlap_simple<T><<<static_cast<unsigned>(items), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        a, b, mant, static_cast<R*>(logw), m);
    return static_cast<int>(cudaGetLastError());
  }
  m.lane_items = 1;
  m.groups = 1;
  for (int k = 0; k < kMaxBatch; ++k)
    (m.lane[k] ? m.lane_items : m.groups) *= m.size[k];
  if (m.lanes < 1 || m.lanes > kMaxLanes || (m.nbuf != 1 && m.nbuf != 2) ||
      m.chi_p % 16 != 0 || m.chi_p < m.chi || m.chi_p > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  m.chunks = (m.lane_items + m.lanes - 1) / m.lanes;
  const size_t smem = staged_smem<T>(m.chi_p, m.lanes, m.nbuf);
  if (static_cast<int64_t>(smem) != smem_plan)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(overlap_staged<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  overlap_staged<T><<<static_cast<unsigned>(m.groups * m.chunks), kThreads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      a, b, mant, static_cast<R*>(logw), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bmps_overlap_f32(const float* a, const float* b, float* mant, void* logw,
                     const int64_t* meta, void* stream) {
  return launch(a, b, mant, logw, meta, stream);
}

int bmps_overlap_f64(const double* a, const double* b, double* mant,
                     void* logw, const int64_t* meta, void* stream) {
  return launch(a, b, mant, logw, meta, stream);
}

int bmps_overlap_c64(const float2* a, const float2* b, float2* mant,
                     void* logw, const int64_t* meta, void* stream) {
  return launch(a, b, mant, logw, meta, stream);
}

int bmps_overlap_c128(const double2* a, const double2* b, double2* mant,
                      void* logw, const int64_t* meta, void* stream) {
  return launch(a, b, mant, logw, meta, stream);
}

}  // extern "C"
