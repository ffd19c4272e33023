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
// slabs; an item's slab may be shared by other items (batch stride 0: one
// excited bottom serves every start lane of its column).
//
// What bounds it: operations. Each column is 2 chi^3 D multiply-adds (four
// real FMAs each for complex) on chi D chi inputs from each operand.
// Design: one CTA per item keeps m in shared memory across all Lx columns,
// so a whole scan is one launch; per column and per vertical index v
//  - T_v[c, b] = sum_a m[a, c] A[x][a, v, b]  (shared memory, chi^2),
//  - acc[b, d] += sum_c T_v[c, b] B[x][c, v, d]  (registers; each thread
//    owns up to kMaxOut outputs),
// then the block's sum of |acc|^2 gives n and m = acc / n. Consecutive
// threads take consecutive b (first product) or d (second), so the A and
// B reads coalesce and the m and T reads broadcast within a warp. This is
// the simple body: no tensor cores, no staged slabs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "complex_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 16;       // chi^2 <= kThreads * kMaxOut: chi <= 64
constexpr int kMaxBatch = 4;

struct OverlapMeta {
  int64_t size[kMaxBatch];        // batch sizes, leading 1s for unused dims
  int64_t sa[kMaxBatch];          // a's batch strides in elements
  int64_t sb[kMaxBatch];          // b's batch strides in elements
  int64_t lx, chi, dv;
};

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
overlap_kernel(const T* __restrict__ a, const T* __restrict__ b,
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
    items *= m.size[k];
  }
  m.lx = meta[3 * kMaxBatch];
  m.chi = meta[3 * kMaxBatch + 1];
  m.dv = meta[3 * kMaxBatch + 2];
  if (items <= 0) return 0;
  if (items >= (int64_t{1} << 31) || m.chi < 1 || m.dv < 1 || m.lx < 1 ||
      m.chi * m.chi > int64_t{kThreads} * kMaxOut)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * m.chi * m.chi * sizeof(T) + kThreads / 32 * sizeof(R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        overlap_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  overlap_kernel<T><<<static_cast<unsigned>(items), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
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
