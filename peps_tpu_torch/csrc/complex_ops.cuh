// Complex arithmetic of K2's complex body (complex64 and complex128; K1's
// and K3's tile products are in complex_tiles.cuh). A value is float2 /
// double2: (re, im) interleaved, the layout of torch.complex64 /
// torch.complex128, 8- and 16-byte aligned as torch allocates them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

template <typename R> struct CxOf;
template <> struct CxOf<float> { using type = float2; };
template <> struct CxOf<double> { using type = double2; };

template <typename V>
__device__ __forceinline__ V cx_zero() {
  V z;
  z.x = 0;
  z.y = 0;
  return z;
}

template <typename V>
__device__ __forceinline__ V cx_add(V a, V b) {
  a.x += b.x;
  a.y += b.y;
  return a;
}

template <typename V, typename R>
__device__ __forceinline__ V cx_scale(V a, R s) {
  a.x *= s;
  a.y *= s;
  return a;
}

// a / b by Smith's scaled division: no |b|^2 is formed, so it neither
// overflows nor underflows where a / b itself is representable (a naive
// a conj(b) / |b|^2 does in float32 near |b| = 1e+-19).
template <typename V>
__device__ __forceinline__ V cx_div(V a, V b) {
  V q;
  if (fabs(b.x) >= fabs(b.y)) {
    const auto r = b.y / b.x;
    const auto den = b.x + b.y * r;
    q.x = (a.x + a.y * r) / den;
    q.y = (a.y - a.x * r) / den;
  } else {
    const auto r = b.x / b.y;
    const auto den = b.y + b.x * r;
    q.x = (a.x * r + a.y) / den;
    q.y = (a.y * r - a.x) / den;
  }
  return q;
}
