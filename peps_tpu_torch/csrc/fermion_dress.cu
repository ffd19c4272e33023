// K4: the fermionic sign dressing of a graded TPS, hand-written for Hopper
// (sm_90a).
//
// Replaces: peps_tpu/fermion/convert.py:fermion_project (123) and
// peps_tpu/fermion/tables.py:fermion_candidates (40) / fermion_flip_mask
// (81), elementwise chains that XLA fused on the TPU:
//
//   out[b, y, x, a, f, i] = tps[b, y, x, a, i] * (-1)^E
//   E = scalar(pi(a), Pp, Pc) ^ sum_pairs p(i_g) p(i_h) ^ sum_g c_g p(i_g)
//
// with Pp = Pp0[b, y, x] ^ f (the snake prefix parity before the site,
// flipped by f), Pc = Pp ^ pi(a), and c_g = static ^ pi c_pi ^ Pp c_pp ^
// Pc c_pc per leg g. The 27 static coefficient bits of a site come packed
// in one int32 (codes[y * Lx + x]; bit layout in kernels/fermion_dress.py).
//
// What bounds it: bytes. It reads each tps value once per output (a shared
// tps is read from L2 by every chain) and writes each output once, with a
// handful of integer operations per value. Design: one CTA per output slab
// (b, y, x, a, f) of D^4 contiguous values.
//  - The slab's sign depends on i only through the four leg parities
//    q(i) = p(i_u) | p(i_l) << 1 | p(i_d) << 2 | p(i_r) << 3, precomputed
//    once per bond layout (legpar, D^4 bytes, read through L1/L2). Each CTA
//    folds its site's coefficients and (pi, Pp, Pc) into a 16-bit table
//    T[q] = E(q), so a value costs one byte load, a shift and a select.
//  - Pp0 comes from the configuration in the kernel: every thread XORs the
//    parities of its share of the snake prefix and __syncthreads_count
//    gives the parity of the count.
//  - Loads and stores are plain and coalesced (consecutive threads,
//    consecutive values); complex values negate both parts.
// The result is exact: a multiply by +-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct DressMeta {
  int64_t nb, ly, lx, d, D, y0, ny, select, f0, nf;
  int64_t sb, sy, sx, sa;   // tps strides in elements (sb 0: shared)
  int64_t pp_mask;          // bit s: parity of physical state s
};

template <typename T> __device__ __forceinline__ T neg(T v) { return -v; }
template <> __device__ __forceinline__ float2 neg(float2 v) {
  return make_float2(-v.x, -v.y);
}
template <> __device__ __forceinline__ double2 neg(double2 v) {
  return make_double2(-v.x, -v.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dress_kernel(const T* __restrict__ tps, const int64_t* __restrict__ cfg,
             const int* __restrict__ codes,
             const uint8_t* __restrict__ legpar, T* __restrict__ out,
             DressMeta m) {
  const int64_t slab = blockIdx.x;
  const int64_t na = m.select ? 1 : m.d;
  int64_t rest = slab;
  const int f = static_cast<int>(m.f0 + rest % m.nf);
  rest /= m.nf;
  const int64_t a_slot = rest % na;
  rest /= na;
  const int64_t x = rest % m.lx;
  rest /= m.lx;
  const int64_t y = m.y0 + rest % m.ny;
  const int64_t b = rest / m.ny;
  const int64_t* c_b = cfg + b * m.ly * m.lx;
  const int64_t a = m.select ? c_b[y * m.lx + x] : a_slot;
  const int pi = static_cast<int>((m.pp_mask >> a) & 1);

  // snake prefix parity before (y, x): rows < y, then the part of row y
  // the snake visits first (left of x on even rows, right on odd rows)
  const int64_t prefix = y * m.lx + ((y & 1) ? (m.lx - 1 - x) : x);
  int local = 0;
  for (int64_t k = threadIdx.x; k < prefix; k += blockDim.x) {
    const int64_t yy = k / m.lx, kk = k % m.lx;
    const int64_t xx = (yy & 1) ? (m.lx - 1 - kk) : kk;
    local ^= static_cast<int>((m.pp_mask >> c_b[yy * m.lx + xx]) & 1);
  }
  const int pp0 = __syncthreads_count(local) & 1;

  const int pp = pp0 ^ f;
  const int pc = pp ^ pi;
  const int code = codes[y * m.lx + x];
  const int sc = ((code & 1) & pi) ^ (((code >> 1) & 1) & pi & pp) ^
                 (((code >> 2) & 1) & pi & pc) ^ (((code >> 3) & 1) & pp) ^
                 (((code >> 4) & 1) & pc);
  int legc[4];
  for (int g = 0; g < 4; ++g) {
    const int c = code >> (11 + 4 * g);
    legc[g] = (c & 1) ^ ((c >> 1) & pi) ^ ((c >> 2) & pp) ^ ((c >> 3) & pc);
  }
  // leg pairs (u,l) (u,d) (u,r) (l,d) (l,r) (d,r): bits 5..10
  const int pg[6] = {0, 0, 0, 1, 1, 2};
  const int ph[6] = {1, 2, 3, 2, 3, 3};
  unsigned table = 0;
  for (int q = 0; q < 16; ++q) {
    int e = sc;
    for (int g = 0; g < 4; ++g) e ^= legc[g] & (q >> g);
    for (int k = 0; k < 6; ++k)
      e ^= ((code >> (5 + k)) & 1) & (q >> pg[k]) & (q >> ph[k]);
    table |= static_cast<unsigned>(e & 1) << q;
  }

  const int64_t d4 = m.D * m.D * m.D * m.D;
  const T* src = tps + b * m.sb + y * m.sy + x * m.sx + a * m.sa;
  T* dst = out + slab * d4;
  for (int64_t i = threadIdx.x; i < d4; i += blockDim.x) {
    const T v = src[i];
    dst[i] = ((table >> legpar[i]) & 1u) ? neg(v) : v;
  }
}

template <typename T>
int launch(const T* tps, const int64_t* cfg, const int* codes,
           const uint8_t* legpar, T* out, const int64_t* meta, void* stream) {
  DressMeta m;
  int64_t* f = &m.nb;
  for (int k = 0; k < 15; ++k) f[k] = meta[k];
  const int64_t na = m.select ? 1 : m.d;
  const int64_t slabs = m.nb * m.ny * m.lx * na * m.nf;
  if (slabs <= 0) return 0;
  if (slabs >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  dress_kernel<T><<<static_cast<unsigned>(slabs), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(tps, cfg, codes,
                                                         legpar, out, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fermion_dress_f32(const float* tps, const int64_t* cfg, const int* codes,
                      const uint8_t* legpar, float* out, const int64_t* meta,
                      void* stream) {
  return launch(tps, cfg, codes, legpar, out, meta, stream);
}

int fermion_dress_f64(const double* tps, const int64_t* cfg, const int* codes,
                      const uint8_t* legpar, double* out, const int64_t* meta,
                      void* stream) {
  return launch(tps, cfg, codes, legpar, out, meta, stream);
}

int fermion_dress_c64(const float2* tps, const int64_t* cfg, const int* codes,
                      const uint8_t* legpar, float2* out, const int64_t* meta,
                      void* stream) {
  return launch(tps, cfg, codes, legpar, out, meta, stream);
}

int fermion_dress_c128(const double2* tps, const int64_t* cfg,
                       const int* codes, const uint8_t* legpar, double2* out,
                       const int64_t* meta, void* stream) {
  return launch(tps, cfg, codes, legpar, out, meta, stream);
}

}  // extern "C"
