// K2: the centered, scaled SR sample matrix, hand-written for Hopper (sm_90a).
//
// Replaces: peps_tpu/algorithm/energy.py:_row_pass's O build (112-116), the
// sample stacking of mc_evaluator._mc_collect and mc_evaluator._center_scale
// (316-320), which XLA fused on the TPU:
//
//   a[s, (site, p, k)] = (O[s, site, p, k] - mean_s O[:, site, p, k]) / sqrt(Ns)
//   O[s, site, p, k]   = [cfg[s, site] == p] * holes[s, site, k] / safe(psi[s, site])
//
// with safe(psi) = 1 where psi == 0. holes [Ns, S, K], psi [Ns, S], cfg
// [Ns, S] int64 and a [Ns, P = S*d*K] are contiguous.
//
// What bounds it on the H100: bytes. It reads the holes once and writes d
// times as many values, at a few flops per output, with no reuse across
// CTAs. At 3.35 TB/s and ~0.6 us of memory latency, Little's law asks for
// about 2 MB of loads in flight across the 132 SMs, ~15 KB per SM.
//
// Design. A CTA owns one (site, chunk of KC = 8 x 16 bytes of K columns)
// and all d values of p for it, so each holes value is loaded from device
// memory once. 256 threads: 8 lanes cover the chunk's 128-byte line of a
// row with one 16-byte load each, 32 rows per pass, R passes (R = 1, 2, 4
// or 8 from Ns). The [R*32, KC] tile stays in registers from the column
// sums to the write, all of its loads issued before any is used.
//  - Occupancy is what keeps bytes in flight: the launch bounds let 4 CTAs
//    share an SM at R <= 2 (<= 64 registers), 3 at R = 4 and 2 at R = 8
//    (128 registers, no spill; a tighter cap spilled the tile and was
//    slower at 12x12 D=10), so 16-64 KB of loads can be in flight per SM.
//  - Loads and stores are streaming (evict-first, ld/st.global.cs): each
//    holes value is read once and the buffer is not read back here. Of the
//    changes tried on the H100 this was the largest gain at 12x12 D=10.
//  - The CTA stages x[s] = 1/safe(psi[s, site]) and cfg[s, site] for its
//    rows in shared memory once: one reciprocal per (s, site), no
//    per-element gather, and the int64 configurations are read as they
//    are. The first tile's loads are issued before the staging, so their
//    latency overlaps it. A row whose reciprocal overflows (a subnormal
//    psi) is flagged and divides instead, as the plain version does.
//  - Column sums: each thread scales its values in place and sums
//    h*x*[cfg == p] over its rows for every p (a multiply by 0 or 1, so a
//    NaN or inf of h/psi spreads over every p of its column as in the plain
//    version); warp shuffles, then shared memory, reduce over the rows.
//  - Write: from the tile still in registers, (h*x*[cfg == p] - mean_p) *
//    rsqrt(Ns) for each p with 16-byte stores; no value is loaded again.
//  - Row bases s*P and (s*S + site)*K are 64-bit: the buffer may exceed 2^31
//    elements (16x16, D=12, Ns=256 is 2.7e9).
//  - Ns above 256 rows is taken in row blocks of R*32 = 256 by the kernel's
//    kBlocks instantiation: the first pass sums every block, the last block
//    stays in registers and is written first, the others are loaded again
//    (cached loads, so from L2 where they still are) and written. No
//    ceiling on Ns; the one-block instantiations carry none of that code.
//  - K not a multiple of 16/sizeof(T), or a misaligned pointer: the same
//    lanes move their values with scalar accesses (vec = 0). The last chunk
//    of a row masks the columns past K.
// Rounding: h*(1/psi) and the multiply by rsqrt(Ns) differ from the plain
// version's divisions by about one ulp each, and the sums run in another
// order, well inside 1e-5 (f32) and 1e-12 (f64) of max |a|. A configuration
// value outside [0, d) selects no p (the plain version's one_hot raises).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "complex_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 8;                         // 8 x 16 B = 128 B
constexpr int kRowsPerPass = kThreads / kLanesPerRow;   // 32
constexpr int kWarps = kThreads / 32;
constexpr int kNoState = 0xff;      // staged cfg of a row past Ns / out of range
constexpr int kDivide = 0x100;      // staged flag: this row divides by psi

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// CTAs an SM must hold (launch bounds): at most 64 registers a thread for
// R <= 2, 80 for R = 4, 128 for R = 8.
template <int R> constexpr int min_ctas() { return R <= 2 ? 4 : R == 4 ? 3 : 2; }

struct Args {
  int64_t ns, sites, k, chunks, row_blocks;
  int d, dp, r, vec;
};

// Values k0 .. k0+V-1 of one row, nvalid of them inside the row (0 for a
// row past Ns); zeros for the others.
template <typename T, bool kStream>
__device__ __forceinline__ void load_values(T (&h)[Vec16<T>::n],
                                            const T* __restrict__ p,
                                            int nvalid, bool vec) {
  constexpr int V = Vec16<T>::n;
  using V16 = typename Vec16<T>::type;
  if (vec && nvalid == V) {
    const V16 x = kStream ? __ldcs(reinterpret_cast<const V16*>(p))
                          : __ldg(reinterpret_cast<const V16*>(p));
    const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int j = 0; j < V; ++j) h[j] = xs[j];
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) h[j] = j < nvalid ? p[j] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_values(T* __restrict__ p,
                                             const T (&y)[Vec16<T>::n],
                                             int nvalid, bool vec) {
  constexpr int V = Vec16<T>::n;
  if (vec && nvalid == V) {
    typename Vec16<T>::type x;
    T* xs = reinterpret_cast<T*>(&x);
#pragma unroll
    for (int j = 0; j < V; ++j) xs[j] = y[j];
    __stcs(reinterpret_cast<typename Vec16<T>::type*>(p), x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < nvalid) p[j] = y[j];
  }
}

// kBlocks: Ns takes more than one row block (R = 8).
template <typename T, int DP, int R, bool kBlocks>
__global__ void __launch_bounds__(kThreads, min_ctas<R>())
centered_o_kernel(const T* __restrict__ holes, const T* __restrict__ psi,
                  const int64_t* __restrict__ cfg, T* __restrict__ out,
                  const Args a) {
  constexpr int V = Vec16<T>::n;
  constexpr int KC = kLanesPerRow * V;
  constexpr int kBlockRows = R * kRowsPerPass;
  __shared__ T s_x[kBlockRows];
  __shared__ int s_cfg[kBlockRows];
  __shared__ T s_red[kWarps][DP][KC];
  __shared__ T s_mean[DP][KC];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int col = tid % kLanesPerRow;
  const int row_lane = tid / kLanesPerRow;
  const int64_t site = blockIdx.x / a.chunks;
  const int64_t k0 = (blockIdx.x % a.chunks) * KC + col * V;
  const int nvalid = static_cast<int>(
      a.k - k0 >= V ? V : (a.k - k0 > 0 ? a.k - k0 : 0));
  const int64_t p_len = a.sites * a.d * a.k;
  const bool vec = a.vec != 0;
  const T rs = static_cast<T>(1.0 / sqrt(static_cast<double>(a.ns)));

  T h[R][V];
  T mean[DP][V];

  auto load_block = [&](int64_t b) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = b * kBlockRows + i * kRowsPerPass + row_lane;
      load_values<T, !kBlocks>(h[i], holes + (row * a.sites + site) * a.k + k0,
                               row < a.ns ? nvalid : 0, vec);
    }
  };
  // The caller makes sure no thread still reads the previous staging.
  auto stage = [&](int64_t b) {
    if (tid < kBlockRows) {
      const int64_t row = b * kBlockRows + tid;
      T x = T(1);
      int c = kNoState;
      if (row < a.ns) {
        const T ps = psi[row * a.sites + site];
        const T safe = ps == T(0) ? T(1) : ps;
        x = T(1) / safe;
        const int64_t cv = cfg[row * a.sites + site];
        c = (cv >= 0 && cv < a.d) ? static_cast<int>(cv) : kNoState;
        if (isinf(x) && isfinite(safe)) {   // 1/psi overflows: divide
          x = safe;
          c |= kDivide;
        }
      }
      s_x[tid] = x;
      s_cfg[tid] = c;
    }
  };
  auto scale = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const T x = s_x[i * kRowsPerPass + row_lane];
      if (s_cfg[i * kRowsPerPass + row_lane] & kDivide) {
#pragma unroll
        for (int j = 0; j < V; ++j) h[i][j] = h[i][j] / x;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) h[i][j] = h[i][j] * x;
      }
    }
  };
  auto sum = [&](T (&acc)[DP][V]) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = s_cfg[i * kRowsPerPass + row_lane] & kNoState;
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int q = 0; q < DP; ++q)
          acc[q][j] += h[i][j] * (c == q ? T(1) : T(0));
    }
  };
  // Column means of this chunk into mean[][]: shuffles over the 4 rows of a
  // warp, then shared memory over the 8 warps.
  auto reduce = [&](T (&acc)[DP][V]) {
#pragma unroll
    for (int q = 0; q < DP; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        T v = acc[q][j];
#pragma unroll
        for (int off = kLanesPerRow; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < kLanesPerRow) s_red[tid / 32][q][col * V + j] = v;
      }
    __syncthreads();
    if (tid < DP * KC) {
      const int q = tid / KC, c = tid % KC;
      T t = T(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += s_red[w][q][c];
      s_mean[q][c] = t / static_cast<T>(a.ns);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < DP; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) mean[q][j] = s_mean[q][col * V + j];
  };
  auto write_block = [&](int64_t b) {
    if (nvalid == 0) return;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = b * kBlockRows + i * kRowsPerPass + row_lane;
      if (row >= a.ns) continue;
      const int cr = s_cfg[i * kRowsPerPass + row_lane] & kNoState;
      T* base = out + row * p_len + site * a.d * a.k + k0;
#pragma unroll
      for (int q = 0; q < DP; ++q) {
        if (q >= a.d) break;
        const T sel = cr == q ? T(1) : T(0);
        T y[V];
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = (h[i][j] * sel - mean[q][j]) * rs;
        store_values<T>(base + q * a.k, y, nvalid, vec);
      }
    }
  };

  T acc[DP][V] = {};
  if (!kBlocks) {
    load_block(0);
    stage(0);
    __syncthreads();
    scale();
    sum(acc);
    reduce(acc);
    write_block(0);
  } else {
    // Pass 1 over every row block; the last block's tile stays in
    // registers for the write.
    for (int64_t b = 0; b < a.row_blocks; ++b) {
      load_block(b);
      __syncthreads();
      stage(b);
      __syncthreads();
      scale();
      sum(acc);
    }
    reduce(acc);
    write_block(a.row_blocks - 1);
    for (int64_t b = 0; b + 1 < a.row_blocks; ++b) {
      load_block(b);
      __syncthreads();
      stage(b);
      __syncthreads();
      scale();
      write_block(b);
    }
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const int64_t*, T*, const Args);

template <typename T, int DP>
KernelFn<T> pick_r(int r, bool blocks) {
  if (blocks) return r == 8 ? centered_o_kernel<T, DP, 8, true> : nullptr;
  switch (r) {
    case 1: return centered_o_kernel<T, DP, 1, false>;
    case 2: return centered_o_kernel<T, DP, 2, false>;
    case 4: return centered_o_kernel<T, DP, 4, false>;
    case 8: return centered_o_kernel<T, DP, 8, false>;
    default: return nullptr;
  }
}

template <typename T>
KernelFn<T> pick(int dp, int r, bool blocks) {
  if (dp == 2) return pick_r<T, 2>(r, blocks);
  if (dp == 4) return pick_r<T, 4>(r, blocks);
  return nullptr;
}

// args = ns, sites, k, d, col_chunks, rows_per_thread, row_blocks, dp, vec
// (centered_o_plan in kernels/centered_o.py). Checks that the plan covers
// every (row, site, column) once and fits the grid.
template <typename T>
bool unpack(const int64_t* args, Args& a) {
  constexpr int KC = kLanesPerRow * Vec16<T>::n;
  a.ns = args[0];
  a.sites = args[1];
  a.k = args[2];
  a.d = static_cast<int>(args[3]);
  a.chunks = args[4];
  a.r = static_cast<int>(args[5]);
  a.row_blocks = args[6];
  a.dp = static_cast<int>(args[7]);
  a.vec = static_cast<int>(args[8]);
  const int64_t block_rows = static_cast<int64_t>(a.r) * kRowsPerPass;
  return a.ns > 0 && a.sites > 0 && a.k > 0 && args[3] >= 1 &&
         a.d <= a.dp && a.chunks * KC >= a.k && (a.chunks - 1) * KC < a.k &&
         a.row_blocks * block_rows >= a.ns &&
         (a.row_blocks - 1) * block_rows < a.ns &&
         a.sites * a.chunks < (int64_t(1) << 31);
}

template <typename T>
int launch(const T* holes, const T* psi, const int64_t* cfg, T* out,
           const int64_t* args, void* stream) {
  Args a;
  if (!unpack<T>(args, a)) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn<T> fn = pick<T>(a.dp, a.r, a.row_blocks > 1);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(a.sites * a.chunks), kThreads, 0,
       static_cast<cudaStream_t>(stream)>>>(holes, psi, cfg, out, a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- complex body --
//
// complex64 / complex128: O = [cfg == p] holes / psi (psi = 1 where psi ==
// 0), centered over the samples and scaled by the real 1/sqrt(Ns), with no
// conjugate (the SR solve conjugates later, in conj(a)^T eps). A separate,
// simple body; the real one above is untouched. What bounds it: bytes, as
// the real one (twice the bytes a value). Design: one CTA of 8 warps owns
// a (site, chunk of 32 columns of K); a warp's lanes cover the chunk's 32
// consecutive columns of a row (256 or 512 contiguous bytes), the warps
// stride over the rows. The first pass sums O over the rows for every p
// into registers, then shared memory reduces over the warps; the second
// pass reads the chunk again (from L2: the CTA has just read it) and writes
// (O - mean_p) / sqrt(Ns) for each p. holes / psi is Smith's scaled
// division (complex_ops.cuh: cx_div), no reciprocal, so a psi near the
// type's range overflows nothing that h / psi does not; [cfg == p] is a
// multiply by 0 or 1, so a NaN or inf of h / psi spreads over every p of
// its column as in the plain version.
// The launch bounds name one CTA an SM as the floor: without it ptxas kept
// the complex128 d <= 2 body to 64 registers and spilled (56-92 registers,
// no spill, with it).

constexpr int kCxCols = 32;

struct CxArgs {
  int64_t ns, sites, k, chunks;
  int d;
};

template <typename R, int DP, typename V = typename CxOf<R>::type>
__global__ void __launch_bounds__(kThreads, 1)
centered_o_cx_kernel(const V* __restrict__ holes, const V* __restrict__ psi,
                     const int64_t* __restrict__ cfg, V* __restrict__ out,
                     const CxArgs a) {
  __shared__ V s_red[kWarps][DP][kCxCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t site = blockIdx.x / a.chunks;
  const int64_t col = (blockIdx.x % a.chunks) * kCxCols + lane;
  const bool ok = col < a.k;
  const V zero = cx_zero<V>();
  const int64_t p_len = a.sites * a.d * a.k;

  auto value = [&](int64_t s, int& state) {   // holes / safe(psi) of row s
    const int64_t row = s * a.sites + site;
    V ps = psi[row];
    if (ps.x == R(0) && ps.y == R(0)) ps.x = R(1);
    const int64_t c = cfg[row];
    state = c >= 0 && c < a.d ? static_cast<int>(c) : -1;
    return cx_div(ok ? holes[row * a.k + col] : zero, ps);
  };

  V sum[DP];
#pragma unroll
  for (int q = 0; q < DP; ++q) sum[q] = zero;
  for (int64_t s = warp; s < a.ns; s += kWarps) {
    int state;
    const V x = value(s, state);
#pragma unroll
    for (int q = 0; q < DP; ++q)
      sum[q] = cx_add(sum[q], cx_scale(x, R(q == state ? 1 : 0)));
  }
#pragma unroll
  for (int q = 0; q < DP; ++q) s_red[warp][q][lane] = sum[q];
  __syncthreads();
  const R inv_ns = R(1) / static_cast<R>(a.ns);
  V mean[DP];
#pragma unroll
  for (int q = 0; q < DP; ++q) {
    V t = zero;
    for (int w = 0; w < kWarps; ++w) t = cx_add(t, s_red[w][q][lane]);
    mean[q] = cx_scale(t, inv_ns);
  }
  const R scale = R(1) / sqrt(static_cast<R>(a.ns));
  for (int64_t s = warp; s < a.ns; s += kWarps) {
    int state;
    const V x = value(s, state);
    if (!ok) continue;
    V* o = out + s * p_len + site * a.d * a.k + col;
#pragma unroll
    for (int q = 0; q < DP; ++q) {
      if (q >= a.d) break;
      V y = cx_scale(x, R(q == state ? 1 : 0));
      y.x -= mean[q].x;
      y.y -= mean[q].y;
      o[q * a.k] = cx_scale(y, scale);
    }
  }
}

// args = ns, sites, k, d, col_chunks, dp (kernels/centered_o.py:
// centered_o_plan for a complex dtype).
template <typename R>
int launch_cx(const void* holes, const void* psi, const int64_t* cfg,
              void* out, const int64_t* args, void* stream) {
  using V = typename CxOf<R>::type;
  CxArgs a;
  a.ns = args[0];
  a.sites = args[1];
  a.k = args[2];
  a.d = static_cast<int>(args[3]);
  a.chunks = args[4];
  const int64_t dp = args[5];
  if (a.ns < 1 || a.sites < 1 || a.k < 1 || a.d < 1 || a.d > dp ||
      a.chunks * kCxCols < a.k || (a.chunks - 1) * kCxCols >= a.k ||
      a.sites * a.chunks >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(a.sites * a.chunks);
  const V* h = static_cast<const V*>(holes);
  const V* ps = static_cast<const V*>(psi);
  V* o = static_cast<V*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp == 2)
    centered_o_cx_kernel<R, 2><<<grid, kThreads, 0, st>>>(h, ps, cfg, o, a);
  else if (dp == 4)
    centered_o_cx_kernel<R, 4><<<grid, kThreads, 0, st>>>(h, ps, cfg, o, a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int centered_o_f32(const float* holes, const float* psi, const int64_t* cfg,
                   float* out, const int64_t* args, void* stream) {
  return launch<float>(holes, psi, cfg, out, args, stream);
}

int centered_o_f64(const double* holes, const double* psi,
                   const int64_t* cfg, double* out, const int64_t* args,
                   void* stream) {
  return launch<double>(holes, psi, cfg, out, args, stream);
}

int centered_o_c64(const void* holes, const void* psi, const int64_t* cfg,
                   void* out, const int64_t* args, void* stream) {
  return launch_cx<float>(holes, psi, cfg, out, args, stream);
}

int centered_o_c128(const void* holes, const void* psi, const int64_t* cfg,
                    void* out, const int64_t* args, void* stream) {
  return launch_cx<double>(holes, psi, cfg, out, args, stream);
}

}  // extern "C"
