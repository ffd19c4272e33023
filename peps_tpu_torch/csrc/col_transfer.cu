// K1: the BTen column transfer, hand-written for Hopper (sm_90a).
//
// Replaces: peps_tpu/contraction/bmps.py:_col_transfer_left and
// _col_transfer_right (three XLA-fused einsums each), and every transfer of
// the same form on the VMC main path: bmps.row_envs, both halves of
// bmps.replace_nn_site_traces, montecarlo/sweep.py:_right_btens,
// _right_blocks and the bond step's left chain, and the v_step/w_step sketch
// recursions of bmps.absorb_row_sketch (a Gaussian block in the `bot` slot).
//
//   out[n, A, r, C] = sum_{a,l,c,u,d} env[n,a,l,c] top[n,a,u,A]
//                                       site[n,u,l,d,r] bot[n,c,d,C]
//
// The right-hand form is this one applied to permuted views (a<->A on top,
// c<->C on bot, l<->r on site), so every operand comes with its own strides;
// a batch stride of 0 shares an operand across the batch (the Gaussian block,
// the candidate sites shared by all chains). In complex dtypes there is no
// conjugate anywhere.
//
// What bounds it on the H100: one item costs
//   2 (a l c u A + A c l u d r + A r c d C) flops,
// 16.8 MFLOP at chi = 32, D = 8, c = C = 32, against ~0.1 MB of operands,
// so the transfer is compute-bound (four times that in complex dtypes: four
// real FMAs a complex multiply-add). f32 and complex64 run on the FP32 CUDA
// cores, which are their peak: TF32 tensor cores are not used, the main path
// keeps full f32 sums. complex128 runs on the DMMA tensor cores, the card's
// f64 peak; f64 on DFMA, half of it.
//
// Design. Per item, the transfer is three products whose operands both sit
// in shared memory, streamed over chunks of KC values of the env/bot index c
// (A' runs over the CTA's tile of TA values of A):
//   step 1  T1[(u,l),(c',A')] = sum_a   env[a,(l,c')]    top[a,(u,A')]
//   step 2  T2[(c',d),(r,A')] = sum_ul  T1[(u,l),(c',A')] site[(u,l),(d,r)]
//   step 3  out[(r,A'),C]    += sum_c'd T2[(c',d),(r,A')] bot[(c',d),C]
// Each step stores its result in the K-major layout the next step reads,
// with A' innermost; T2 overwrites T1 once step 2 has read it, and out
// accumulates in registers over the chunks, so no global-memory load sits
// inside a product loop. site is copied in once and top once per A tile;
// env and bot stream chunk by chunk with cp.async into two buffers each, so
// chunk k+1 lands while chunk k is multiplied. Every copy writes the GEMM
// layout whatever the caller's strides are: 16-byte copies where the
// operand is unit-stride along the shared copy's rows and aligned,
// otherwise one element a copy with consecutive threads on the operand's
// smallest stride (the right form's transposed views stay coalesced). Each
// copy is planned once per CTA (Box), so no division runs per chunk.
//
// The bodies (Body<T>):
//  - f32 and f64: register-tiled SIMT products; every thread owns at most
//    one output tile per step (4x8 values in the large-batch plan), fed by
//    16-byte shared loads, the lanes of a warp on an 8 x 4 block of tiles,
//    so each shared load serves several lanes. Leading dims are padded off
//    multiples of 32 words, so a warp's 16-byte stores fall into distinct
//    banks.
//  - complex64 and complex128 (complex_tiles.cuh, shared with K3): the rows
//    of T1 run (l, u) and those of T2 and of bot's copy (d, c'), and each
//    product value is placed through per-CTA offset tables. complex64: a
//    4 x 4 complex register tile a thread on the FP32 cores, the lanes of a
//    warp on a 16 x 32 block (64 FMAs a k-step against two 32-byte fragment
//    loads, which broadcast); step 1 runs as top^T env. T1's and T2's
//    leading dims are 8 mod 16 elements and the lanes of a quarter-warp
//    store their two pairs in staggered order, so that every 16-byte store
//    of steps 1 and 2 lands on 8 distinct bank groups at chi = 32, D = 8.
//    complex128: mma.sync.m16n8k8.f64, four real MMAs a complex tile
//    product, each fragment value one 16-byte load of (re, im) with leading
//    dims of 2 mod 8 elements, K padded to 8 with rows that shared memory's
//    zeroing leaves zero. Step 2's tiles wait in registers for the barrier
//    after which T2 overwrites T1; step 3's stay in registers (complex64)
//    or MMA fragments (complex128) across the chunks. One CTA an SM. What
//    binds them is the products' FMA or MMA stream, each step's time in
//    proportion to its flops; then complex64's fragment loads and
//    complex128's env and bot refills (scripts/ablate_col_transfer.py).
//
// Split across CTAs: with at least 1.5 items per SM one CTA owns an item and
// its whole A range (f32: TA = 32, KC = 4, env and bot read once per item at
// chi = 32; 103 KB of shared memory and 128 registers, so two CTAs share an
// SM; complex64 the same tiles in 203 KB; complex128 TA = 16, KC = 2 in two
// passes). Below that, the A range is cut into tiles of TA = 8, one CTA
// each, so that a 32-item call still fills 128 SMs; f32 and f64 then use
// smaller register tiles (2x8, 4x4, 2x4, two step-3 tiles per thread). The
// plan (mode, A tile, c chunk, leading dims, region offsets, shared bytes)
// is chosen in Python (kernels/col_transfer.py:col_transfer_launch_plan) and
// comes in the meta; check_plan refuses one this code cannot run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 4;
constexpr size_t kSmemLimit = 232448;
constexpr int kMetaLen = kMaxBatch + 3 * (kMaxBatch + 3) + (kMaxBatch + 4) + 8;
constexpr int kPlanInts = 20;

struct Meta {
  int64_t nb[kMaxBatch];              // batch sizes, padded with 1
  int64_t se[kMaxBatch + 3];          // env strides: batch..., a, l, c
  int64_t st[kMaxBatch + 3];          // top strides: batch..., a, u, A
  int64_t ss[kMaxBatch + 4];          // site strides: batch..., u, l, d, r
  int64_t sb[kMaxBatch + 3];          // bot strides: batch..., c, d, C
  int na, nl, nc, nu, nA, nd, nr, nC;
};

// Thread tiles of the real bodies' three steps (TMk x TNk values) and step-3
// tiles per thread; the mode (0: one CTA per item, 1: one per A tile).
template <int TM1_, int TN1_, int TM2_, int TN2_, int TM3_, int TN3_, int R3_,
          int kMode_>
struct Cfg {
  static constexpr int TM1 = TM1_, TN1 = TN1_, TM2 = TM2_, TN2 = TN2_;
  static constexpr int TM3 = TM3_, TN3 = TN3_, R3 = R3_;
  static constexpr int kMode = kMode_;
};
using FullCfg = Cfg<4, 8, 4, 8, 4, 8, 1, 0>;    // one CTA per item
using SplitCfg = Cfg<2, 8, 4, 4, 2, 4, 2, 1>;   // one CTA per A tile

// The body an element type runs (kind: 0 f32, 1 f64, 2 complex64, 3
// complex128), the multiple K is padded to, and the complex bodies' step-2
// and step-3 tiles a warp owns at most (complex64: blocks of 16 x 32;
// complex128: MMA tiles of 16 x 8 in step 2, one warp tile of 32 x 16 in
// step 3).
template <typename T> struct Body;
template <> struct Body<float> { static constexpr int kind = 0, kq = 1; };
template <> struct Body<double> { static constexpr int kind = 1, kq = 1; };
template <> struct Body<float2> {
  static constexpr int kind = 2, kq = 1, R2 = 2, R3 = 2;
};
template <> struct Body<double2> {
  static constexpr int kind = 3, kq = 8, R2 = 2, R3 = 1;
};

// The launch plan: the kPlanInts values from the meta (the order of
// kernels/col_transfer.py:PLAN_KEYS), then what launch derives from them.
struct Plan {
  int mode, ta, kc;
  int ldT, ldS, ldE, ld1, ld2, ldB;     // leading dims (elements)
  int oT, oS, oE, oT1, oT2, oB;         // region offsets (elements)
  int szE, szB;                         // one stream buffer (elements)
  int oTab, box_off;                    // offset tables, Box plans (bytes)
  int smem;                             // bytes
  int n_pass, n_split;                  // A tiles; CTAs an item
  int vec_e, vec_b, vec_t, vec_s;       // operands copied 16 B-wise
  int64_t ctas;
};

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ inline int round_up(int x, int m) { return cdiv(x, m) * m; }
__host__ __device__ inline int tiles(int m, int tm, int n, int tn) {
  return cdiv(cdiv(m, tm), 8) * 8 * cdiv(cdiv(n, tn), 4) * 4;
}

// ---------------------------------------------------------------- device --

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes), "r"(ok ? kBytes : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// An asynchronous copy of a 4-D box of a global operand into shared memory,
// dst[sum i_k d_k] = src[sum i_k s_k], planned once per CTA and kept in
// shared memory: extents n (dim 3 in units of W elements), source strides s,
// shared strides d, valid extents v (zero-filled beyond), the block stride
// kThreads as digits, and the dim clipped per call (c' of a partial last
// chunk, A' of a partial last pass).
struct Box {
  int64_t s[4];
  int n[4], d[4], v[4], step[4], cpos;
};

// Thread 0 plans a box. W > 1: dim 3 is unit-stride in both memories and
// each copy moves W elements (16 bytes); W == 1: consecutive threads walk
// the dim of smallest |source stride|.
template <int W>
__device__ void plan_box(Box& b, int n[4], int64_t s[4], int d[4], int v[4],
                         int cpos) {
  if (W == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (n[k] > 1 && (n[3] == 1 || llabs(s[k]) < llabs(s[3]))) {
        int t = n[k]; n[k] = n[3]; n[3] = t;
        int64_t u = s[k]; s[k] = s[3]; s[3] = u;
        t = d[k]; d[k] = d[3]; d[3] = t;
        t = v[k]; v[k] = v[3]; v[3] = t;
        cpos = cpos == k ? 3 : cpos == 3 ? k : cpos;
      }
    }
  } else {
    n[3] /= W;
    v[3] = cdiv(v[3], W);
    s[3] *= W;
    d[3] *= W;
  }
  int q = kThreads;
#pragma unroll
  for (int k = 3; k > 0; --k) {
    b.step[k] = q % n[k];
    q /= n[k];
  }
  b.step[0] = q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.n[k] = n[k]; b.s[k] = s[k]; b.d[k] = d[k]; b.v[k] = v[k];
  }
  b.cpos = cpos;
}

// The thread's first element of a box as four 16-bit digits (once per CTA).
__device__ __forceinline__ uint2 first_digits(const Box& b) {
  int r = threadIdx.x;
  const unsigned i3 = r % b.n[3]; r /= b.n[3];
  const unsigned i2 = r % b.n[2]; r /= b.n[2];
  const unsigned i1 = r % b.n[1];
  const unsigned i0 = r / b.n[1];
  return make_uint2(i0 | i1 << 16, i2 | i3 << 16);
}

// Copy a planned box (the clipped dim valid below cv), no division: the
// digits advance by the block stride with carries.
template <typename T, int W>
__device__ __forceinline__ void run_box(const Box& b, uint2 first, T* dst,
                                        const T* src, int cv) {
  int i0 = first.x & 0xffff, i1 = first.x >> 16;
  int i2 = first.y & 0xffff, i3 = first.y >> 16;
  if (W > 1 && b.cpos == 3) cv = cdiv(cv, W);
  while (i0 < b.n[0]) {
    const int ic = b.cpos == 0 ? i0 : b.cpos == 1 ? i1 : b.cpos == 2 ? i2 : i3;
    const bool ok = i0 < b.v[0] && i1 < b.v[1] && i2 < b.v[2] &&
                    i3 < b.v[3] && ic < cv;
    const T* g = ok ? src + i0 * b.s[0] + i1 * b.s[1] + i2 * b.s[2] +
                          i3 * b.s[3]
                    : src;
    cp_async<W * sizeof(T)>(
        dst + i0 * b.d[0] + i1 * b.d[1] + i2 * b.d[2] + i3 * b.d[3], g, ok);
    i3 += b.step[3];
    int carry = i3 >= b.n[3];
    if (carry) i3 -= b.n[3];
    i2 += b.step[2] + carry;
    carry = i2 >= b.n[2];
    if (carry) i2 -= b.n[2];
    i1 += b.step[1] + carry;
    carry = i1 >= b.n[1];
    if (carry) i1 -= b.n[1];
    i0 += b.step[0] + carry;
  }
}

// N consecutive shared values into registers with 16- or 8-byte loads.
template <int N>
__device__ __forceinline__ void load_frag(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else {
    static_assert(N % 2 == 0, "tile widths are even");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = v.x; x[2 * i + 1] = v.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_frag(double (&x)[N], const double* p) {
  static_assert(N % 2 == 0, "tile widths are even");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 v = reinterpret_cast<const double2*>(p)[i];
    x[2 * i] = v.x; x[2 * i + 1] = v.y;
  }
}

// N consecutive registers into shared memory with 16- or 8-byte stores.
template <int N>
__device__ __forceinline__ void store_frag(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(x[2 * i], x[2 * i + 1]);
  }
}
template <int N>
__device__ __forceinline__ void store_frag(double* p, const double (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    reinterpret_cast<double2*>(p)[i] = make_double2(x[2 * i], x[2 * i + 1]);
}

// acc[TM][TN] += sum_k a[k][0:TM] b[k][0:TN]; a and b in shared memory,
// K-major, already offset to the tile.
template <typename T, int TM, int TN>
__device__ __forceinline__ void mma_tile(T (&acc)[TM][TN], const T* a,
                                         int lda, const T* b, int ldb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    T x[TM], y[TN];
    load_frag<TM>(x, a + k * lda);
    load_frag<TN>(y, b + k * ldb);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fma(x[i], y[j], acc[i][j]);
  }
}

// Tile t of an (n_mt x n_nt)-tile product: the lanes of a warp cover an
// 8 x 4 block of tiles. Returns false for a padding tile.
__device__ __forceinline__ bool tile_of(int t, int n_mt, int n_nt, int& mi,
                                        int& ni) {
  const int lane = t & 31, sup = t >> 5, n_smt = cdiv(n_mt, 8);
  mi = (sup % n_smt) * 8 + (lane & 7);
  ni = (sup / n_smt) * 4 + (lane >> 3);
  return mi < n_mt && ni < n_nt;
}

// ------------------------------------------------- complex bodies' steps --

// Step 2 of the complex bodies: X^T Y into registers, stored to dst only
// after the barrier that ends every warp's reads of X (T2 overwrites T1).
// complex64: warp w's blocks w, w + kWarps, ... of 16 x 32 (4 x 4 a lane).
template <int R>
__device__ __forceinline__ void held_product(const float2* X, int ldx,
                                             const float2* Y, int ldy, int K,
                                             int M, int N, float2* dst,
                                             const int* ro, const int* co) {
  const int n_sm = cdiv(M, 16), total = n_sm * cdiv(N, 32);
  float2 acc[R][4][4] = {};
  int m0[R], n0[R];
  bool own[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int s = (threadIdx.x >> 5) + t * kWarps;
    cx_tiles::cx_tile_of(s, n_sm, m0[t], n0[t]);
    own[t] = s < total && m0[t] < M && n0[t] < N;
    if (own[t])
      cx_tiles::csimt_acc(acc[t], X + m0[t], ldx, Y + n0[t], ldy, K);
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < R; ++t)
    if (own[t])
      cx_tiles::cx_store<true>(acc[t], m0[t], n0[t], M, N, dst, ro, co);
}

// complex128: warp w's MMA tiles w, w + kWarps, ... of 16 x 8.
template <int R>
__device__ __forceinline__ void held_product(const double2* X, int ldx,
                                             const double2* Y, int ldy, int K,
                                             int M, int N, double2* dst,
                                             const int* ro, const int* co) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_m = cdiv(M, 16), total = n_m * cdiv(N, 8);
  double acc[R][1][1][2][4] = {};
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int s = warp + t * kWarps;
    if (s < total)
      cx_tiles::zmma_acc<1, 1>(acc[t], X + q * ldx + (s % n_m) * 16 + g, ldx,
                               Y + q * ldy + (s / n_m) * 8 + g, ldy, K);
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int s = warp + t * kWarps;
    if (s >= total) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = (s % n_m) * 16 + cx_tiles::zrow(lane, v);
      const int n = (s / n_m) * 8 + cx_tiles::zcol(lane, v);
      if (m < M && n < N)
        dst[ro[m] + co[n]] = make_double2(acc[t][0][0][0][v],
                                          acc[t][0][0][1][v]);
    }
  }
}

// Step 1 of the complex bodies (written straight to T1).
__device__ __forceinline__ void step1_product(const float2* X, int ldx,
                                              const float2* Y, int ldy, int K,
                                              int M, int N, float2* dst,
                                              const int* ro, const int* co) {
  cx_tiles::cx_product<true>(X, ldx, Y, ldy, K, M, N, dst, ro, co);
}
__device__ __forceinline__ void step1_product(const double2* X, int ldx,
                                              const double2* Y, int ldy,
                                              int K, int M, int N,
                                              double2* dst, const int* ro,
                                              const int* co) {
  cx_tiles::zmma_product<1, 1>(X, ldx, Y, ldy, K, M, N, dst, ro, co);
}

// Step 3's output tiles, which stay in registers across the chunks:
// complex64, the lane's 4 x 4 tile of warp blocks w, w + kWarps, ... (16 x
// 32); complex128, warp w's tile of 2 x 2 MMA tiles (32 x 16).
template <typename T> struct Step3;
template <> struct Step3<float2> {
  static constexpr int R = Body<float2>::R3;
  float2 acc[R][4][4];
  int m0[R], n0[R];
  bool own[R];
  __device__ __forceinline__ void place(int M, int N) {
    const int n_sm = cdiv(M, 16), total = n_sm * cdiv(N, 32);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int s = (threadIdx.x >> 5) + t * kWarps;
      cx_tiles::cx_tile_of(s, n_sm, m0[t], n0[t]);
      own[t] = s < total && m0[t] < M && n0[t] < N;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < R; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][i][j] = make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void add(const float2* X, int ldx,
                                      const float2* Y, int ldy, int K) {
#pragma unroll
    for (int t = 0; t < R; ++t)
      if (own[t])
        cx_tiles::csimt_acc(acc[t], X + m0[t], ldx, Y + n0[t], ldy, K);
  }
  // out[A0 + A', r, C] for row m = r ta + A' of the tile (va valid A')
  __device__ __forceinline__ void store(float2* out, int ta, int va, int nr,
                                        int nC, int M) const {
    const bool vec = (nC & 1) == 0;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (!own[t]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0[t] + i, a = m % ta;
        if (m >= M || a >= va) continue;
        float2* const d = out + (int64_t(a) * nr + m / ta) * nC + n0[t];
        if (vec && n0[t] + 4 <= nC) {
          reinterpret_cast<float4*>(d)[0] = make_float4(
              acc[t][i][0].x, acc[t][i][0].y, acc[t][i][1].x, acc[t][i][1].y);
          reinterpret_cast<float4*>(d)[1] = make_float4(
              acc[t][i][2].x, acc[t][i][2].y, acc[t][i][3].x, acc[t][i][3].y);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n0[t] + j < nC) d[j] = acc[t][i][j];
        }
      }
    }
  }
};
template <> struct Step3<double2> {
  double acc[2][2][2][4];
  int m0, n0;
  bool own;
  __device__ __forceinline__ void place(int M, int N) {
    const int warp = threadIdx.x >> 5, n_m = cdiv(M, 32);
    own = warp < n_m * cdiv(N, 16);
    m0 = (warp % n_m) * 32;
    n0 = (warp / n_m) * 16;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][h][v] = 0.0;
  }
  __device__ __forceinline__ void add(const double2* X, int ldx,
                                      const double2* Y, int ldy, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    if (own)   // warp-uniform
      cx_tiles::zmma_acc<2, 2, false>(acc, X + q * ldx + m0 + g, ldx,
                                      Y + q * ldy + n0 + g, ldy, K);
  }
  __device__ __forceinline__ void store(double2* out, int ta, int va, int nr,
                                        int nC, int M) const {
    if (!own) return;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int m = m0 + 16 * i + cx_tiles::zrow(lane, v), a = m % ta;
          const int c = n0 + 8 * j + cx_tiles::zcol(lane, v);
          if (m < M && a < va && c < nC)
            out[(int64_t(a) * nr + m / ta) * nC + c] =
                make_double2(acc[i][j][0][v], acc[i][j][1][v]);
        }
  }
};

// ---------------------------------------------------------------- kernel --

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
col_transfer_kernel(const T* __restrict__ env, const T* __restrict__ top,
                    const T* __restrict__ site, const T* __restrict__ bot,
                    T* __restrict__ out, const Meta m, const Plan p) {
  constexpr int kKind = Body<T>::kind;
  constexpr bool kCx = kKind >= 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const Ts = sm + p.oT;     // [a][u*ta + A']
  T* const Ss = sm + p.oS;     // [u*nl + l][d*nr + r] (complex: [l*nu + u])
  T* const T1 = sm + p.oT1;    // [u*nl + l][c'*ta + A'] (complex: [l*nu + u])
  T* const T2 = T1;            // [c'*nd + d][r*ta + A'], over T1

  const int tid = threadIdx.x;
  const int64_t item = blockIdx.x / p.n_split;
  const int split = static_cast<int>(blockIdx.x % p.n_split);
  int64_t rem = item;
  int64_t off_e = 0, off_t = 0, off_s = 0, off_b = 0;
  for (int k = kMaxBatch - 1; k >= 0; --k) {
    const int64_t i = rem % m.nb[k];
    rem /= m.nb[k];
    off_e += i * m.se[k];
    off_t += i * m.st[k];
    off_s += i * m.ss[k];
    off_b += i * m.sb[k];
  }
  const T* const e = env + off_e;
  const T* const tp = top + off_t;
  const T* const b = bot + off_b;
  const int64_t* se = m.se + kMaxBatch;
  const int64_t* st = m.st + kMaxBatch;
  const int64_t* sb = m.sb + kMaxBatch;
  const int ta = p.ta, kc = p.kc;

  if constexpr (Body<T>::kq > 1) {
    // the rows that pad K to the MMA's 8 are read as zeros: zero all
    for (int i = tid; i < p.box_off / 16; i += kThreads)
      reinterpret_cast<int4*>(smem_raw)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }

  // The four copies, planned once per CTA by thread 0:
  //   E[a][l*kc + c'] = env[a, l, c0 + c']    (per chunk, c' clipped)
  //   B[c'*nd + d][C] = bot[c0 + c', d, C]    (per chunk, c' clipped;
  //                                            complex: B[d*kc + c'])
  //   Ts[a][u*ta + A'] = top[a, u, A0 + A']   (per pass, A' clipped)
  //   Ss[u*nl + l][d*nr + r] = site[u, l, d, r]  (once; complex: [l*nu + u])
  constexpr int W = 16 / sizeof(T);
  Box* const boxes = reinterpret_cast<Box*>(smem_raw + p.box_off);
  if (tid == 0) {
    auto plan = [&](Box& bx, bool vec, int n0, int n1, int n2, int n3,
                    int64_t s0, int64_t s1, int64_t s2, int64_t s3, int d0,
                    int d1, int d2, int cpos) {
      int n[4] = {n0, n1, n2, n3}, v[4] = {n0, n1, n2, n3};
      int64_t s[4] = {s0, s1, s2, s3};
      int d[4] = {d0, d1, d2, 1};
      if (vec) plan_box<W>(bx, n, s, d, v, cpos);
      else plan_box<1>(bx, n, s, d, v, cpos);
    };
    const int64_t* ss = m.ss + kMaxBatch;
    plan(boxes[0], p.vec_e, 1, m.na, m.nl, kc, 0, se[0], se[1], se[2], 0,
         p.ldE, kc, 3);
    plan(boxes[1], p.vec_b, 1, kc, m.nd, m.nC, 0, sb[0], sb[1], sb[2], 0,
         kCx ? p.ldB : m.nd * p.ldB, kCx ? kc * p.ldB : p.ldB, 1);
    plan(boxes[2], p.vec_t, 1, m.na, m.nu, ta, 0, st[0], st[1], st[2], 0,
         p.ldT, ta, 3);
    plan(boxes[3], p.vec_s, m.nu, m.nl, m.nd, m.nr, ss[0], ss[1], ss[2],
         ss[3], kCx ? p.ldS : m.nl * p.ldS, kCx ? m.nu * p.ldS : p.ldS,
         m.nr, 0);
  }
  __syncthreads();
  auto copy = [&](int k, bool vec, uint2 first, T* dst, const T* src,
                  int cv) {
    if (vec) run_box<T, W>(boxes[k], first, dst, src, cv);
    else run_box<T, 1>(boxes[k], first, dst, src, cv);
  };
  copy(3, p.vec_s, first_digits(boxes[3]), Ss, site + off_s, m.nu);
  const uint2 first_e = first_digits(boxes[0]);
  const uint2 first_b = first_digits(boxes[1]);
  auto stage_chunk = [&](int ch) {
    const int c0 = ch * kc;
    copy(0, p.vec_e, first_e, sm + p.oE + (ch & 1) * p.szE, e + c0 * se[2],
         m.nc - c0);
    copy(1, p.vec_b, first_b, sm + p.oB + (ch & 1) * p.szB, b + c0 * sb[0],
         m.nc - c0);
  };

  if constexpr (!kCx) {
    // Tile geometry. the plan keeps ta a multiple of 8 and kc one of TM1, so
    // a step-1 tile is one l, TM1 c' and 8 consecutive A', a step-2 tile 4
    // consecutive A' at one c', and each thread owns at most one tile of
    // steps 1 and 2 and C::R3 tiles of step 3.
    const int M1 = m.nl * kc, N1 = m.nu * ta, M2 = ta * kc, N2 = m.nd * m.nr;
    const int M3 = ta * m.nr, N3 = m.nC;
    int mi, ni;
    const bool ok1 = tile_of(tid, cdiv(M1, C::TM1), cdiv(N1, C::TN1), mi, ni);
    const int m01 = mi * C::TM1, n01 = ni * C::TN1;
    // T1 index of the tile's value (i, j): dst1 + i*ta + j
    const int dst1 = ((n01 / ta) * m.nl + m01 / kc) * p.ld1 +
                     (m01 % kc) * ta + n01 % ta;
    const bool ok2 = tile_of(tid, cdiv(M2, C::TM2), cdiv(N2, C::TN2), mi, ni);
    const int m02 = mi * C::TM2, n02 = ni * C::TN2;
    // T2 index of the tile's value (i, j): dst2 + col2[j] + i (-1: padding)
    const int dst2 = (m02 / ta) * m.nd * p.ld2 + m02 % ta;
    int col2[C::TN2];
  #pragma unroll
    for (int j = 0; j < C::TN2; ++j) {
      const int nn = n02 + j;
      col2[j] = nn < N2 ? (nn / m.nr) * p.ld2 + (nn % m.nr) * ta : -1;
    }
    int m03[C::R3], n03[C::R3];
    bool ok3[C::R3];
  #pragma unroll
    for (int q = 0; q < C::R3; ++q) {
      ok3[q] = tile_of(tid + q * kThreads, cdiv(M3, C::TM3), cdiv(N3, C::TN3),
                       mi, ni);
      m03[q] = mi * C::TM3;
      n03[q] = ni * C::TN3;
    }
    const int n_ch = cdiv(m.nc, kc);

    for (int pass = split; pass < p.n_pass; pass += p.n_split) {
      const int A0 = pass * ta;
      __syncthreads();   // the previous pass is done with Ts and the buffers
      copy(2, p.vec_t, first_digits(boxes[2]), Ts, tp + A0 * st[2], m.nA - A0);
      stage_chunk(0);
      cp_async_commit();

      T acc3[C::R3][C::TM3][C::TN3];
  #pragma unroll
      for (int q = 0; q < C::R3; ++q)
  #pragma unroll
        for (int i = 0; i < C::TM3; ++i)
  #pragma unroll
          for (int j = 0; j < C::TN3; ++j) acc3[q][i][j] = T(0);

      for (int ch = 0; ch < n_ch; ++ch) {
        cp_async_wait_all();
        __syncthreads();   // chunk ch has landed; chunk ch-1 is consumed
        if (ch + 1 < n_ch) {
          stage_chunk(ch + 1);
          cp_async_commit();
        }
        const T* E = sm + p.oE + (ch & 1) * p.szE;
        const T* B = sm + p.oB + (ch & 1) * p.szB;

        if (ok1) {   // step 1, K = a
          T acc[C::TM1][C::TN1];
  #pragma unroll
          for (int i = 0; i < C::TM1; ++i)
  #pragma unroll
            for (int j = 0; j < C::TN1; ++j) acc[i][j] = T(0);
          mma_tile<T, C::TM1, C::TN1>(acc, E + m01, p.ldE, Ts + n01, p.ldT,
                                      m.na);
  #pragma unroll
          for (int i = 0; i < C::TM1; ++i) store_frag(T1 + dst1 + i * ta, acc[i]);
        }
        __syncthreads();
        {   // step 2, K = (u, l); T2 overwrites T1 once every thread has
            // read it
          T acc[C::TM2][C::TN2];
  #pragma unroll
          for (int i = 0; i < C::TM2; ++i)
  #pragma unroll
            for (int j = 0; j < C::TN2; ++j) acc[i][j] = T(0);
          if (ok2)
            mma_tile<T, C::TM2, C::TN2>(acc, T1 + m02, p.ld1, Ss + n02, p.ldS,
                                        m.nl * m.nu);
          __syncthreads();
  #pragma unroll
          for (int j = 0; j < C::TN2; ++j) {   // column j: TM2 consecutive A'
            T col[C::TM2];
  #pragma unroll
            for (int i = 0; i < C::TM2; ++i) col[i] = acc[i][j];
            if (ok2 && col2[j] >= 0) store_frag(T2 + dst2 + col2[j], col);
          }
        }
        __syncthreads();
  #pragma unroll
        for (int q = 0; q < C::R3; ++q)   // step 3, K = (c', d)
          if (ok3[q])
            mma_tile<T, C::TM3, C::TN3>(acc3[q], T2 + m03[q], p.ld2,
                                        B + n03[q], p.ldB, kc * m.nd);
      }

  #pragma unroll
      for (int q = 0; q < C::R3; ++q) {   // out[A0 + A', r, C], m = r*ta + A'
        if (!ok3[q]) continue;
        const int r = m03[q] / ta, a0 = A0 + m03[q] % ta;
  #pragma unroll
        for (int i = 0; i < C::TM3; ++i) {
          if (m03[q] + i >= M3 || a0 + i >= m.nA) continue;
          T* o = out + ((item * m.nA + a0 + i) * m.nr + r) * m.nC;
  #pragma unroll
          for (int j = 0; j < C::TN3; ++j)
            if (n03[q] + j < N3) o[n03[q] + j] = acc3[q][i][j];
        }
      }
    }
  } else {
    // The complex bodies. Tables place the product values (row part +
    // column part): step 1 runs as Ts^T E, P1[(u,A')][(l,c')] ->
    // T1[l*nu + u][c'*ta + A']; step 2, P2[(c',A')][(d,r)] ->
    // T2[d*kc + c'][r*ta + A'].
    constexpr int kq = Body<T>::kq;
    T* const X2 = sm + p.oT2;
    const int M1 = m.nu * ta, N1 = m.nl * kc, K1 = round_up(m.na, kq);
    const int M2 = kc * ta, N2 = m.nd * m.nr, K2 = round_up(m.nu * m.nl, kq);
    const int M3 = ta * m.nr, K3 = round_up(kc * m.nd, kq);
    int* const ro1 = reinterpret_cast<int*>(smem_raw + p.oTab);
    int* const co1 = ro1 + M1;
    int* const ro2 = co1 + N1;
    int* const co2 = ro2 + M2;
    for (int i = tid; i < M1; i += kThreads) ro1[i] = (i / ta) * p.ld1 + i % ta;
    for (int i = tid; i < N1; i += kThreads)
      co1[i] = (i / kc) * m.nu * p.ld1 + (i % kc) * ta;
    for (int i = tid; i < M2; i += kThreads) ro2[i] = (i / ta) * p.ld2 + i % ta;
    for (int i = tid; i < N2; i += kThreads)
      co2[i] = (i / m.nr) * kc * p.ld2 + (i % m.nr) * ta;
    Step3<T> acc3;
    acc3.place(M3, m.nC);
    const int n_ch = cdiv(m.nc, kc);

    for (int pass = split; pass < p.n_pass; pass += p.n_split) {
      const int A0 = pass * ta;
      __syncthreads();   // the previous pass is done with Ts and the buffers
      copy(2, p.vec_t, first_digits(boxes[2]), Ts, tp + A0 * st[2], m.nA - A0);
      stage_chunk(0);
      cp_async_commit();
      acc3.zero();
      for (int ch = 0; ch < n_ch; ++ch) {
        cp_async_wait_all();
        __syncthreads();   // chunk ch has landed; chunk ch-1 is consumed
        if (ch + 1 < n_ch) {
          stage_chunk(ch + 1);
          cp_async_commit();
        }
        const T* E = sm + p.oE + (ch & 1) * p.szE;
        const T* B = sm + p.oB + (ch & 1) * p.szB;
        step1_product(Ts, p.ldT, E, p.ldE, K1, M1, N1, T1, ro1, co1);
        __syncthreads();
        held_product<Body<T>::R2>(T1, p.ld1, Ss, p.ldS, K2, M2, N2, X2, ro2,
                                  co2);
        __syncthreads();
        acc3.add(X2, p.ld2, B, p.ldB, K3);
      }
      acc3.store(out + (item * m.nA + A0) * m.nr * m.nC, ta,
                 m.nA - A0 < ta ? m.nA - A0 : ta, m.nr, m.nC, M3);
    }
  }
}

// ------------------------------------------------------------------ host --

// meta layout (int64): nb[4], env strides[7], top strides[7],
// site strides[8], bot strides[7], na, nl, nc, nu, nA, nd, nr, nC, then
// the plan's kPlanInts values.
Meta unpack(const int64_t* p) {
  Meta m;
  for (int k = 0; k < kMaxBatch; ++k) m.nb[k] = *p++;
  for (int k = 0; k < kMaxBatch + 3; ++k) m.se[k] = *p++;
  for (int k = 0; k < kMaxBatch + 3; ++k) m.st[k] = *p++;
  for (int k = 0; k < kMaxBatch + 4; ++k) m.ss[k] = *p++;
  for (int k = 0; k < kMaxBatch + 3; ++k) m.sb[k] = *p++;
  m.na = static_cast<int>(*p++);
  m.nl = static_cast<int>(*p++);
  m.nc = static_cast<int>(*p++);
  m.nu = static_cast<int>(*p++);
  m.nA = static_cast<int>(*p++);
  m.nd = static_cast<int>(*p++);
  m.nr = static_cast<int>(*p++);
  m.nC = static_cast<int>(*p++);
  return m;
}

bool unpack_plan(const int64_t* p, Plan& plan) {
  int* fields[] = {&plan.mode, &plan.ta,  &plan.kc,  &plan.ldT,  &plan.ldS,
                   &plan.ldE,  &plan.ld1, &plan.ld2, &plan.ldB,  &plan.oT,
                   &plan.oS,   &plan.oE,  &plan.oT1, &plan.oT2,  &plan.oB,
                   &plan.szE,  &plan.szB, &plan.oTab, &plan.box_off,
                   &plan.smem};
  static_assert(sizeof(fields) / sizeof(fields[0]) == kPlanInts, "plan");
  for (int* f : fields) {
    if (*p < 0 || *p > static_cast<int64_t>(kSmemLimit)) return false;
    *f = static_cast<int>(*p++);
  }
  return true;
}

int64_t batch_items(const Meta& m) {
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) items *= m.nb[k];
  return items;
}

// Whether this code can run the plan: the real bodies' tiles (ta a multiple
// of 8, kc one of TM1, at most one tile a thread in steps 1 and 2 and R3 in
// step 3) or the complex bodies' (step 2's and step 3's tiles within what a
// warp holds), leading dims that cover the columns each product reads and
// keep its vector loads aligned, K padded to the MMA's 8 where needed,
// aligned disjoint regions (T2 over T1 only where no padding row of one lies
// under the other's values; the real bodies always over T1), the tables
// and the Box plans inside the shared bytes. A plan that passes reads and
// writes only inside its own shared memory.
template <typename T, typename C>
bool check_plan(const Meta& m, const Plan& p) {
  constexpr int kind = Body<T>::kind, kq = Body<T>::kq;
  constexpr int W = 16 / sizeof(T);
  for (int n : {m.na, m.nl, m.nc, m.nu, m.nA, m.nd, m.nr, m.nC})
    if (n >= 65536) return false;   // copy digits are 16-bit (first_digits)
  const int ta = p.ta, kc = p.kc;
  if (p.mode != C::kMode || ta < 1 || kc < 1 || ta > 4096 || kc > 4096)
    return false;
  auto kp = [](int x) { return round_up(x, kq); };
  const int M1 = m.nu * ta, N1 = m.nl * kc, M2 = kc * ta, N2 = m.nd * m.nr;
  const int M3 = ta * m.nr;
  int need[6];   // ldT, ldS, ldE, ld1, ld2, ldB
  if constexpr (kind <= 1) {
    if (ta % 8 != 0 || kc % C::TM1 != 0 ||
        tiles(N1, C::TM1, M1, C::TN1) > kThreads ||
        tiles(M2, C::TM2, N2, C::TN2) > kThreads ||
        tiles(M3, C::TM3, m.nC, C::TN3) > C::R3 * kThreads)
      return false;
    const int n[] = {M1, round_up(N2, C::TN2), N1, M2, M3,
                     round_up(m.nC, C::TN3)};
    for (int i = 0; i < 6; ++i) need[i] = n[i];
  } else if constexpr (kind == 2) {
    // warp blocks of 16 (X) x 32 (Y)
    if (cdiv(M2, 16) * cdiv(N2, 32) > kWarps * Body<T>::R2 ||
        cdiv(M3, 16) * cdiv(m.nC, 32) > kWarps * Body<T>::R3)
      return false;
    const int n[] = {round_up(M1, 16), round_up(N2, 32), round_up(N1, 32),
                     round_up(M2, 16), round_up(M3, 16), round_up(m.nC, 32)};
    for (int i = 0; i < 6; ++i) need[i] = n[i];
  } else {
    // MMA tiles of 16 (X) x 8 (Y); step 3's warp tiles of 32 x 16
    if (cdiv(M2, 16) * cdiv(N2, 8) > kWarps * Body<T>::R2 ||
        cdiv(M3, 32) * cdiv(m.nC, 16) > kWarps * Body<T>::R3)
      return false;
    const int n[] = {round_up(M1, 16), round_up(N2, 8), round_up(N1, 8),
                     round_up(M2, 16), round_up(M3, 32), round_up(m.nC, 16)};
    for (int i = 0; i < 6; ++i) need[i] = n[i];
  }
  const int lds[] = {p.ldT, p.ldS, p.ldE, p.ld1, p.ld2, p.ldB};
  for (int i = 0; i < 6; ++i)
    if (lds[i] < need[i] || lds[i] % W != 0) return false;
  const int64_t t1 = int64_t(kp(m.nu * m.nl)) * p.ld1;
  const int64_t t2 = int64_t(kp(kc * m.nd)) * p.ld2;
  const bool shared12 = p.oT2 == p.oT1;
  if (kind <= 1 && !shared12) return false;
  if (shared12 && ((m.nu * m.nl) % kq != 0 || (kc * m.nd) % kq != 0))
    return false;
  if (p.szE < int64_t(kp(m.na)) * p.ldE || p.szB < int64_t(kp(kc * m.nd)) * p.ldB ||
      p.szE % W != 0 || p.szB % W != 0)
    return false;
  struct Region { int64_t o, n; };
  const Region regions[] = {
      {p.oT, int64_t(kp(m.na)) * p.ldT},
      {p.oS, int64_t(kp(m.nu * m.nl)) * p.ldS},
      {p.oE, 2 * int64_t(p.szE)},
      {p.oT1, shared12 && t2 > t1 ? t2 : t1},
      {p.oT2, shared12 ? 0 : t2},
      {p.oB, 2 * int64_t(p.szB)}};
  int64_t end = 0;
  for (int i = 0; i < 6; ++i) {
    const Region& a = regions[i];
    if (a.o % W != 0) return false;
    if (a.o + a.n > end) end = a.o + a.n;
    for (int j = 0; j < i; ++j) {
      const Region& c = regions[j];
      if (a.n > 0 && c.n > 0 && a.o < c.o + c.n && c.o < a.o + a.n)
        return false;
    }
  }
  const int64_t tab = kind >= 2 ? int64_t(M1) + N1 + M2 + N2 : 0;
  return p.oTab % 16 == 0 && p.oTab >= end * int64_t(sizeof(T)) &&
         p.oTab + 4 * tab <= p.box_off && p.box_off % 16 == 0 &&
         p.smem == p.box_off + 4 * int64_t(sizeof(Box)) &&
         p.smem <= int64_t(kSmemLimit);
}

constexpr int kMaxDevices = 64;

// Once per (instantiation, device): the kernel may take the whole 227 KB.
template <typename T, typename C>
int prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(col_transfer_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  return static_cast<int>(cudaSuccess);
}

// Whether an operand can move in 16-byte copies along its last dim (the
// contiguous dim of its shared-memory copy): unit stride there, and the
// pointer and every other stride 16-byte aligned. The callers add the
// extents' conditions.
template <typename T>
bool copies_16b(const T* ptr, const int64_t* strides, int ndim) {
  constexpr int W = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || strides[ndim - 1] != 1)
    return false;
  for (int k = 0; k < ndim - 1; ++k)
    if (strides[k] % W != 0) return false;
  return true;
}

template <typename T, typename C>
int launch_cfg(const T* env, const T* top, const T* site, const T* bot,
               T* out, const Meta& m, Plan& p, cudaStream_t stream) {
  if (!check_plan<T, C>(m, p)) return static_cast<int>(cudaErrorInvalidValue);
  p.n_pass = cdiv(m.nA, p.ta);
  p.n_split = C::kMode == 0 ? 1 : p.n_pass;
  p.ctas = batch_items(m) * p.n_split;
  if (p.ctas >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare<T, C>();
  if (err != 0) return err;
  constexpr int W = 16 / sizeof(T);
  p.vec_e = copies_16b(env, m.se, kMaxBatch + 3) && m.nc % W == 0 &&
            p.kc % W == 0;
  p.vec_b = copies_16b(bot, m.sb, kMaxBatch + 3) && m.nC % W == 0;
  p.vec_t = copies_16b(top, m.st, kMaxBatch + 3) && m.nA % W == 0 &&
            p.ta % W == 0;
  p.vec_s = copies_16b(site, m.ss, kMaxBatch + 4) && m.nr % W == 0;
  col_transfer_kernel<T, C><<<static_cast<unsigned>(p.ctas), kThreads,
                              static_cast<size_t>(p.smem), stream>>>(
      env, top, site, bot, out, m, p);
  return static_cast<int>(cudaGetLastError());
}

// meta: the sizes and strides (kMetaLen values), then the plan (kPlanInts
// values) when the call has work.
template <typename T>
int launch(const T* env, const T* top, const T* site, const T* bot, T* out,
           const int64_t* meta, cudaStream_t stream) {
  const Meta m = unpack(meta);
  if (batch_items(m) == 0 || m.nA == 0 || m.nr == 0 || m.nC == 0)
    return static_cast<int>(cudaSuccess);
  Plan p;
  if (!unpack_plan(meta + kMetaLen, p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.mode == 0)
    return launch_cfg<T, FullCfg>(env, top, site, bot, out, m, p, stream);
  return launch_cfg<T, SplitCfg>(env, top, site, bot, out, m, p, stream);
}

template <typename T, typename C>
int attributes(int64_t smem, int64_t* out) {
  int err = prepare<T, C>();
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(
      cudaFuncGetAttributes(&attr, col_transfer_kernel<T, C>));
  if (err != 0) return err;
  int ctas = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, col_transfer_kernel<T, C>, kThreads, static_cast<size_t>(smem)));
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = ctas;
  return 0;
}

template <typename T>
int attributes_of(int mode, int64_t smem, int64_t* out) {
  return mode == 0 ? attributes<T, FullCfg>(smem, out)
                   : attributes<T, SplitCfg>(smem, out);
}

}  // namespace

extern "C" {

int col_transfer_f32(const float* env, const float* top, const float* site,
                     const float* bot, float* out, const int64_t* meta,
                     void* stream) {
  return launch<float>(env, top, site, bot, out, meta,
                       static_cast<cudaStream_t>(stream));
}

int col_transfer_f64(const double* env, const double* top,
                     const double* site, const double* bot, double* out,
                     const int64_t* meta, void* stream) {
  return launch<double>(env, top, site, bot, out, meta,
                        static_cast<cudaStream_t>(stream));
}

// complex64 / complex128 (interleaved (re, im) elements; meta as above)
int col_transfer_c64(const void* env, const void* top, const void* site,
                     const void* bot, void* out, const int64_t* meta,
                     void* stream) {
  using V = float2;
  return launch<V>(static_cast<const V*>(env), static_cast<const V*>(top),
                   static_cast<const V*>(site), static_cast<const V*>(bot),
                   static_cast<V*>(out), meta,
                   static_cast<cudaStream_t>(stream));
}

int col_transfer_c128(const void* env, const void* top, const void* site,
                      const void* bot, void* out, const int64_t* meta,
                      void* stream) {
  using V = double2;
  return launch<V>(static_cast<const V*>(env), static_cast<const V*>(top),
                   static_cast<const V*>(site), static_cast<const V*>(bot),
                   static_cast<V*>(out), meta,
                   static_cast<cudaStream_t>(stream));
}

// The compiled kernel of one body (0 f32, 1 f64, 2 complex64, 3 complex128)
// and mode at a plan's shared bytes: out[0..2] = registers a thread, local
// (spill) bytes a thread, CTAs an SM holds.
int col_transfer_attributes(int kind, int mode, int64_t smem_bytes,
                            int64_t* out) {
  switch (kind) {
    case 0: return attributes_of<float>(mode, smem_bytes, out);
    case 1: return attributes_of<double>(mode, smem_bytes, out);
    case 2: return attributes_of<float2>(mode, smem_bytes, out);
    case 3: return attributes_of<double2>(mode, smem_bytes, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* peps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
