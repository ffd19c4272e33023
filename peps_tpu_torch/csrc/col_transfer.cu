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
// the candidate sites shared by all chains).
//
// What bounds it on the H100: one item costs
//   2 (a l c u A + A c l u d r + A r c d C) flops,
// 16.8 MFLOP at chi = 32, D = 8, c = C = 32, against ~0.1 MB of operands,
// so the transfer is compute-bound. f32 runs on the FP32 CUDA cores, which
// are its peak: TF32 tensor cores are not used, the main path keeps full f32
// sums. f64 runs on DFMA, half the card's f64 peak (the DMMA tensor cores,
// which a later body may use).
//
// Design. Per item, the transfer is three register-tiled SIMT GEMMs whose
// operands both sit in shared memory, streamed over chunks of KC values of
// the env/bot index c (A' runs over the CTA's tile of TA values of A):
//   step 1  T1[(u,l),(c',A')] = sum_a   env[a,(l,c')]    top[a,(u,A')]
//   step 2  T2[(c',d),(r,A')] = sum_ul  T1[(u,l),(c',A')] site[(u,l),(d,r)]
//   step 3  out[(r,A'),C]    += sum_c'd T2[(c',d),(r,A')] bot[(c',d),C]
// Each step stores its result in the K-major layout the next step reads,
// with A' innermost, so that a thread writes its tile as 16-byte vectors and
// a warp's stores fall into distinct banks (leading dims are padded off
// multiples of 32 words); T2 overwrites T1 once step 2 has read it. out
// accumulates in registers over the chunks, so no global-memory load sits
// inside a product loop. site is copied in once and top once per A tile;
// env and bot stream chunk by chunk with cp.async into two buffers each, so
// chunk k+1 lands while chunk k is multiplied. Every copy writes the GEMM
// layout whatever the caller's strides are: 16-byte copies where the
// operand is unit-stride along the shared copy's rows and aligned,
// otherwise 4/8-byte copies with consecutive threads on the operand's
// smallest stride (the right form's transposed views stay coalesced). Each
// copy is planned once per CTA (Box), so no division runs per chunk. Every
// thread owns at most one output tile per step (4x8 values in the
// large-batch plan), fed by 16-byte shared loads; the lanes of a warp cover
// an 8 x 4 block of tiles, so each shared load serves several lanes.
//
// Split across CTAs (make_plan): with at least 1.5 items per SM one CTA owns
// an item and its whole A range (TA = 32, KC = 4: env and bot are read once
// per item at chi = 32; 103 KB of shared memory and 128 registers, so two
// CTAs share an SM). Below that, the A range is cut into tiles of TA = 8,
// one CTA each, so that a 32-item call still fills 128 SMs; that plan uses
// smaller register tiles (2x8, 4x4, 2x4, two step-3 tiles per thread) and
// KC = 8. TA and KC shrink when a shape's tiles or shared memory would not
// fit (TA stays a multiple of 8 and is zero-filled past the last A).

#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;
constexpr size_t kSmemLimit = 232448;

struct Meta {
  int64_t nb[kMaxBatch];              // batch sizes, padded with 1
  int64_t se[kMaxBatch + 3];          // env strides: batch..., a, l, c
  int64_t st[kMaxBatch + 3];          // top strides: batch..., a, u, A
  int64_t ss[kMaxBatch + 4];          // site strides: batch..., u, l, d, r
  int64_t sb[kMaxBatch + 3];          // bot strides: batch..., c, d, C
  int na, nl, nc, nu, nA, nd, nr, nC;
};

// Thread tiles of the three steps (TMk x TNk values), step-3 tiles per
// thread, the default A-range tile and c-chunk.
template <int TM1_, int TN1_, int TM2_, int TN2_, int TM3_, int TN3_, int R3_,
          int TA_, int KC_, int kMode_>
struct Cfg {
  static constexpr int TM1 = TM1_, TN1 = TN1_, TM2 = TM2_, TN2 = TN2_;
  static constexpr int TM3 = TM3_, TN3 = TN3_, R3 = R3_, TA = TA_, KC = KC_;
  static constexpr int kMode = kMode_;
};
using FullCfg = Cfg<4, 8, 4, 8, 4, 8, 1, 32, 4, 0>;    // one CTA per item
using SplitCfg = Cfg<2, 8, 4, 4, 2, 4, 2, 8, 8, 1>;    // one CTA per A tile

struct Plan {
  int mode, ta, kc, n_pass, n_split;
  int ldT, ldS, ldE, ld1, ld2, ldB;     // leading dims (elements)
  int oT, oS, oE, oT1, oB;              // region offsets (elements)
  int szE, szB;                         // one stream buffer (elements)
  int box_off;                          // the four Box plans (bytes)
  int vec_e, vec_b, vec_t, vec_s;       // operands copied 16 B-wise
  int64_t ctas;
  size_t smem;                          // bytes
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

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
col_transfer_kernel(const T* __restrict__ env, const T* __restrict__ top,
                    const T* __restrict__ site, const T* __restrict__ bot,
                    T* __restrict__ out, const Meta m, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const Ts = sm + p.oT;     // [a][u*ta + A']
  T* const Ss = sm + p.oS;     // [u*nl + l][d*nr + r]
  T* const T1 = sm + p.oT1;    // [u*nl + l][c'*ta + A']
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

  // The four copies, planned once per CTA by thread 0:
  //   E[a][l*kc + c'] = env[a, l, c0 + c']    (per chunk, c' clipped)
  //   B[c'*nd + d][C] = bot[c0 + c', d, C]    (per chunk, c' clipped)
  //   Ts[a][u*ta + A'] = top[a, u, A0 + A']   (per pass, A' clipped)
  //   Ss[u*nl + l][d*nr + r] = site[u, l, d, r]  (once)
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
         m.nd * p.ldB, p.ldB, 1);
    plan(boxes[2], p.vec_t, 1, m.na, m.nu, ta, 0, st[0], st[1], st[2], 0,
         p.ldT, ta, 3);
    plan(boxes[3], p.vec_s, m.nu, m.nl, m.nd, m.nr, ss[0], ss[1], ss[2],
         ss[3], m.nl * p.ldS, p.ldS, m.nr, 0);
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

  // Tile geometry. make_plan keeps ta a multiple of 8 and kc one of TM1, so
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
}

// ------------------------------------------------------------------ host --

// meta layout (int64): nb[4], env strides[7], top strides[7],
// site strides[8], bot strides[7], na, nl, nc, nu, nA, nd, nr, nC.
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

int64_t batch_items(const Meta& m) {
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) items *= m.nb[k];
  return items;
}

// A leading dim: a multiple of 4 elements (16-byte rows), and not of 32, so
// that the rows a warp stores into start in different banks.
int lead(int x) {
  const int ld = round_up(x, 4);
  return ld % 32 == 0 ? ld + 4 : ld;
}

// Lay out shared memory for A-range tile ta and c-chunk kc; false when a
// step has more tiles than the CTA owns or the buffers exceed 227 KB.
template <typename T, typename C>
bool layout(const Meta& m, int ta, int kc, Plan& p) {
  p.ta = ta;
  p.kc = kc;
  p.ldT = lead(m.nu * ta);
  p.ldS = lead(round_up(m.nd * m.nr, C::TN2));
  p.ldE = lead(m.nl * kc);
  p.ld1 = lead(kc * ta);
  p.ld2 = lead(ta * m.nr);
  p.ldB = lead(round_up(m.nC, C::TN3));
  p.szE = m.na * p.ldE;
  p.szB = kc * m.nd * p.ldB;
  p.oT = 0;
  p.oS = p.oT + m.na * p.ldT;
  p.oE = p.oS + m.nl * m.nu * p.ldS;
  p.oT1 = p.oE + 2 * p.szE;   // T2 overwrites T1 once step 2 has read it
  const int t12 = m.nl * m.nu * p.ld1 > kc * m.nd * p.ld2
                      ? m.nl * m.nu * p.ld1 : kc * m.nd * p.ld2;
  p.oB = p.oT1 + t12;
  p.box_off = round_up(static_cast<int>(sizeof(T)) * (p.oB + 2 * p.szB), 16);
  p.smem = p.box_off + 4 * sizeof(Box);
  return tiles(m.nl * kc, C::TM1, m.nu * ta, C::TN1) <= kThreads &&
         tiles(ta * kc, C::TM2, m.nd * m.nr, C::TN2) <= kThreads &&
         tiles(ta * m.nr, C::TM3, m.nC, C::TN3) <= C::R3 * kThreads &&
         p.smem <= kSmemLimit;
}

// ta: a multiple of 8 (A' beyond nA is zero-filled); kc: a multiple of
// TM1 (c' beyond nc is zero-filled). Both halve until the layout fits.
template <typename T, typename C>
bool plan_for(const Meta& m, Plan& p) {
  static_assert(C::TN1 == 8 && C::TM2 == 4 && C::TM3 <= 8,
                "the T1/T2 stores assume 8 and 4 consecutive A' per tile");
  int ta = round_up(m.nA < C::TA ? m.nA : C::TA, 8);
  int kc = round_up(m.nc < C::KC ? m.nc : C::KC, C::TM1);
  while (!layout<T, C>(m, ta, kc, p)) {
    if (ta > 8) ta = round_up(ta / 2, 8);
    else if (kc > C::TM1) kc = round_up(kc / 2, C::TM1);
    else return false;
  }
  p.mode = C::kMode;
  p.n_pass = cdiv(m.nA, p.ta);
  p.n_split = C::kMode == 0 ? 1 : p.n_pass;
  p.ctas = batch_items(m) * p.n_split;
  return true;
}

constexpr int kMaxDevices = 64;

// The current device and its SM count, cached per device.
cudaError_t current_device(int& dev, int& sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = n;
  }
  sms = cached[dev];
  return cudaSuccess;
}

// The plan rule: one CTA per item when there are at least 1.5 items per SM,
// else one CTA per (item, A tile). At chi = 32 a whole-item CTA does the
// work of four A-tile CTAs in less than four times their time, so it wins
// once the items alone fill most of one wave of two CTAs per SM.
int64_t item_cta_threshold(int sms) {
  return (3 * static_cast<int64_t>(sms) + 1) / 2;
}

template <typename T>
bool make_plan(const Meta& m, int sms, Plan& p) {
  for (int n : {m.na, m.nl, m.nc, m.nu, m.nA, m.nd, m.nr, m.nC})
    if (n >= 65536) return false;   // copy digits are 16-bit (first_digits)
  if (batch_items(m) >= item_cta_threshold(sms))
    return plan_for<T, FullCfg>(m, p);
  return plan_for<T, SplitCfg>(m, p);
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
               T* out, const Meta& m, const Plan& p, int dev,
               cudaStream_t stream) {
  // once per (instantiation, device), not per launch
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        col_transfer_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  col_transfer_kernel<T, C><<<static_cast<unsigned>(p.ctas), kThreads, p.smem,
                              stream>>>(env, top, site, bot, out, m, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* env, const T* top, const T* site, const T* bot, T* out,
           const int64_t* meta, cudaStream_t stream) {
  const Meta m = unpack(meta);
  if (batch_items(m) == 0 || m.nA == 0 || m.nr == 0 || m.nC == 0)
    return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  const cudaError_t err = current_device(dev, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!make_plan<T>(m, sms, p) || p.ctas >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int W = 16 / sizeof(T);
  p.vec_e = copies_16b(env, m.se, kMaxBatch + 3) && m.nc % W == 0 &&
            p.kc % W == 0;
  p.vec_b = copies_16b(bot, m.sb, kMaxBatch + 3) && m.nC % W == 0;
  p.vec_t = copies_16b(top, m.st, kMaxBatch + 3) && m.nA % W == 0;
  p.vec_s = copies_16b(site, m.ss, kMaxBatch + 4) && m.nr % W == 0;
  if (p.mode == 0)
    return launch_cfg<T, FullCfg>(env, top, site, bot, out, m, p, dev, stream);
  return launch_cfg<T, SplitCfg>(env, top, site, bot, out, m, p, dev, stream);
}

// ------------------------------------------------------ complex bodies --
//
// complex64 / complex128: the same transfer, with no conjugate anywhere
// (col_transfer_plain's three einsums). A separate, simple body; the real
// bodies above are untouched. What bounds it: operations, 4 real FMAs per
// complex multiply-add (chi = 32, D = 8, c = C = 32: 67 MFLOP an item), on
// the FP32 CUDA cores for complex64 and the FP64 ones for complex128 (no
// tensor cores take complex here). Design: one CTA owns an (item, tile of
// ta values of A) and walks c in chunks of kc values; site is copied into
// shared memory once and the top tile once, env and bot per chunk, each
// with the operand's own strides (the right form's transposed views and
// stride-0 broadcasts alike) and zero-filled past the last c or A. Per
// chunk the three products run as one loop nest each, every operand in
// shared memory, each thread walking its outputs by the block stride:
//   step 1  X1[u][l][c'][A'] = sum_a  E[a][l][c'] Tt[a][u][A']
//   step 2  X2[c'][d][r][A'] = sum_ul X1[u][l][c'][A'] S[u][l][d][r]
//   step 3  acc[A'][r][C]   += sum_c'd X2[c'][d][r][A'] B[c'][d][C]
// A' runs fastest over the lanes in steps 1-2 (the other operand's loads
// broadcast), C in step 3 (B's loads consecutive, X2's broadcast); the
// output tile stays in registers, at most kCxOut values a thread. ta and kc
// come from kernels/col_transfer.py:col_transfer_complex_plan, and
// cx_layout here recomputes the layout and refuses a plan that does not
// match it or does not fit.
// The launch bounds name one CTA an SM as the floor: without it ptxas kept
// these bodies to 48-64 registers and spilled (89-114 registers, no spill,
// with it).

constexpr int kCxOut = 8;   // output values a thread keeps in registers
constexpr int kMetaLen = kMaxBatch + 3 * (kMaxBatch + 3) + (kMaxBatch + 4) + 8;

struct CxPlan {
  int ta, kc;
  int64_t oS, oT, oE, oB, oX1, oX2;   // region offsets (elements)
  int64_t smem;                       // bytes
};

bool cx_layout(const Meta& m, int ta, int kc, int elem, CxPlan& p) {
  p.ta = ta;
  p.kc = kc;
  int64_t off = 0;
  p.oS = off;
  off += int64_t(m.nu) * m.nl * m.nd * m.nr;
  p.oT = off;
  off += int64_t(m.na) * m.nu * ta;
  p.oE = off;
  off += int64_t(m.na) * m.nl * kc;
  p.oB = off;
  off += int64_t(kc) * m.nd * m.nC;
  p.oX1 = off;
  off += int64_t(m.nu) * m.nl * kc * ta;
  p.oX2 = off;
  off += int64_t(kc) * m.nd * m.nr * ta;
  p.smem = off * elem;
  return ta >= 1 && kc >= 1 && ta <= m.nA && kc <= m.nc &&
         p.smem <= int64_t(kSmemLimit) &&
         int64_t(ta) * m.nr * m.nC <= int64_t(kCxOut) * kThreads;
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 1)
col_transfer_cx_kernel(const V* __restrict__ env, const V* __restrict__ top,
                       const V* __restrict__ site, const V* __restrict__ bot,
                       V* __restrict__ out, const Meta m, const CxPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* const sm = reinterpret_cast<V*>(smem_raw);
  V* const S = sm + p.oS;
  V* const Tt = sm + p.oT;
  V* const E = sm + p.oE;
  V* const B = sm + p.oB;
  V* const X1 = sm + p.oX1;
  V* const X2 = sm + p.oX2;
  const int tid = threadIdx.x;
  const int ta = p.ta, kc = p.kc;
  const int na = m.na, nl = m.nl, nu = m.nu, nd = m.nd, nr = m.nr;
  const int nC = m.nC;
  const int n_tiles = cdiv(m.nA, ta);
  const int64_t item = blockIdx.x / n_tiles;
  const int A0 = static_cast<int>(blockIdx.x % n_tiles) * ta;
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
  const V* const e = env + off_e;
  const V* const tp = top + off_t;
  const V* const st = site + off_s;
  const V* const b = bot + off_b;
  const int64_t* se = m.se + kMaxBatch;   // a, l, c
  const int64_t* stt = m.st + kMaxBatch;  // a, u, A
  const int64_t* ss = m.ss + kMaxBatch;   // u, l, d, r
  const int64_t* sb = m.sb + kMaxBatch;   // c, d, C
  const V zero = cx_zero<V>();

  for (int i = tid; i < nu * nl * nd * nr; i += kThreads) {
    const int r = i % nr, q = i / nr, d = q % nd, q2 = q / nd;
    const int l = q2 % nl, u = q2 / nl;
    S[i] = st[u * ss[0] + l * ss[1] + d * ss[2] + r * ss[3]];
  }
  for (int i = tid; i < na * nu * ta; i += kThreads) {
    const int a_ = i % ta, q = i / ta, u = q % nu, a = q / nu;
    Tt[i] = A0 + a_ < m.nA ? tp[a * stt[0] + u * stt[1] + (A0 + a_) * stt[2]]
                           : zero;
  }
  const int n_out = ta * nr * nC;
  V acc[kCxOut];
#pragma unroll
  for (int k = 0; k < kCxOut; ++k) acc[k] = zero;

  for (int c0 = 0; c0 < m.nc; c0 += kc) {
    const int cv = m.nc - c0;
    __syncthreads();   // the previous chunk's E, B and X2 are consumed
    for (int i = tid; i < na * nl * kc; i += kThreads) {
      const int c = i % kc, q = i / kc, l = q % nl, a = q / nl;
      E[i] = c < cv ? e[a * se[0] + l * se[1] + (c0 + c) * se[2]] : zero;
    }
    for (int i = tid; i < kc * nd * nC; i += kThreads) {
      const int C = i % nC, q = i / nC, d = q % nd, c = q / nd;
      B[i] = c < cv ? b[(c0 + c) * sb[0] + d * sb[1] + C * sb[2]] : zero;
    }
    __syncthreads();
    for (int i = tid; i < nu * nl * kc * ta; i += kThreads) {   // step 1
      const int a_ = i % ta, q = i / ta, c = q % kc, q2 = q / kc;
      const int l = q2 % nl, u = q2 / nl;
      const V* pe = E + l * kc + c;
      const V* pt = Tt + u * ta + a_;
      V s = zero;
      for (int a = 0; a < na; ++a)
        s = cx_fma(pe[a * nl * kc], pt[a * nu * ta], s);
      X1[i] = s;
    }
    __syncthreads();
    for (int i = tid; i < kc * nd * nr * ta; i += kThreads) {   // step 2
      const int a_ = i % ta, q = i / ta, r = q % nr, q2 = q / nr;
      const int d = q2 % nd, c = q2 / nd;
      const V* px = X1 + c * ta + a_;
      const V* ps = S + d * nr + r;
      V s = zero;
      for (int ul = 0; ul < nu * nl; ++ul)
        s = cx_fma(px[ul * kc * ta], ps[ul * nd * nr], s);
      X2[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCxOut; ++k) {                          // step 3
      const int o = tid + k * kThreads;
      if (o < n_out) {
        const int C = o % nC, q = o / nC, r = q % nr, a_ = q / nr;
        const V* px = X2 + r * ta + a_;
        const V* pb = B + C;
        V s = acc[k];
        for (int cd = 0; cd < kc * nd; ++cd)
          s = cx_fma(px[cd * nr * ta], pb[cd * nC], s);
        acc[k] = s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCxOut; ++k) {   // out[item, A0 + A', r, C]
    const int o = tid + k * kThreads;
    if (o < n_out) {
      const int C = o % nC, q = o / nC, r = q % nr, a_ = q / nr;
      if (A0 + a_ < m.nA)
        out[((item * m.nA + A0 + a_) * nr + r) * nC + C] = acc[k];
    }
  }
}

// meta: the real layout (kMetaLen values), then the plan: ta, kc and the
// shared bytes the Python plan computed for them.
template <typename R>
int launch_cx(const void* env, const void* top, const void* site,
              const void* bot, void* out, const int64_t* meta,
              cudaStream_t stream) {
  using V = typename CxOf<R>::type;
  const Meta m = unpack(meta);
  if (batch_items(m) == 0 || m.nA == 0 || m.nr == 0 || m.nC == 0)
    return static_cast<int>(cudaSuccess);
  CxPlan p;
  const int64_t* plan = meta + kMetaLen;
  if (plan[0] < 1 || plan[1] < 1 || plan[0] > m.nA || plan[1] > m.nc ||
      !cx_layout(m, static_cast<int>(plan[0]), static_cast<int>(plan[1]),
                 sizeof(V), p) ||
      p.smem != plan[2])
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = batch_items(m) * cdiv(m.nA, p.ta);
  if (ctas >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(col_transfer_cx_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  col_transfer_cx_kernel<V><<<static_cast<unsigned>(ctas), kThreads,
                              static_cast<size_t>(p.smem), stream>>>(
      static_cast<const V*>(env), static_cast<const V*>(top),
      static_cast<const V*>(site), static_cast<const V*>(bot),
      static_cast<V*>(out), m, p);
  return static_cast<int>(cudaGetLastError());
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

// complex64 / complex128 (the complex body; meta as above plus its plan)
int col_transfer_c64(const void* env, const void* top, const void* site,
                     const void* bot, void* out, const int64_t* meta,
                     void* stream) {
  return launch_cx<float>(env, top, site, bot, out, meta,
                          static_cast<cudaStream_t>(stream));
}

int col_transfer_c128(const void* env, const void* top, const void* site,
                      const void* bot, void* out, const int64_t* meta,
                      void* stream) {
  return launch_cx<double>(env, top, site, bot, out, meta,
                           static_cast<cudaStream_t>(stream));
}

// The plan a call with this meta takes on the current device: plan[0..6] =
// mode (0: one CTA per item, 1: one CTA per A tile), A tile, c chunk, CTAs,
// shared bytes, SMs, and the item count from which mode 0 is taken.
int col_transfer_plan(const int64_t* meta, int elem_bytes, int64_t* plan) {
  const Meta m = unpack(meta);
  int dev = 0, sms = 0;
  const cudaError_t err = current_device(dev, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  const bool ok = elem_bytes == 8 ? make_plan<double>(m, sms, p)
                                  : make_plan<float>(m, sms, p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.mode;
  plan[1] = p.ta;
  plan[2] = p.kc;
  plan[3] = p.ctas;
  plan[4] = static_cast<int64_t>(p.smem);
  plan[5] = sms;
  plan[6] = item_cta_threshold(sms);
  return 0;
}

const char* peps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
