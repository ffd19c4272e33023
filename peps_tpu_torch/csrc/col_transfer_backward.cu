// K1's backward: every gradient of the BTen column transfer that autograd
// asks for, in one launch, hand-written for Hopper (sm_90a).
//
// Replaces: jax.grad of log|psi| through peps_tpu/fermion/vmc.py:301-306
// (bmps.amplitude), where every transfer is
// peps_tpu/contraction/bmps.py:250 _col_transfer_left (or :257, the right
// form, which reaches this kernel on permuted views). The forward is
//
//   out[A, r, C] = sum env[a, l, c] top[a, u, A] site[u, l, d, r] bot[c, d, C]
//
// and, with G = conj(g) for the incoming gradient g, each gradient is the
// conjugate of one product of a chain that shares its intermediates:
//   X[(c,d),(A,r)] = sum_C      bot[c,d,C] G[A,r,C]          (env, top, site)
//   P[(l,c),(u,A)] = sum_a      env[a,l,c] top[a,u,A]        (site, bot)
//   R[(l,c),(u,A)] = sum_(d,r)  site[u,l,d,r] X[c,d,A,r]     (env, top)
//   F[(c,d),(A,r)] = sum_(u,l)  site[u,l,d,r] P[l,c,u,A]     (bot)
//   gsite*[u,l,d,r] = sum_(c,A) P[l,c,u,A] X[c,d,A,r]
//   genv*[a,l,c]   = sum_(u,A) top[a,u,A] R[l,c,u,A]
//   gtop*[a,u,A]   = sum_(l,c) env[a,l,c] R[l,c,u,A]
//   gbot*[c,d,C]   = sum_(A,r) F[c,d,A,r] G[A,r,C]
// X is formed once and feeds three gradients, R two. Only the products the
// requested gradients need run. Where env and top are broadcast over the
// same dims of a group (the pair traces' candidates), P = env.top is one
// per run of those dims, R is summed over the run, and the env and top
// gradients read that one R.
//
// What bounds it on the H100: operations. At chi = 32, D = 8 an item costs
// about 17 M multiply-adds for the env, top and site gradients (23 M with
// bot) on ~0.1 MB of operands. f32 and complex64 run on the FP32 CUDA
// cores (no TF32: the sums stay in full f32), f64 and complex128 on the
// DMMA tensor cores (mma.sync.m16n8k8.f64, complex_tiles.cuh).
//
// Design. The batch is split into groups: the batch dims over which some
// requested gradient's operand is broadcast (batch stride 0 or a size-1
// dim) form the group, the rest index the groups. One thread-block cluster
// takes a group at a time (persistent: the clusters walk over the
// groups): 8 CTAs where there are few groups, so that the 8 items of a
// sketch scan still spread over 64 SMs; one CTA where the groups alone
// fill the card. Within the cluster every product is cut into output tiles
// of 4096 values (64 x 64, or 32 x 128 for a product with 32 rows or
// columns: the env and top gradients' a, the bot gradient's C), dealt
// round-robin to the cluster's CTAs, in three phases separated by cluster
// barriers: (1) X and P, (2) R and F, and the site gradient, (3) the env,
// top and bot gradients. The intermediates go to a scratch slot of the
// cluster in global memory (L2-resident at these sizes; stored with
// st.global.cg, read after the barrier, whose acquire makes the peers'
// stores visible). A gradient whose operand is broadcast over the group is
// reduced inside its product: its K loop runs over the items that share
// the output, so no gradient is formed at the full batch. The site
// gradient's K (c, A, and the items of a run) is split across the
// cluster's CTAs; each keeps its partial tile in shared memory, and after
// a cluster barrier CTA r sums its share of the tile over the peers'
// partials through distributed shared memory in rank order:
// deterministic, no atomics. Conjugation is folded into the tile products'
// fragments (a sign on the imaginary part of the operand read from g) and
// into the stores (the gradients). Each tile streams its K in chunks
// staged K-major in shared memory by cp.async, through a ring of 3 or 4
// stages (the next chunks land while one is multiplied); the operands'
// own strides are read through per-tile offset tables, so permuted and
// broadcast views are never copied.
// Tile products by dtype: f32 a 4 x 4 register tile a thread (two 16-byte
// shared loads a k-step, 16 FMAs); complex64 a 4 x 4 complex register tile
// (cfma_tile, 64 FMAs a k-step); f64 and complex128 mma.sync.m16n8k8.f64,
// a warp 32 x 16 of the tile (complex128: four real MMAs a complex tile
// product, zmma). Two CTAs an SM except complex128 (its fragments take
// more than 128 registers a thread).
//
// The launch plan (cluster size, clusters, scratch layout, shared bytes)
// is chosen in Python (kernels/col_transfer_backward.py) and checked here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_tiles.cuh"

namespace ctb {
// internal linkage: a process that loads two builds of this file keeps
// their kernels and the once-set attributes apart
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;
constexpr int kMaxCluster = 8;   // the largest portable cluster
// tensors: the four operands, g, the scratch intermediates, the gradients
enum { kEnv, kTop, kSite, kBot, kG, kX, kP, kR, kF, kGEnv, kGTop, kGSite,
       kGBot, kNumTensors };
// the products, in the order of the formulas above
enum { pX, pP, pR, pF, pSite, pEnv, pTop, pBot, kNumProducts };
// meta layout (int64), written by kernels/col_transfer_backward.py
constexpr int kMetaBatch = 0;                       // 4 batch sizes
constexpr int kMetaStrides = 4;                     // 9 x 4 batch strides
constexpr int kMetaInner = kMetaStrides + 36;       // env 3 top 3 site 4 bot 3 g 3
constexpr int kMetaDims = kMetaInner + 16;          // 8 sizes
constexpr int kMetaNeeds = kMetaDims + 8;           // 4 flags
constexpr int kMetaGroup = kMetaNeeds + 4;          // 4 flags: a group dim
constexpr int kMetaPlan = kMetaGroup + 4;           // the plan: 11 values

// PTX helpers.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// every thread of the cluster arrives (its earlier global and shared
// writes released) and waits (acquiring the others')
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the address of the same shared-memory location in CTA `rank` of the
// cluster (a generic address, read with ordinary loads)
template <typename T>
__device__ __forceinline__ const T* cluster_peer(const T* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}
// cp.async of one element (4, 8 or 16 bytes) into shared memory; with
// `keep` false nothing is read and the destination is zeroed. 4- and
// 8-byte copies take the L1 path (.ca), 16-byte ones go to L2 only (.cg).
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool keep) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = keep ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n groups of this thread's copies are pending
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// End of PTX helpers.

// i -> (i / n2) s1 + (i % n2) s2: a flattened pair of indices
struct Comp {
  int32_t n2;
  int64_t s1, s2;
};

__host__ __device__ __forceinline__ int64_t coff(const Comp& c, int i) {
  const int q = i / c.n2;
  return q * c.s1 + static_cast<int64_t>(i - q * c.n2) * c.s2;
}

// one operand of a product, read as op[row][k]
struct Opnd {
  Comp row, k;
  int32_t src;     // a tensor id (kEnv..kF)
  int32_t conj;    // conjugate on load
  int32_t rows_fast;  // unit stride along rows (else threads run along k)
};

// C[m][n] = sum_k A[m][k] B[n][k], written to out[om(m) + on(n)]
struct Product {
  Opnd a, b;
  Comp om, on;
  int32_t M, N, K, out, conj_out;
  int32_t tm;      // the output tile's rows: 64 (64 x 64) or 32 (32 x 128)
};

struct Meta {
  int64_t size[kMaxBatch];
  int64_t bstride[kNumTensors][kMaxBatch];   // 0 for the scratch ids
  int32_t group[kMaxBatch];                  // 1: a group dim
  int32_t needs[4];
  int32_t cs, nclusters, G;
  int32_t share;   // env and top broadcast over the same group dims: P and
                   // R are one per run of those dims (R summed over it)
  int64_t ngroups, item_sz, soff[4];         // scratch per item; X, P, R, F
  int32_t kmax;                              // the largest K of a product
  Product prod[kNumProducts];
};

template <typename T> struct Tr;
// K chunk, the padding of a staged chunk's rows (elements) and the stages
// of the cp.async ring: f32 float4 loads (rows a multiple of 4); f64
// fragment loads of a half-warp on 16 distinct banks (rows 4 mod 16
// doubles); complex128 16-byte fragment loads of a quarter-warp on 8 bank
// groups (rows 2 mod 8 elements, complex_tiles.cuh). A tile is TM x TN =
// 4096 values, TM 64 or 32. MINB: the CTAs an SM the registers must allow
// (two where the tiles fit in 128 registers a thread; complex128's
// fragments do not).
template <> struct Tr<float> {
  static constexpr int BK = 16, PAD = 4, NST = 4, MINB = 2;
  static constexpr bool cx = false;
};
template <> struct Tr<double> {
  static constexpr int BK = 16, PAD = 4, NST = 3, MINB = 2;
  static constexpr bool cx = false;
};
template <> struct Tr<float2> {
  static constexpr int BK = 16, PAD = 4, NST = 3, MINB = 2;
  static constexpr bool cx = true;
};
template <> struct Tr<double2> {
  static constexpr int BK = 8, PAD = 2, NST = 4, MINB = 1;
  static constexpr bool cx = true;
};
constexpr int kTileValues = 4096;
constexpr int kMaxTN = 128;
// shared elements of one stage: A (BK x (64 + PAD)), B (BK x (128 + PAD));
// the ring, which the site gradient's partial tile (4096 values) reuses
template <typename T>
__host__ __device__ constexpr int stage_len() {
  return Tr<T>::BK * (64 + Tr<T>::PAD) + Tr<T>::BK * (kMaxTN + Tr<T>::PAD);
}
template <typename T>
__host__ __device__ constexpr int ring_len() {
  return Tr<T>::NST * stage_len<T>() > kTileValues
             ? Tr<T>::NST * stage_len<T>()
             : kTileValues;
}
// group items whose operand offsets a CTA keeps in shared memory
constexpr int kMaxTabItems = 32;

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ float2 zero_of<float2>() {
  return make_float2(0.f, 0.f);
}
template <> __device__ __forceinline__ double2 zero_of<double2>() {
  return make_double2(0.0, 0.0);
}
__device__ __forceinline__ float conj_if(float v, bool) { return v; }
__device__ __forceinline__ double conj_if(double v, bool) { return v; }
__device__ __forceinline__ float2 conj_if(float2 v, bool c) {
  return c ? make_float2(v.x, -v.y) : v;
}
__device__ __forceinline__ double2 conj_if(double2 v, bool c) {
  return c ? make_double2(v.x, -v.y) : v;
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float cadd(float a, float b) { return a + b; }
__device__ __forceinline__ double cadd(double a, double b) { return a + b; }

// ----------------------------------------------------------- tile products

// The accumulators of one TM x TN output tile, and the product of one
// staged K chunk (A and B K-major: As[k][m], Bs[k][n], leading dims
// TM + PAD and TN + PAD).
template <typename T, int TM> struct Acc;

// f32 and complex64: a 4 x 4 register tile a thread, the threads on a
// (TM / 4) x (TN / 4) grid, consecutive threads along n.
template <int TM> struct Acc<float, TM> {
  static constexpr int TN = kTileValues / TM, LA = TM + 4, LB = TN + 4;
  float v[4][4];
  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
  }
  __device__ static int m0() { return (threadIdx.x / (TN / 4)) * 4; }
  __device__ static int n0() { return (threadIdx.x % (TN / 4)) * 4; }
  __device__ void chunk(const float* As, const float* Bs, float, float) {
    const float* x = As + m0();
    const float* y = Bs + n0();
#pragma unroll 8
    for (int k = 0; k < Tr<float>::BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(x + k * LA);
      const float4 b = *reinterpret_cast<const float4*>(y + k * LB);
      const float xa[4] = {a.x, a.y, a.z, a.w}, yb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(xa[i], yb[j], v[i][j]);
    }
  }
  // f(tile row, tile column, value) for every value this thread holds
  template <typename Fn> __device__ void each(Fn&& f) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(m0() + i, n0() + j, v[i][j]);
  }
};

template <int TM> struct Acc<float2, TM> {
  static constexpr int TN = kTileValues / TM, LA = TM + 4, LB = TN + 4;
  float2 v[4][4];
  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = make_float2(0.f, 0.f);
  }
  __device__ static int m0() { return (threadIdx.x / (TN / 4)) * 4; }
  __device__ static int n0() { return (threadIdx.x % (TN / 4)) * 4; }
  // sa, sb: +1, or -1 to conjugate that operand's staged values
  __device__ void chunk(const float2* As, const float2* Bs, float sa,
                        float sb) {
    const float2* x = As + m0();
    const float2* y = Bs + n0();
#pragma unroll 4
    for (int k = 0; k < Tr<float2>::BK; ++k) {
      float2 xa[4], yb[4];
      cx_tiles::load_cx4(xa, x + k * LA);
      cx_tiles::load_cx4(yb, y + k * LB);
      if (sa != 1.f || sb != 1.f) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xa[i].y *= sa;
          yb[i].y *= sb;
        }
      }
      cx_tiles::cfma_tile(v, xa, yb);
    }
  }
  template <typename Fn> __device__ void each(Fn&& f) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(m0() + i, n0() + j, v[i][j]);
  }
};

// f64 and complex128: warp w holds a 32 x 16 block of the tile as 2 x 2
// MMA tiles of 16 x 8: rows 32 (w % (TM / 32)), columns 16 (w / (TM / 32)).
template <int TM>
__device__ __forceinline__ int mma_row(int i, int v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return 32 * (warp % (TM / 32)) + 16 * i + (lane >> 2) + 8 * (v >> 1);
}
template <int TM>
__device__ __forceinline__ int mma_col(int j, int v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return 16 * (warp / (TM / 32)) + 8 * j + 2 * (lane & 3) + (v & 1);
}

template <int TM> struct Acc<double, TM> {
  static constexpr int TN = kTileValues / TM, LA = TM + 4, LB = TN + 4;
  double v[2][2][4];
  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][e] = 0.0;
  }
  __device__ void chunk(const double* As, const double* Bs, double,
                        double) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const double* x = As + q * LA + 32 * (warp % (TM / 32)) + g;
    const double* y = Bs + q * LB + 16 * (warp / (TM / 32)) + g;
#pragma unroll
    for (int k0 = 0; k0 < Tr<double>::BK; k0 += 8) {
      double a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = x[k0 * LA + 16 * i];
        a[i][1] = x[k0 * LA + 16 * i + 8];
        a[i][2] = x[(k0 + 4) * LA + 16 * i];
        a[i][3] = x[(k0 + 4) * LA + 16 * i + 8];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b[j][0] = y[k0 * LB + 8 * j];
        b[j][1] = y[(k0 + 4) * LB + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) cx_tiles::dmma16(v[i][j], a[i], b[j]);
    }
  }
  template <typename Fn> __device__ void each(Fn&& f) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(mma_row<TM>(i, e), mma_col<TM>(j, e), v[i][j][e]);
  }
};

template <int TM> struct Acc<double2, TM> {
  static constexpr int TN = kTileValues / TM, LA = TM + 2, LB = TN + 2;
  double v[2][2][2][4];
  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][0][e] = v[i][j][1][e] = 0.0;
  }
  __device__ void chunk(const double2* As, const double2* Bs, double sa,
                        double sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    double2 a[2][4], b[2][2];
    cx_tiles::zmma_frags<2, 2>(a, b,
                               As + q * LA + 32 * (warp % (TM / 32)) + g, LA,
                               Bs + q * LB + 16 * (warp / (TM / 32)) + g, LB);
    if (sa != 1.0 || sb != 1.0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[i][e].y *= sa;
#pragma unroll
        for (int e = 0; e < 2; ++e) b[i][e].y *= sb;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) cx_tiles::zmma(v[i][j], a[i], b[j]);
  }
  template <typename Fn> __device__ void each(Fn&& f) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(mma_row<TM>(i, e), mma_col<TM>(j, e),
            make_double2(v[i][j][0][e], v[i][j][1][e]));
  }
};

// ------------------------------------------------------------ the kernel

template <typename T> struct Smem {
  T* buf;        // the ring of NST stages of (A chunk, B chunk)
  T* red;        // the site gradient's partial tile, over the ring
  int* tab;      // the tile's A rows, B rows, output rows and columns
  int* ka;       // the segment's k offsets of A and B (kmax each)
  int* kb;
  int64_t* items;  // the group's items' offsets in env, top, site, bot, g
};
constexpr int kTabA = 0, kTabB = 64, kTabOR = 64 + kMaxTN,
              kTabOC = 128 + kMaxTN, kTabLen = 128 + 2 * kMaxTN;

// An item's coordinates: the group `grp` over the outer dims, the group
// item `gi` over the group dims (the last dim fastest).
__device__ __forceinline__ void item_coords(const Meta& m, int64_t grp,
                                            int gi, int64_t (&idx)[kMaxBatch]) {
  for (int d = kMaxBatch - 1; d >= 0; --d) {
    if (m.group[d]) {
      idx[d] = gi % m.size[d];
      gi = static_cast<int>(gi / m.size[d]);
    } else {
      idx[d] = grp % m.size[d];
      grp /= m.size[d];
    }
  }
}

__device__ __forceinline__ int64_t tensor_off(const Meta& m, int t,
                                              const int64_t (&idx)[kMaxBatch]) {
  int64_t o = 0;
#pragma unroll
  for (int d = 0; d < kMaxBatch; ++d) o += idx[d] * m.bstride[t][d];
  return o;
}

// Item j of run r of gradient `gt` (a gradient tensor id): its run dims
// (group dims the gradient is not broadcast over) index r, its in-run dims
// (those it is broadcast over) index j. Returns the group item index.
__device__ __forceinline__ int run_item(const Meta& m, int gt, int r, int j) {
  int64_t idx[kMaxBatch];
  for (int d = kMaxBatch - 1; d >= 0; --d) {
    idx[d] = 0;
    if (!m.group[d]) continue;
    if (m.bstride[gt][d] != 0) {
      idx[d] = r % m.size[d];
      r = static_cast<int>(r / m.size[d]);
    } else {
      idx[d] = j % m.size[d];
      j = static_cast<int>(j / m.size[d]);
    }
  }
  int gi = 0;
  for (int d = 0; d < kMaxBatch; ++d)
    if (m.group[d]) gi = gi * static_cast<int>(m.size[d]) + static_cast<int>(idx[d]);
  return gi;
}

__device__ __forceinline__ int run_length(const Meta& m, int gt) {
  int n = 1;
  for (int d = 0; d < kMaxBatch; ++d)
    if (m.group[d] && m.bstride[gt][d] == 0) n *= static_cast<int>(m.size[d]);
  return n;
}

// The first item of gi's run of tensor t (gi's coordinates with the group
// dims over which t is broadcast set to 0).
__device__ __forceinline__ int run_first(const Meta& m, int t, int gi) {
  int out = 0, stride = 1;
  for (int d = kMaxBatch - 1; d >= 0; --d) {
    if (!m.group[d]) continue;
    const int n = static_cast<int>(m.size[d]);
    const int i = gi % n;
    gi /= n;
    if (m.bstride[t][d] != 0) out += i * stride;
    stride *= n;
  }
  return out;
}

template <typename T> struct Ptrs {
  const T* in[5];   // env, top, site, bot, g
  T* grad[4];       // genv, gtop, gsite, gbot (null where not requested)
  T* scratch;
};

// The base address of tensor t at group item gi (scratch: the slot's item;
// an input of the group's first kMaxTabItems items: the shared table).
template <typename T>
__device__ __forceinline__ const T* base_of(const Meta& m, const Ptrs<T>& p,
                                            T* slot, int64_t grp, int gi,
                                            int t, const int64_t* sm_items) {
  if (t >= kX && t <= kF) {
    if (m.share && (t == kP || t == kR)) gi = run_first(m, kEnv, gi);
    return slot + gi * m.item_sz + m.soff[t - kX];
  }
  if (gi < kMaxTabItems) return p.in[t] + sm_items[gi * 5 + t];
  int64_t idx[kMaxBatch];
  item_coords(m, grp, gi, idx);
  return p.in[t] + tensor_off(m, t, idx);
}

// The tile's offset tables: rows m0.. of A, n0.. of B (-1 past M or N), and
// the output's row and column offsets.
__device__ __forceinline__ void fill_tables(const Product& pr, int m0, int n0,
                                            int* tab) {
  const int tm = pr.tm, tn = kTileValues / pr.tm;
  for (int i = threadIdx.x; i < tm + tn; i += kThreads) {
    if (i < tm) {
      const int m = m0 + i;
      tab[kTabA + i] = m < pr.M ? static_cast<int>(coff(pr.a.row, m)) : -1;
      tab[kTabOR + i] = m < pr.M ? static_cast<int>(coff(pr.om, m)) : 0;
    } else {
      const int n = n0 + i - tm;
      tab[kTabB + i - tm] = n < pr.N ? static_cast<int>(coff(pr.b.row, n)) : -1;
      tab[kTabOC + i - tm] = n < pr.N ? static_cast<int>(coff(pr.on, n)) : 0;
    }
  }
}

// The k offsets of both operands for k in [k_lo, k_hi), from ka and kb.
__device__ __forceinline__ void fill_k(const Product& pr, int k_lo, int k_hi,
                                       int* ka, int* kb) {
  for (int k = k_lo + threadIdx.x; k < k_hi; k += kThreads) {
    ka[k - k_lo] = static_cast<int>(coff(pr.a.k, k));
    kb[k - k_lo] = static_cast<int>(coff(pr.b.k, k));
  }
}

// How a thread copies one operand's BK x W chunk into a stage: element e
// = tid + i kThreads, consecutive threads along the operand's unit
// stride; a value past K or past the tile's rows is zero.
template <typename T, int W>
__device__ __forceinline__ void copy_chunk(T* dst, const T* base,
                                           const int* rows, const int* ks,
                                           bool fast, int kc, int nk) {
  constexpr int BK = Tr<T>::BK, LD = W + Tr<T>::PAD;
  constexpr int E = BK * W / kThreads;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int rr = fast ? e % W : e / BK;
    const int kk = fast ? e / W : e % BK;
    const int ro = rows[rr];
    const bool keep = kc + kk < nk && ro >= 0;
    const T* src = keep ? base + ro + ks[kc + kk] : base;
    cp_async_elem<sizeof(T)>(dst + kk * LD + rr, src, keep);
  }
}

// acc += the tile's product over the nk values of k whose offsets the
// segment tables hold, of one item's operands (bases pa, pb): the chunks
// stream through a ring of NST stages, NST - 1 chunks in flight while one
// is multiplied.
template <typename T, int TM>
__device__ void accumulate(Acc<T, TM>& acc, const Product& pr, const T* pa,
                           const T* pb, int nk, const Smem<T>& sm) {
  constexpr int BK = Tr<T>::BK, NST = Tr<T>::NST;
  constexpr int TN = kTileValues / TM, LA = TM + Tr<T>::PAD;
  if (nk <= 0) return;
  const int* ra = sm.tab + kTabA;
  const int* rb = sm.tab + kTabB;
  const bool fa = pr.a.rows_fast != 0, fb = pr.b.rows_fast != 0;
  const auto sa = pr.a.conj ? -1.0 : 1.0, sb = pr.b.conj ? -1.0 : 1.0;
  const int nch = cx_tiles::cdiv(nk, BK);
  auto issue = [&](int c) {
    T* as = sm.buf + (c % NST) * stage_len<T>();
    copy_chunk<T, TM>(as, pa, ra, sm.ka, fa, c * BK, nk);
    copy_chunk<T, TN>(as + BK * LA, pb, rb, sm.kb, fb, c * BK, nk);
  };
#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is free
    if (c + NST - 1 < nch) issue(c + NST - 1);
    cp_async_commit();
    const T* as = sm.buf + (c % NST) * stage_len<T>();
    acc.chunk(as, as + BK * LA, sa, sb);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the k tables are free for the next call
}

// out[om(m) + on(n)] = acc (conjugated where asked), within M x N.
template <typename T, int TM>
__device__ __forceinline__ void store(const Acc<T, TM>& acc, const Product& pr,
                                      T* out, int m0, int n0, const int* tab) {
  const int* ro = tab + kTabOR;
  const int* co = tab + kTabOC;
  const bool scratch = pr.out >= kX && pr.out <= kF;
  const bool cj = pr.conj_out;
  const int M = pr.M, N = pr.N;
  acc.each([&](int i, int j, T v) {
    if (m0 + i < M && n0 + j < N) {
      T* d = out + ro[i] + co[j];
      v = conj_if(v, cj);
      if (scratch)
        __stcg(d, v);
      else
        *d = v;
    }
  });
}

__device__ __forceinline__ int tiles_of(const Product& pr) {
  return cx_tiles::cdiv(pr.M, pr.tm) *
         cx_tiles::cdiv(pr.N, kTileValues / pr.tm);
}

__device__ __forceinline__ void tile_origin(const Product& pr, int t, int& m0,
                                            int& n0) {
  const int tmc = cx_tiles::cdiv(pr.M, pr.tm);
  m0 = (t % tmc) * pr.tm;
  n0 = (t / tmc) * (kTileValues / pr.tm);
}

// One output tile over the segments seg = 0..nseg-1 of its K: each an
// item's bases and a k range (segment(seg, pa, pb, lo, hi)); the tile's
// value goes to out (or, with out null, to the partial buffer red).
template <typename T, int TM, typename Seg>
__device__ void tile(const Product& pr, int m0, int n0, int nseg, Seg segment,
                     T* out, const Smem<T>& sm) {
  fill_tables(pr, m0, n0, sm.tab);
  Acc<T, TM> acc;
  acc.clear();
  for (int s = 0; s < nseg; ++s) {
    const T *pa, *pb;
    int lo, hi;
    segment(s, pa, pb, lo, hi);
    if (hi <= lo) continue;
    fill_k(pr, lo, hi, sm.ka, sm.kb);
    __syncthreads();
    accumulate<T, TM>(acc, pr, pa, pb, hi - lo, sm);
  }
  if (out != nullptr) {
    store<T, TM>(acc, pr, out, m0, n0, sm.tab);
  } else {
    constexpr int TN = kTileValues / TM;
    acc.each([&](int i, int j, T v) { sm.red[i * TN + j] = v; });
  }
  __syncthreads();   // the tables are rewritten by the next tile
}

template <typename T, typename Seg>
__device__ __forceinline__ void tile_any(const Product& pr, int m0, int n0,
                                         int nseg, Seg segment, T* out,
                                         const Smem<T>& sm) {
  if (pr.tm == 32)
    tile<T, 32>(pr, m0, n0, nseg, segment, out, sm);
  else
    tile<T, 64>(pr, m0, n0, nseg, segment, out, sm);
}

// The intermediates X, P, R or F of every item of the group: tiles dealt
// round-robin over the cluster, continuing the deal counter `job`.
// With m.share, P and R are one per run of env's broadcast dims, at the
// run's first item: P from it, R summed over the run's items.
template <typename T>
__device__ void intermediate(const Meta& m, const Ptrs<T>& p, T* slot,
                             int64_t grp, int which, int& job, unsigned rank,
                             const Smem<T>& sm) {
  const Product& pr = m.prod[which];
  const int nt = tiles_of(pr);
  const bool per_run = m.share && (which == pP || which == pR);
  const int len = per_run ? run_length(m, kEnv) : 1;
  const int outs = m.G / len;
  const int nseg = which == pR ? len : 1;
  for (int o = 0; o < outs; ++o)
    for (int t = 0; t < nt; ++t, ++job) {
      if (job % m.cs != static_cast<int>(rank)) continue;
      int m0, n0;
      tile_origin(pr, t, m0, n0);
      const int gi0 = per_run ? run_item(m, kEnv, o, 0) : o;
      const int K = pr.K;
      tile_any<T>(pr, m0, n0, nseg,
                  [&](int j, const T*& a, const T*& b, int& lo, int& hi) {
                    const int gi = per_run ? run_item(m, kEnv, o, j) : gi0;
                    a = base_of(m, p, slot, grp, gi, pr.a.src, sm.items);
                    b = base_of(m, p, slot, grp, gi, pr.b.src, sm.items);
                    lo = 0;
                    hi = K;
                  },
                  slot + gi0 * m.item_sz + m.soff[pr.out - kX], sm);
    }
}

// A gradient whose K runs over the items of each run (env, top, bot).
template <typename T>
__device__ void gradient(const Meta& m, const Ptrs<T>& p, T* slot,
                         int64_t grp, int which, int gt, int& job,
                         unsigned rank, const Smem<T>& sm) {
  const Product& pr = m.prod[which];
  const int nt = tiles_of(pr);
  const int len = run_length(m, gt), runs = m.G / len;
  // the env and top gradients of a shared run: its R is already the sum
  const int nseg = m.share && which != pBot ? 1 : len;
  for (int r = 0; r < runs; ++r)
    for (int t = 0; t < nt; ++t, ++job) {
      if (job % m.cs != static_cast<int>(rank)) continue;
      int m0, n0;
      tile_origin(pr, t, m0, n0);
      int64_t idx[kMaxBatch];
      item_coords(m, grp, run_item(m, gt, r, 0), idx);
      const int K = pr.K;
      tile_any<T>(pr, m0, n0, nseg,
                  [&](int j, const T*& a, const T*& b, int& lo, int& hi) {
                    const int gi = run_item(m, gt, r, j);
                    a = base_of(m, p, slot, grp, gi, pr.a.src, sm.items);
                    b = base_of(m, p, slot, grp, gi, pr.b.src, sm.items);
                    lo = 0;
                    hi = K;
                  },
                  p.grad[gt - kGEnv] + tensor_off(m, gt, idx), sm);
    }
}

// The site gradient: every CTA of the cluster takes a slice of each tile's
// K (the run's items times c A), keeps its partial in shared memory, and
// after a cluster barrier CTA r sums its share of the tile over the
// cluster's partials in rank order (distributed shared memory).
template <typename T>
__device__ void site_gradient(const Meta& m, const Ptrs<T>& p, T* slot,
                              int64_t grp, unsigned rank, const Smem<T>& sm) {
  const Product& pr = m.prod[pSite];
  const int nt = tiles_of(pr), tn = kTileValues / pr.tm;
  const int len = run_length(m, kGSite), runs = m.G / len;
  const int K = pr.K, total = len * K, cs = m.cs;
  const int per = cx_tiles::cdiv(cx_tiles::cdiv(total, cs), Tr<T>::BK) *
                  Tr<T>::BK;
  const int lo = static_cast<int>(rank) * per;
  const int hi = min(total, lo + per);
  const int j0 = min(lo / K, len);
  const int nseg = hi > lo ? (hi - 1) / K - j0 + 1 : 0;
  for (int r = 0; r < runs; ++r)
    for (int t = 0; t < nt; ++t) {
      int m0, n0;
      tile_origin(pr, t, m0, n0);
      tile_any<T>(pr, m0, n0, nseg,
                  [&](int s, const T*& a, const T*& b, int& klo, int& khi) {
                    const int j = j0 + s;
                    const int gi = run_item(m, kGSite, r, j);
                    a = base_of(m, p, slot, grp, gi, pr.a.src, sm.items);
                    b = base_of(m, p, slot, grp, gi, pr.b.src, sm.items);
                    klo = max(lo - j * K, 0);
                    khi = min(hi - j * K, K);
                  },
                  static_cast<T*>(nullptr), sm);
      cluster_sync();
      int64_t idx[kMaxBatch];
      item_coords(m, grp, run_item(m, kGSite, r, 0), idx);
      T* out = p.grad[kGSite - kGEnv] + tensor_off(m, kGSite, idx);
      fill_tables(pr, m0, n0, sm.tab);
      __syncthreads();
      const int* ro = sm.tab + kTabOR;
      const int* co = sm.tab + kTabOC;
      for (int e = static_cast<int>(rank) * kThreads + threadIdx.x;
           e < kTileValues; e += cs * kThreads) {
        const int i = e / tn, j = e % tn;
        if (m0 + i >= pr.M || n0 + j >= pr.N) continue;
        T s = zero_of<T>();
        for (int q = 0; q < cs; ++q) s = cadd(s, cluster_peer(sm.red, q)[e]);
        out[ro[i] + co[j]] = conj_if(s, pr.conj_out);
      }
      cluster_sync();   // the partials are read before the next tile
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Tr<T>::MINB)
backward_kernel(const __grid_constant__ Ptrs<T> p,
                const __grid_constant__ Meta m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm;
  sm.buf = reinterpret_cast<T*>(smem_raw);
  sm.red = sm.buf;
  sm.items = reinterpret_cast<int64_t*>(sm.buf + ring_len<T>());
  sm.tab = reinterpret_cast<int*>(sm.items + kMaxTabItems * 5);
  sm.ka = sm.tab + kTabLen;
  sm.kb = sm.ka + m.kmax;
  const unsigned rank = cluster_rank();
  const int64_t cluster = blockIdx.x / m.cs;
  T* slot = p.scratch + cluster * m.G * m.item_sz;
  const bool ne = m.needs[0], nt = m.needs[1], ns = m.needs[2],
             nb = m.needs[3];
  for (int64_t grp = cluster; grp < m.ngroups; grp += m.nclusters) {
    // the inputs' offsets of the group's items (the previous group's are
    // no longer read: the loop ends in a cluster barrier)
    for (int e = threadIdx.x; e < min(m.G, kMaxTabItems) * 5; e += kThreads) {
      int64_t idx[kMaxBatch];
      item_coords(m, grp, e / 5, idx);
      sm.items[e] = tensor_off(m, e % 5, idx);
    }
    __syncthreads();
    int job = 0;
    if (ne || nt || ns) intermediate(m, p, slot, grp, pX, job, rank, sm);
    if (ns || nb) intermediate(m, p, slot, grp, pP, job, rank, sm);
    __threadfence();
    cluster_sync();
    if (ne || nt) intermediate(m, p, slot, grp, pR, job, rank, sm);
    if (nb) intermediate(m, p, slot, grp, pF, job, rank, sm);
    if (ns) site_gradient(m, p, slot, grp, rank, sm);
    __threadfence();
    cluster_sync();
    if (ne) gradient(m, p, slot, grp, pEnv, kGEnv, job, rank, sm);
    if (nt) gradient(m, p, slot, grp, pTop, kGTop, job, rank, sm);
    if (nb) gradient(m, p, slot, grp, pBot, kGBot, job, rank, sm);
    cluster_sync();   // the slot is rewritten by the next group
  }
}

// ------------------------------------------------------------ host side

inline Comp C1(int64_t s) { return Comp{1, s, 0}; }
inline Comp C2(int64_t n2, int64_t s1, int64_t s2) {
  return Comp{static_cast<int32_t>(n2), s1, s2};
}
inline Opnd op(Comp row, Comp k, int src, int conj) {
  const bool fast = row.n2 > 1 ? row.s2 == 1 : row.s1 == 1;
  return Opnd{row, k, src, conj, fast ? 1 : 0};
}

// shared bytes a CTA takes: the ring (the partial tile over it), the
// items' offsets, the tile's offset tables and the k tables of both
// operands (kmax each)
template <typename T>
size_t smem_bytes(int64_t kmax) {
  return ring_len<T>() * sizeof(T) + kMaxTabItems * 5 * sizeof(int64_t) +
         (kTabLen + 2 * kmax) * sizeof(int);
}

// C^T through the swapped operands: a product with N <= 32 < M takes the
// 32 x 128 tile on its transpose
inline void shape_tile(Product& p) {
  if (p.N <= 32 && p.M > 32) {
    const Opnd a = p.a;
    p.a = p.b;
    p.b = a;
    const Comp om = p.om;
    p.om = p.on;
    p.on = om;
    const int32_t M = p.M;
    p.M = p.N;
    p.N = M;
  }
  p.tm = p.M <= 32 ? 32 : 64;
}

template <typename T>
int launch(const T* const* in, T* const* grad, T* scratch,
           const int64_t* meta, cudaStream_t stream) {
  Meta m{};
  for (int d = 0; d < kMaxBatch; ++d) {
    m.size[d] = meta[kMetaBatch + d];
    m.group[d] = static_cast<int32_t>(meta[kMetaGroup + d]);
  }
  const int ids[9] = {kEnv, kTop, kSite, kBot, kG, kGEnv, kGTop, kGSite,
                      kGBot};
  for (int t = 0; t < 9; ++t)
    for (int d = 0; d < kMaxBatch; ++d)
      m.bstride[ids[t]][d] = meta[kMetaStrides + 4 * t + d];
  const int64_t* s = meta + kMetaInner;
  const int64_t se[3] = {s[0], s[1], s[2]}, st[3] = {s[3], s[4], s[5]};
  const int64_t ss[4] = {s[6], s[7], s[8], s[9]};
  const int64_t sb[3] = {s[10], s[11], s[12]}, sg[3] = {s[13], s[14], s[15]};
  const int64_t* dm = meta + kMetaDims;
  const int64_t na = dm[0], nl = dm[1], nc = dm[2], nu = dm[3], nA = dm[4],
                nd = dm[5], nr = dm[6], nC = dm[7];
  for (int i = 0; i < 4; ++i)
    m.needs[i] = static_cast<int32_t>(meta[kMetaNeeds + i]);
  const int64_t* pl = meta + kMetaPlan;
  m.cs = static_cast<int32_t>(pl[0]);
  m.nclusters = static_cast<int32_t>(pl[1]);
  m.G = static_cast<int32_t>(pl[2]);
  m.ngroups = pl[3];
  m.item_sz = pl[4];
  for (int i = 0; i < 4; ++i) m.soff[i] = pl[5 + i];
  const int64_t smem = pl[9];
  m.share = static_cast<int32_t>(pl[10]);
  for (int i = 0; i < 8; ++i)
    if (dm[i] < 1 || dm[i] > (1 << 20)) return cudaErrorInvalidValue;
  const int cj = Tr<T>::cx ? 1 : 0;
  // the products (see the formulas at the top); scratch layouts
  // X [(c,d),(A,r)], P and R [(l,c),(u,A)], F [(c,d),(A,r)]
  const int64_t ar = nA * nr, ua = nu * nA, lcua = nc * nu * nA;
  const int64_t cdar = nd * nA * nr;
  Product* pr = m.prod;
  pr[pX] = Product{op(C2(nd, sb[0], sb[1]), C1(sb[2]), kBot, 0),
                   op(C2(nr, sg[0], sg[1]), C1(sg[2]), kG, cj),
                   C1(ar), C1(1), static_cast<int32_t>(nc * nd),
                   static_cast<int32_t>(ar), static_cast<int32_t>(nC), kX, 0};
  pr[pP] = Product{op(C2(nc, se[1], se[2]), C1(se[0]), kEnv, 0),
                   op(C2(nA, st[1], st[2]), C1(st[0]), kTop, 0),
                   C1(ua), C1(1), static_cast<int32_t>(nl * nc),
                   static_cast<int32_t>(ua), static_cast<int32_t>(na), kP, 0};
  pr[pR] = Product{op(C2(nl, ss[0], ss[1]), C2(nr, ss[2], ss[3]), kSite, 0),
                   op(C2(nA, cdar, nr), C2(nr, ar, 1), kX, 0),
                   C2(nl, nA, lcua), C2(nA, ua, 1),
                   static_cast<int32_t>(nu * nl), static_cast<int32_t>(nc * nA),
                   static_cast<int32_t>(nd * nr), kR, 0};
  pr[pF] = Product{op(C2(nr, ss[2], ss[3]), C2(nl, ss[0], ss[1]), kSite, 0),
                   op(C2(nA, ua, 1), C2(nl, nA, lcua), kP, 0),
                   C2(nr, ar, 1), C2(nA, cdar, nr),
                   static_cast<int32_t>(nd * nr), static_cast<int32_t>(nc * nA),
                   static_cast<int32_t>(nu * nl), kF, 0};
  // the gradients, contiguous in their operands' own shapes
  pr[pSite] = Product{op(C2(nl, nA, lcua), C2(nA, ua, 1), kP, 0),
                      op(C2(nr, ar, 1), C2(nA, cdar, nr), kX, 0),
                      C2(nl, nl * nd * nr, nd * nr), C2(nr, nr, 1),
                      static_cast<int32_t>(nu * nl),
                      static_cast<int32_t>(nd * nr),
                      static_cast<int32_t>(nc * nA), kGSite, cj};
  pr[pEnv] = Product{op(C1(st[0]), C2(nA, st[1], st[2]), kTop, 0),
                     op(C2(nc, lcua, ua), C2(nA, nA, 1), kR, 0),
                     C1(nl * nc), C2(nc, nc, 1), static_cast<int32_t>(na),
                     static_cast<int32_t>(nl * nc),
                     static_cast<int32_t>(nu * nA), kGEnv, cj};
  pr[pTop] = Product{op(C1(se[0]), C2(nc, se[1], se[2]), kEnv, 0),
                     op(C2(nA, nA, 1), C2(nc, lcua, ua), kR, 0),
                     C1(nu * nA), C2(nA, nA, 1), static_cast<int32_t>(na),
                     static_cast<int32_t>(nu * nA),
                     static_cast<int32_t>(nl * nc), kGTop, cj};
  pr[pBot] = Product{op(C2(nd, cdar, ar), C2(nr, nr, 1), kF, 0),
                     op(C1(sg[2]), C2(nr, sg[0], sg[1]), kG, cj),
                     C2(nd, nd * nC, nC), C1(1),
                     static_cast<int32_t>(nc * nd), static_cast<int32_t>(nC),
                     static_cast<int32_t>(nA * nr), kGBot, cj};
  int64_t kmax = 0;
  for (int i = 0; i < kNumProducts; ++i) {
    shape_tile(pr[i]);
    kmax = pr[i].K > kmax ? pr[i].K : kmax;
  }
  m.kmax = static_cast<int32_t>(kmax);
  if (m.cs < 1 || m.cs > kMaxCluster || m.nclusters < 1 || m.G < 1 ||
      m.ngroups < 1 || smem != static_cast<int64_t>(smem_bytes<T>(kmax)))
    return cudaErrorInvalidValue;
  Ptrs<T> p;
  for (int i = 0; i < 5; ++i) p.in[i] = in[i];
  for (int i = 0; i < 4; ++i) p.grad[i] = grad[i];
  p.scratch = scratch;
  for (int i = 0; i < 4; ++i)
    if (m.needs[i] && grad[i] == nullptr) return cudaErrorInvalidValue;
  cudaError_t e;
  // the kernel's attribute, set on its first launch: a CTA may take up to
  // 227 KB of shared memory
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(backward_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m.nclusters * m.cs), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(m.cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, backward_kernel<T>, p, m);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int entry(const void* env, const void* top, const void* site, const void* bot,
          const void* g, void* genv, void* gtop, void* gsite, void* gbot,
          void* scratch, const int64_t* meta, void* stream) {
  const T* in[5] = {static_cast<const T*>(env), static_cast<const T*>(top),
                    static_cast<const T*>(site), static_cast<const T*>(bot),
                    static_cast<const T*>(g)};
  T* grad[4] = {static_cast<T*>(genv), static_cast<T*>(gtop),
                static_cast<T*>(gsite), static_cast<T*>(gbot)};
  return launch<T>(in, grad, static_cast<T*>(scratch), meta,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace ctb

extern "C" {

// One backward of the left transfer: the gradients asked for in meta's
// needs (others may be null), scratch as the plan sizes it; meta as
// kernels/col_transfer_backward.py writes it. Returns a cudaError_t.
#define CTB_ENTRY(name, T)                                                   \
  int name(const void* env, const void* top, const void* site,              \
           const void* bot, const void* g, void* genv, void* gtop,          \
           void* gsite, void* gbot, void* scratch, const int64_t* meta,     \
           void* stream) {                                                   \
    return ctb::entry<T>(env, top, site, bot, g, genv, gtop, gsite, gbot,   \
                         scratch, meta, stream);                             \
  }
CTB_ENTRY(col_transfer_backward_f32, float)
CTB_ENTRY(col_transfer_backward_f64, double)
CTB_ENTRY(col_transfer_backward_c64, float2)
CTB_ENTRY(col_transfer_backward_c128, double2)
#undef CTB_ENTRY

// The shared bytes a CTA of each body (0 f32, 1 f64, 2 complex64, 3
// complex128) takes without its k tables, and the compiled kernel's
// registers and local bytes a thread: out[0..2].
int col_transfer_backward_attributes(int kind, int64_t* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (kind) {
    case 0:
      out[0] = ctb::smem_bytes<float>(0);
      e = cudaFuncGetAttributes(&a, ctb::backward_kernel<float>);
      break;
    case 1:
      out[0] = ctb::smem_bytes<double>(0);
      e = cudaFuncGetAttributes(&a, ctb::backward_kernel<double>);
      break;
    case 2:
      out[0] = ctb::smem_bytes<float2>(0);
      e = cudaFuncGetAttributes(&a, ctb::backward_kernel<float2>);
      break;
    case 3:
      out[0] = ctb::smem_bytes<double2>(0);
      e = cudaFuncGetAttributes(&a, ctb::backward_kernel<double2>);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  out[1] = a.numRegs;
  out[2] = static_cast<int64_t>(a.localSizeBytes);
  return 0;
}

}  // extern "C"
