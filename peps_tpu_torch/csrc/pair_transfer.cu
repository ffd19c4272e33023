// K3: the two-row (BTen2) column transfer, hand-written for Hopper (sm_90a).
//
// Replaces: peps_tpu/algorithm/energy.py:_pair_row_envs (lines 132-179: the
// left and right BTen2 scans, bmps._col_transfer_left/_right on the
// column-fused site of _fuse_pair_columns), the diagonal and anti-diagonal
// lblk/rblk chains of _pair_pass (lines 231-253) and its three sqrt5 chains
// (lines 264-279). Each is one transfer of the form
//
//   out[n, A, r, f, C] = sum_{a,m,n',c,u,d,e} env[n,a,m,n',c] top[n,a,u,A]
//                          row1[n,u,m,d,r] row2[n,d,n',e,f] bot[n,c,e,C]
//
// with n the batch item. The right-hand form is this one on permuted views
// (top a<->A, row1 m<->r, row2 n'<->f, bot c<->C), so every operand comes
// with its own strides; a batch stride of 0 shares an operand across the
// batch (the candidate axis on one row, the unchanged row shared by every
// candidate).
//
// What bounds it on the H100: operations. The reference fuses the two rows
// into one site [D, D^2, D, D^2] so that the TPU's matrix unit sees wide
// products, at 604 MFLOP per item at chi = 32, D = 8; done as four products
// it costs
//   2 (a m n c u A + m n c A u d r + n c A r d e f + A r f c e C)
// = 201.3 MFLOP per item against 0.55 MB of operands. The card's peak for
// that work is 66.9 TFLOP/s in either type: the FP32 CUDA cores for f32 (no
// TF32: the main path keeps full f32 sums) and the DMMA tensor cores for
// f64 (the FP64 CUDA cores give half of it).
//
// Design. One item's env and output are each chi^2 D^2 values (256 KB at
// chi = 32, D = 8 in f32), more than a CTA's shared memory, so a CTA owns
// one (item, tile of ta values of A) and walks c in chunks of kc values.
// Per chunk, four products whose operands both lie in shared memory,
// K-major (A' over the CTA's A tile, c' over the chunk):
//   step 1  T1[(u,m)][(c',n,A')] = sum_a   E[a][(n,m,c')] Ts[a][(u,A')]
//   step 2  T2[(d,n)][(c',A',r)] = sum_um  T1 R1[(u,m)][(d,r)]
//   step 3  T3[(c',e)][(A',r,f)] = sum_dn  R2[(d,n)][(e,f)] T2
//   step 4  acc[(A',r,f)][C]    += sum_c'e T3 B[(c',e)][C]
// The output tile stays in registers (f32) or MMA fragments (f64) across
// the chunks. Steps 1-3 place each product value through per-CTA offset
// tables (row part + column part: no division in an epilogue) and store 16
// bytes at a time along whichever index is contiguous there. row1, row2 and
// the top tile are copied in once per CTA. env is read by step 1 alone, so
// one buffer holds it: the next copy (kl values of c, two chunks' worth
// when kc = 2) is issued after step 1 and lands during steps 2-4; bot
// streams a chunk a copy into two buffers. Every copy is a cp.async planned
// on the host (Box) with the operand's own strides, consecutive threads on
// its smallest stride, 16 bytes a copy where that dim is contiguous on both
// sides and aligned (one element where the strides force it, as in the
// right form's views), and zero-fills what lies past the last c or A.
// Shared memory is zeroed first, so the padding a product reads is zero.
//
// The bodies:
//  - f64 on the DMMA tensor cores: every product is warp-level
//    mma.sync.aligned.m8n8k4.f64, a warp owning 4 x 2 tiles of 8 x 8, so
//    that one fragment load feeds two or four MMAs (4 x 4 in step 4, whose
//    accumulators stay in fragments across the chunks). Leading dims are 4
//    mod 16 doubles, so the 32 lanes' fragment loads (row lane >> 2, k
//    lane & 3) fall on distinct banks; env's, whose columns interleave two
//    chunks, is 2 mod 16 with step 1's rows taken with bits 1 and 2 swapped
//    (EPos), to the same end. K is padded to 4 with zeroed rows and columns
//    past M or N are read and dropped, never branched around. One CTA of 8
//    warps per SM (220 KB).
//  - f32 on the FP32 CUDA cores: register-tiled SIMT products (4 x 4 per
//    thread in steps 1-3, 4 x 8 in step 4; the lanes of a warp on 8 x 4
//    tiles, so that fragment loads broadcast), the next k's fragments
//    loaded before this k's FMAs. Two CTAs of 8 warps per SM (at most 113
//    KB and 128 registers each), so one CTA's barriers overlap the other's
//    products. At chi = 32, D = 8 the leading dims make every quarter-warp's
//    16-byte scatter store and step 1's two 8-byte env loads conflict-free.
//    What binds it is its own instruction stream, not shared memory: the
//    4 x 4 tiles that two CTAs of 8 warps leave registers for give 16 FMAs
//    a k-step against the loads, addresses and loop around them
//    (scripts/ablate_pair_transfer.py times it with each part taken out).
//  - complex64 and complex128: the same kernel, copies, offset tables and
//    chunk loop on interleaved (re, im) elements, with no conjugate
//    anywhere. The work is four real FMAs a complex multiply-add (805
//    MFLOP an item at chi = 32, D = 8). env is copied one chunk at a time
//    in step 1's row order. One CTA of 8 warps per SM. The tile products
//    live in complex_tiles.cuh, shared with K1's complex bodies.
//    complex64, on the FP32 CUDA cores: each thread owns a 4 x 4 complex
//    tile (lanes 4 x 8 on a warp block of 16 x 32), so each k-step loads
//    two 32-byte fragments and issues 64 FMAs; step 1 runs as Ts^T E so
//    that its long side lies along the warp's 32 columns. Step 4's 4 x 4
//    tile stays in registers across the chunks.
//    complex128, on the DMMA tensor cores: mma.sync.m16n8k8.f64 (the
//    m8n8k4 shape reaches only half the DMMA peak on the H100), four real
//    MMAs a complex tile product, the imaginary part of the A fragment
//    negated in registers for the real output; each fragment value is one
//    16-byte load of (re, im), the leading dims 2 mod 8 elements so that a
//    quarter-warp's loads hit 8 distinct bank groups; K padded to 8. Step
//    4's warp tile (2 x 2 MMA tiles) stays in fragments across the chunks.
// The plan (A tile, c chunk, env grouping, leading dims, region offsets,
// shared bytes) is chosen in Python (kernels/pair_transfer.py:
// pair_transfer_plan) and comes in the meta; check_plan refuses one this
// code cannot run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "complex_tiles.cuh"

namespace {

// the complex bodies' tile products (complex_tiles.cuh)
using cx_tiles::csimt_acc;
using cx_tiles::cx_product;
using cx_tiles::cx_tile_of;
using cx_tiles::zcol;
using cx_tiles::zmma_acc;
using cx_tiles::zmma_product;
using cx_tiles::zrow;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBatch = 4;
constexpr int kMetaInts = kMaxBatch + 3 * (kMaxBatch + 4) +
                          2 * (kMaxBatch + 3) + 11;
constexpr int kPlanInts = 25;
constexpr int64_t kSmemLimit = 232448;

struct Meta {
  int64_t nb[kMaxBatch];          // batch sizes, padded with 1
  int64_t se[kMaxBatch + 4];      // env strides: batch..., a, m, n, c
  int64_t st[kMaxBatch + 3];      // top strides: batch..., a, u, A
  int64_t s1[kMaxBatch + 4];      // row1 strides: batch..., u, m, d, r
  int64_t s2[kMaxBatch + 4];      // row2 strides: batch..., d, n, e, f
  int64_t sb[kMaxBatch + 3];      // bot strides: batch..., c, e, C
  int na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC;
};

// The launch plan, in the order of kernels/pair_transfer.py:PLAN_KEYS.
// Leading dims, offsets and buffer sizes in elements of T, the table offset
// and the total in bytes. env is copied kl = kc or 2 kc values of c at a
// time (one copy for two chunks), its n blocks zn apart; sw swaps bits 1
// and 2 of step 1's row index (see EPos); T3 lies in X1 with T1 when oX3 ==
// oX1.
struct Plan {
  int ta, kc, kl, zn, sw;
  int ldE, ldT, ldR1, ldR2, ld1, ld2, ld3, ldB;
  int oR1, oR2, oT, oE, oB, oX1, oX2, oX3, szE, szB;
  int oTab, smem;
};

// An asynchronous copy of a 4-D box of a global operand into shared memory,
// dst[sum i_k d_k] = src[sum i_k s_k], planned on the host: extents n, the
// block stride kThreads as digits (step), the dim clipped per call (-1:
// none; c' of a partial last chunk, A' of a partial last tile) and the
// values a copy moves (vec, along dim 3, whose n, s and d count vectors).
struct Box {
  int64_t s[4];
  int n[4], d[4], step[4], clip, vec;
};

struct Boxes {
  Box e, b, t, r1, r2;
};

// The body an element type runs (kind) and the multiple K is padded to:
// 0 f32 SIMT, 1 f64 on m8n8k4, 2 complex64 SIMT, 3 complex128 on m16n8k8.
template <typename T> struct Body;
template <> struct Body<float> { static constexpr int kind = 0, kq = 1; };
template <> struct Body<double> { static constexpr int kind = 1, kq = 4; };
template <> struct Body<float2> { static constexpr int kind = 2, kq = 1; };
template <> struct Body<double2> { static constexpr int kind = 3, kq = 8; };

// Step 1's row index i is env value (n nm + m) kc + c' (with bits 1 and 2
// of i swapped when sw: f64's 8-row MMA tiles then read c' pairs of m, m +
// 2 in one half-warp, which a leading dim of 2 mod 16 puts on distinct
// banks); its column in the copy E[a][n zn + m kl + c''] of kl values of c
// is that of c'' = h kc + c' for chunk half h.
__host__ __device__ inline int swap12(int i) {
  return (i & ~6) | ((i & 2) << 1) | ((i & 4) >> 1);
}
struct EPos {
  int kc, kl, h, nm, zn, sw;
  __device__ __forceinline__ int operator()(int i) const {
    if (sw) i = swap12(i);
    const int g = i / kc;
    return (g / nm) * zn + (g % nm) * kl + h * kc + i % kc;
  }
};

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ inline int round_up(int x, int m) { return cdiv(x, m) * m; }
// Thread tiles of an M x N product laid out as in tile_of.
__host__ __device__ inline int tiles(int m, int tm, int n, int tn) {
  return cdiv(cdiv(m, tm), 8) * 8 * cdiv(cdiv(n, tn), 4) * 4;
}

// ---------------------------------------------------------------- device --

// PTX helpers.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// c += a b on one 8 x 8 x 4 tile: lane l holds a = A[l >> 2][l & 3],
// b = B[l & 3][l >> 2], c = C[l >> 2][2 (l & 3) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%4, %5};\n"
      : "=d"(c[0]), "=d"(c[1])
      : "d"(a), "d"(b), "d"(c[0]), "d"(c[1]));
}
// End of PTX helpers.

// The thread's first element of a box as four digits (once per CTA).
__device__ __forceinline__ int4 first_digits(const Box& b) {
  int r = threadIdx.x;
  const int i3 = r % b.n[3]; r /= b.n[3];
  const int i2 = r % b.n[2]; r /= b.n[2];
  const int i1 = r % b.n[1];
  return make_int4(r / b.n[1], i1, i2, i3);
}

// Copy a planned box, V values a copy (the clipped dim valid below cv,
// zero-filled beyond); the digits advance by the block stride with carries.
template <typename T, int V>
__device__ __forceinline__ void run_box_v(const Box& b, int4 f, T* dst,
                                          const T* src, int cv) {
  int i0 = f.x, i1 = f.y, i2 = f.z, i3 = f.w;
  if (b.step[1] == 0 && b.step[2] == 0 && b.step[3] == 0 && b.clip != 0) {
    // The block covers dims 1-3 whole (env and bot in the left form): a
    // thread's copies lie a fixed stride apart and share one validity.
    int valid = V;
    if (b.clip == 3) {
      valid = cv - i3 * V;
      valid = valid < 0 ? 0 : valid > V ? V : valid;
    } else if (b.clip > 0) {
      valid = (b.clip == 1 ? i1 : i2) < cv ? V : 0;
    }
    const int bytes = valid * static_cast<int>(sizeof(T));
    const T* g = src + i0 * b.s[0] + i1 * b.s[1] + i2 * b.s[2] + i3 * b.s[3];
    T* d = dst + i0 * b.d[0] + i1 * b.d[1] + i2 * b.d[2] + i3 * b.d[3];
    const int64_t gs = b.step[0] * b.s[0];
    const int ds = b.step[0] * b.d[0];
    for (; i0 < b.n[0]; i0 += b.step[0], g += gs, d += ds)
      cp_async<V * sizeof(T)>(d, bytes > 0 ? g : src, bytes);
    return;
  }
  while (i0 < b.n[0]) {
    int valid = V;
    if (b.clip == 3) {
      valid = cv - i3 * V;
      valid = valid < 0 ? 0 : valid > V ? V : valid;
    } else if (b.clip >= 0) {
      valid = (b.clip == 0 ? i0 : b.clip == 1 ? i1 : i2) < cv ? V : 0;
    }
    const T* g = valid > 0 ? src + i0 * b.s[0] + i1 * b.s[1] + i2 * b.s[2] +
                                 i3 * b.s[3]
                           : src;
    cp_async<V * sizeof(T)>(
        dst + i0 * b.d[0] + i1 * b.d[1] + i2 * b.d[2] + i3 * b.d[3], g,
        valid * static_cast<int>(sizeof(T)));
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

template <typename T>
__device__ __forceinline__ void run_box(const Box& b, int4 f, T* dst,
                                        const T* src, int cv) {
  if (b.vec == 1) {
    run_box_v<T, 1>(b, f, dst, src, cv);
  } else if constexpr (sizeof(T) == 4) {
    if (b.vec == 2) run_box_v<T, 2>(b, f, dst, src, cv);
    else run_box_v<T, 4>(b, f, dst, src, cv);
  } else if constexpr (sizeof(T) == 8) {
    run_box_v<T, 2>(b, f, dst, src, cv);
  }   // 16-byte elements: one a copy
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

// ------------------------------------------------ f32: SIMT FMA products --

template <int N>
__device__ __forceinline__ void load_frag(float (&x)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int TM, int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN],
                                         const float (&x)[TM],
                                         const float (&y)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
}

// Four values of an X fragment: contiguous (one 16-byte load), or two pairs
// xs apart (the env copy of two chunks, whose c' pairs lie kl apart).
template <bool kPairs>
__device__ __forceinline__ void load_x(float (&x)[4], const float* p, int xs) {
  if constexpr (kPairs) {
    const float2 a = reinterpret_cast<const float2*>(p)[0];
    const float2 b = *reinterpret_cast<const float2*>(p + xs);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
    load_frag<4>(x, p);
  }
}

// acc[4][TN] += sum_k x[k][0:4] y[k][0:TN], x and y K-major in shared
// memory and offset to the tile; the next k's fragments load before this
// k's FMAs.
template <int TN, bool kPairs = false>
__device__ __forceinline__ void simt_acc(float (&acc)[4][TN], const float* x,
                                         int ldx, const float* y, int ldy,
                                         int K, int xs = 0) {
  if (K <= 0) return;
  float x0[4], y0[TN], x1[4], y1[TN];
  load_x<kPairs>(x0, x, xs);
  load_frag<TN>(y0, y);
  for (int k = 0; k < K; k += 2) {
    const bool two = k + 1 < K;
    if (two) {
      load_x<kPairs>(x1, x + ldx, xs);
      load_frag<TN>(y1, y + ldy);
    }
    fma_tile<4, TN>(acc, x0, y0);
    x += 2 * ldx;
    y += 2 * ldy;
    if (k + 2 < K) {
      load_x<kPairs>(x0, x, xs);
      load_frag<TN>(y0, y);
    }
    if (two) fma_tile<4, TN>(acc, x1, y1);
  }
}

// P[m][n] -> dst[ro[m] + co[n]] for the tile at (m0, n0): 16 bytes at a time
// along n or along m where the positions are contiguous and aligned there.
template <int TM, int TN>
__device__ __forceinline__ void simt_store(const float (&acc)[TM][TN], int m0,
                                           int n0, int M, int N, float* dst,
                                           const int* ro, const int* co) {
  static_assert(TM == 4 && TN == 4, "16-byte rows and columns");
  const int c0 = co[n0], r0 = ro[m0];
  bool vn = n0 + TN <= N, vm = m0 + TM <= M;
#pragma unroll
  for (int j = 1; j < TN; ++j) vn = vn && co[n0 + j] == c0 + j;
#pragma unroll
  for (int i = 1; i < TM; ++i) vm = vm && ro[m0 + i] == r0 + i;
  if (vn) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (m0 + i >= M) continue;
      const int o = ro[m0 + i] + c0;
      if ((o & 3) == 0) {
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) dst[o + j] = acc[i][j];
      }
    }
  } else if (vm) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (n0 + j >= N) continue;
      const int o = r0 + co[n0 + j];
      if ((o & 3) == 0) {
        *reinterpret_cast<float4*>(dst + o) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) dst[o + i] = acc[i][j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (m0 + i < M && n0 + j < N)
          dst[ro[m0 + i] + co[n0 + j]] = acc[i][j];
  }
}

// dst <- X^T Y for an M x N product (K-major operands in shared memory; X's
// columns at xp, read in pairs xp.kl apart when kPairs), 4 x 4 tiles per
// thread.
template <bool kPairs = false>
__device__ __forceinline__ void simt_product(const float* X, int ldx, EPos xp,
                                             const float* Y, int ldy, int K,
                                             int M, int N, float* dst,
                                             const int* ro, const int* co) {
  const int n_mt = cdiv(M, 4), n_nt = cdiv(N, 4);
  const int total = tiles(M, 4, N, 4);
  for (int t = threadIdx.x; t < total; t += kThreads) {
    int mi, ni;
    if (!tile_of(t, n_mt, n_nt, mi, ni)) continue;
    float acc[4][4] = {};
    simt_acc<4, kPairs>(acc, X + xp(mi * 4), ldx, Y + ni * 4, ldy, K, xp.kl);
    simt_store<4, 4>(acc, mi * 4, ni * 4, M, N, dst, ro, co);
  }
}

// ----------------------------------------------- f64: DMMA tensor cores --

// acc += the warp tile's product; x and y point at the lane's first value
// (row lane & 3 of K, column lane >> 2 of the tile), K a multiple of 4. The
// next k-step's fragments load before this one's MMAs.
template <int WM, int WN>
__device__ __forceinline__ void dmma_acc(double (&acc)[WM][WN][2],
                                         const double* x, int ldx,
                                         const double* y, int ldy, int K,
                                         int xt = 8) {
  if (K <= 0) return;
  const int sx = 4 * ldx, sy = 4 * ldy;
  double a0[WM], b0[WN], a1[WM], b1[WN];
#pragma unroll
  for (int i = 0; i < WM; ++i) a0[i] = x[xt * i];
#pragma unroll
  for (int j = 0; j < WN; ++j) b0[j] = y[8 * j];
  for (int k = 0; k < K; k += 8) {
    const bool two = k + 4 < K;
    if (two) {
#pragma unroll
      for (int i = 0; i < WM; ++i) a1[i] = x[sx + xt * i];
#pragma unroll
      for (int j = 0; j < WN; ++j) b1[j] = y[sy + 8 * j];
    }
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j) dmma(acc[i][j], a0[i], b0[j]);
    x += 2 * sx;
    y += 2 * sy;
    if (k + 8 < K) {
#pragma unroll
      for (int i = 0; i < WM; ++i) a0[i] = x[xt * i];
#pragma unroll
      for (int j = 0; j < WN; ++j) b0[j] = y[8 * j];
    }
    if (two) {
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) dmma(acc[i][j], a1[i], b1[j]);
    }
  }
}

// dst <- X^T Y for an M x N product (K-major operands in shared memory, K
// padded to 4, X's columns at xp), warp tiles of WM x WN MMA tiles; P[m][n]
// -> dst[ro[m] + co[n]], a lane's two neighbouring values as one 16-byte
// store where they are neighbours there.
template <int WM, int WN>
__device__ __forceinline__ void dmma_product(const double* X, int ldx, EPos xp,
                                             const double* Y, int ldy, int K,
                                             int M, int N, double* dst,
                                             const int* ro, const int* co) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n_wm = cdiv(M, 8 * WM), n_wn = cdiv(N, 8 * WN);
  for (int w = warp; w < n_wm * n_wn; w += kWarps) {
    const int m0 = (w % n_wm) * 8 * WM, n0 = (w / n_wm) * 8 * WN;
    double acc[WM][WN][2] = {};
    dmma_acc<WM, WN>(acc, X + q * ldx + xp(m0 + g), ldx,
                     Y + q * ldy + n0 + g, ldy, K, 8 * xp.kl / xp.kc);
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      const int m = m0 + 8 * i + g;
      if (m >= M) continue;
      const int r = ro[m];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= N) continue;
        const int o = r + co[n];
        if (n + 1 < N && co[n + 1] == co[n] + 1 && (o & 1) == 0) {
          *reinterpret_cast<double2*>(dst + o) =
              make_double2(acc[i][j][0], acc[i][j][1]);
        } else {
          dst[o] = acc[i][j][0];
          if (n + 1 < N) dst[r + co[n + 1]] = acc[i][j][1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- kernel --

template <typename T>
__global__ void __launch_bounds__(kThreads, Body<T>::kind == 0 ? 2 : 1)
pair_transfer_kernel(const T* __restrict__ env, const T* __restrict__ top,
                     const T* __restrict__ row1, const T* __restrict__ row2,
                     const T* __restrict__ bot, T* __restrict__ out,
                     const Meta m, const Plan p, const Boxes bx) {
  constexpr int kKind = Body<T>::kind;
  constexpr bool kMma = kKind == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  for (int i = tid; i < p.smem / 16; i += kThreads)
    reinterpret_cast<int4*>(smem_raw)[i] = make_int4(0, 0, 0, 0);

  const int ta = p.ta, kc = p.kc;
  const int n_split = cdiv(m.nA, ta);
  const int64_t item = blockIdx.x / n_split;
  const int A0 = static_cast<int>(blockIdx.x % n_split) * ta;
  const int va = m.nA - A0 < ta ? m.nA - A0 : ta;   // valid A' of the tile
  int64_t rem = item;
  int64_t oe = 0, ot = 0, o1 = 0, o2 = 0, ob = 0;
  for (int k = kMaxBatch - 1; k >= 0; --k) {
    const int64_t i = rem % m.nb[k];
    rem /= m.nb[k];
    oe += i * m.se[k];
    ot += i * m.st[k];
    o1 += i * m.s1[k];
    o2 += i * m.s2[k];
    ob += i * m.sb[k];
  }

  // the products' sizes; K padded to the MMA's 4 in f64, 8 in complex128
  constexpr int kq = Body<T>::kq;
  const int M1 = m.nn * kc * m.nm, N1 = m.nu * ta, K1 = round_up(m.na, kq);
  const int M2 = m.nn * kc * ta, N2 = m.nd * m.nr,
            K2 = round_up(m.nu * m.nm, kq);
  const int M3 = m.ne * m.nf, N3 = kc * ta * m.nr,
            K3 = round_up(m.nd * m.nn, kq);
  const int M4 = ta * m.nr * m.nf, N4 = m.nC, K4 = round_up(kc * m.ne, kq);

  // offset tables: P1 -> T1, P2 -> T2, P3 -> T3 (row part + column part)
  int* const ro1 = reinterpret_cast<int*>(smem_raw + p.oTab);
  int* const co1 = ro1 + M1;
  int* const ro2 = co1 + N1;
  int* const co2 = ro2 + M2;
  int* const ro3 = co2 + N2;
  int* const co3 = ro3 + M3;
  __syncthreads();   // zeroed before the tables and copies land
  for (int i = tid; i < M1; i += kThreads) {   // (n, m, c')
    const int j = p.sw ? swap12(i) : i;
    ro1[i] = ((j / kc) % m.nm) * p.ld1 +
             ((j % kc) * m.nn + j / (kc * m.nm)) * ta;
  }
  for (int i = tid; i < N1; i += kThreads)     // (u, A')
    co1[i] = (i / ta) * m.nm * p.ld1 + i % ta;
  for (int i = tid; i < M2; i += kThreads)     // (c', n, A')
    ro2[i] = ((i / ta) % m.nn) * p.ld2 + (i / (m.nn * ta)) * ta * m.nr +
             (i % ta) * m.nr;
  for (int i = tid; i < N2; i += kThreads)     // (d, r)
    co2[i] = (i / m.nr) * m.nn * p.ld2 + i % m.nr;
  for (int i = tid; i < M3; i += kThreads)     // (e, f)
    ro3[i] = (i / m.nf) * p.ld3 + i % m.nf;
  for (int i = tid; i < N3; i += kThreads)     // (c', A', r)
    co3[i] = (i / (ta * m.nr)) * m.ne * p.ld3 + (i % (ta * m.nr)) * m.nf;

  T* const R1 = sm + p.oR1;    // [u*nm + m][d*nr + r]
  T* const R2 = sm + p.oR2;    // [d*nn + n][e*nf + f]
  T* const Ts = sm + p.oT;     // [a][u*ta + A']
  T* const E = sm + p.oE;      // [a][n*zn + m*kl + c'']
  T* const X1 = sm + p.oX1;    // T1 [u*nm + m][(c'*nn + n)*ta + A']
  T* const X2 = sm + p.oX2;    // T2 [d*nn + n][(c'*ta + A')*nr + r]
  T* const X3 = sm + p.oX3;    // T3 [c'*ne + e][(A'*nr + r)*nf + f]
  const T* const e = env + oe;
  const T* const b = bot + ob;
  run_box<T>(bx.r1, first_digits(bx.r1), R1, row1 + o1, 0);
  run_box<T>(bx.r2, first_digits(bx.r2), R2, row2 + o2, 0);
  run_box<T>(bx.t, first_digits(bx.t), Ts,
             top + ot + A0 * m.st[kMaxBatch + 2], va);
  const int4 first_e = first_digits(bx.e);
  const int4 first_b = first_digits(bx.b);
  // env: kl values of c a copy, one copy per group of G chunks (E is read
  // by step 1 alone, so the next group lands during steps 2-4); bot: one
  // chunk a copy into two buffers
  const int G = p.kl / kc;
  auto stage_env = [&](int grp) {
    const int c0 = grp * p.kl;
    run_box<T>(bx.e, first_e, E, e + c0 * m.se[kMaxBatch + 3], m.nc - c0);
  };
  auto stage_bot = [&](int ch) {
    const int c0 = ch * kc;
    run_box<T>(bx.b, first_b, sm + p.oB + (ch & 1) * p.szB,
               b + c0 * m.sb[kMaxBatch], m.nc - c0);
  };
  stage_env(0);
  stage_bot(0);
  cp_async_commit();

  const int rows = va * m.nr * m.nf;   // valid rows of the output tile
  T* const o = out + (item * m.nA * m.nr * m.nf + int64_t(A0) * m.nr * m.nf) *
                         m.nC;
  const int n_ch = cdiv(m.nc, kc);
  const EPos ident{1, 1, 0, 1 << 30, 0, 0};
  // step 4's output tile for all chunks: f64, warp w's 32 x 32 tile; f32,
  // the thread's 4 x 8 tile; complex64, the thread's 4 x 4 tile of warp w's
  // 16 x 32 block (at (mc4, nc4)); complex128, warp w's 32 x 16 tile
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int n_wm4 = cdiv(M4, kKind == 2 ? 16 : 32);
  int mi4 = 0, ni4 = 0, mc4 = 0, nc4 = 0;
  bool own;
  if constexpr (kKind == 0) {
    own = tile_of(tid, cdiv(M4, 4), cdiv(N4, 8), mi4, ni4);
  } else if constexpr (kKind == 2) {
    cx_tile_of(warp, n_wm4, mc4, nc4);
    own = warp < n_wm4 * cdiv(N4, 32) && mc4 < M4 && nc4 < N4;
  } else {
    own = warp < n_wm4 * cdiv(N4, kKind == 1 ? 32 : 16);
  }
  const int m4 = (warp % n_wm4) * 32;
  const int n4 = (warp / n_wm4) * (kKind == 3 ? 16 : 32);
  double dacc[kMma ? 4 : 1][4][2] = {};
  float facc[4][kKind == 0 ? 8 : 1] = {};
  float2 cacc[kKind == 2 ? 4 : 1][4] = {};
  double zacc[kKind == 3 ? 2 : 1][2][2][4] = {};

  for (int ch = 0; ch < n_ch; ++ch) {
    cp_async_wait_all();
    __syncthreads();   // chunk ch has landed; chunk ch-1 is consumed
    if (ch + 1 < n_ch) {
      stage_bot(ch + 1);
      cp_async_commit();
    }
    const EPos xp{kc, p.kl, ch % G, m.nm, p.zn, p.sw};
    const T* B = sm + p.oB + (ch & 1) * p.szB;
    if constexpr (kMma) {
      dmma_product<4, 2>(E, p.ldE, xp, Ts, p.ldT, K1, M1, N1, X1, ro1, co1);
    } else if constexpr (kKind == 0) {
      if (G == 2)
        simt_product<true>(E, p.ldE, xp, Ts, p.ldT, K1, M1, N1, X1, ro1, co1);
      else
        simt_product(E, p.ldE, xp, Ts, p.ldT, K1, M1, N1, X1, ro1, co1);
    } else if constexpr (kKind == 2) {
      // step 1 as Ts^T E (E's columns are step 1's rows in order)
      cx_product(Ts, p.ldT, E, p.ldE, K1, N1, M1, X1, co1, ro1);
    } else {
      zmma_product<1, 1>(E, p.ldE, Ts, p.ldT, K1, M1, N1, X1, ro1, co1);
    }
    __syncthreads();
    if (ch + 1 < n_ch && (ch + 1) % G == 0) {
      stage_env((ch + 1) / G);
      cp_async_commit();
    }
    if constexpr (kMma) {
      dmma_product<4, 2>(X1, p.ld1, ident, R1, p.ldR1, K2, M2, N2, X2, ro2,
                         co2);
      __syncthreads();
      // step 3 as T2^T R2: a lane's two values are f neighbours in T3
      dmma_product<4, 2>(X2, p.ld2, ident, R2, p.ldR2, K3, N3, M3, X3, co3,
                         ro3);
      __syncthreads();
      if (own)
        dmma_acc<4, 4>(dacc, X3 + q * p.ld3 + m4 + g, p.ld3,
                       B + q * p.ldB + n4 + g, p.ldB, K4);
    } else if constexpr (kKind == 0) {
      simt_product(X1, p.ld1, ident, R1, p.ldR1, K2, M2, N2, X2, ro2, co2);
      __syncthreads();
      simt_product(R2, p.ldR2, ident, X2, p.ld2, K3, M3, N3, X3, ro3, co3);
      __syncthreads();
      if (own)
        simt_acc<8>(facc, X3 + mi4 * 4, p.ld3, B + ni4 * 8, p.ldB, K4);
    } else if constexpr (kKind == 2) {
      cx_product(X1, p.ld1, R1, p.ldR1, K2, M2, N2, X2, ro2, co2);
      __syncthreads();
      cx_product(R2, p.ldR2, X2, p.ld2, K3, M3, N3, X3, ro3, co3);
      __syncthreads();
      if (own) csimt_acc(cacc, X3 + mc4, p.ld3, B + nc4, p.ldB, K4);
    } else {
      zmma_product<1, 1>(X1, p.ld1, R1, p.ldR1, K2, M2, N2, X2, ro2, co2);
      __syncthreads();
      // step 3 as T2^T R2, as in f64
      zmma_product<1, 1>(X2, p.ld2, R2, p.ldR2, K3, N3, M3, X3, co3, ro3);
      __syncthreads();
      if (own)
        zmma_acc<2, 2, false>(zacc, X3 + q * p.ld3 + m4 + g, p.ld3,
                              B + q * p.ldB + n4 + g, p.ldB, K4);
    }
  }
  if (!own) return;

  // out[item, A0 + A', r, f, C]: row (A', r, f) of the tile is row
  // A0 nr nf + row of the item
  if constexpr (kMma) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m4 + 8 * i + g;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n4 + 8 * j + 2 * q;
        T* const d = o + int64_t(r) * m.nC + c;
        if (c + 1 < N4 && (m.nC & 1) == 0) {
          *reinterpret_cast<double2*>(d) =
              make_double2(dacc[i][j][0], dacc[i][j][1]);
        } else {
          if (c < N4) d[0] = dacc[i][j][0];
          if (c + 1 < N4) d[1] = dacc[i][j][1];
        }
      }
    }
  } else if constexpr (kKind == 0) {
    const int c0 = ni4 * 8;
    const bool vec = c0 + 8 <= N4 && (m.nC & 3) == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mi4 * 4 + i;
      if (r >= rows) continue;
      T* const d = o + int64_t(r) * m.nC + c0;
      if (vec) {
        reinterpret_cast<float4*>(d)[0] =
            make_float4(facc[i][0], facc[i][1], facc[i][2], facc[i][3]);
        reinterpret_cast<float4*>(d)[1] =
            make_float4(facc[i][4], facc[i][5], facc[i][6], facc[i][7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < N4) d[j] = facc[i][j];
      }
    }
  } else if constexpr (kKind == 2) {
    const bool vec = nc4 + 4 <= N4 && (m.nC & 1) == 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = mc4 + i;
      if (r >= rows) continue;
      T* const d = o + int64_t(r) * m.nC + nc4;
      if (vec) {
        reinterpret_cast<float4*>(d)[0] = make_float4(
            cacc[i][0].x, cacc[i][0].y, cacc[i][1].x, cacc[i][1].y);
        reinterpret_cast<float4*>(d)[1] = make_float4(
            cacc[i][2].x, cacc[i][2].y, cacc[i][3].x, cacc[i][3].y);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nc4 + j < N4) d[j] = cacc[i][j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = m4 + 16 * i + zrow(lane, v);
          const int c = n4 + 8 * j + zcol(lane, v);
          if (r < rows && c < N4)
            o[int64_t(r) * m.nC + c] =
                make_double2(zacc[i][j][0][v], zacc[i][j][1][v]);
        }
  }
}

// ------------------------------------------------------------------ host --

// meta layout (int64): nb[4], env strides[8], top strides[7], row1
// strides[8], row2 strides[8], bot strides[7], na, nm, nn, nc, nu, nA, nd,
// nr, ne, nf, nC, then the plan's kPlanInts values.
Meta unpack(const int64_t* p) {
  Meta m;
  for (int k = 0; k < kMaxBatch; ++k) m.nb[k] = *p++;
  for (int k = 0; k < kMaxBatch + 4; ++k) m.se[k] = *p++;
  for (int k = 0; k < kMaxBatch + 3; ++k) m.st[k] = *p++;
  for (int k = 0; k < kMaxBatch + 4; ++k) m.s1[k] = *p++;
  for (int k = 0; k < kMaxBatch + 4; ++k) m.s2[k] = *p++;
  for (int k = 0; k < kMaxBatch + 3; ++k) m.sb[k] = *p++;
  int* sizes[] = {&m.na, &m.nm, &m.nn, &m.nc, &m.nu, &m.nA,
                  &m.nd, &m.nr, &m.ne, &m.nf, &m.nC};
  for (int* s : sizes) *s = static_cast<int>(*p++);
  return m;
}

bool unpack_plan(const int64_t* p, Plan& plan) {
  int* fields[] = {&plan.ta,   &plan.kc,   &plan.kl,   &plan.zn,
                   &plan.sw,   &plan.ldE,  &plan.ldT,  &plan.ldR1,
                   &plan.ldR2, &plan.ld1,  &plan.ld2,  &plan.ld3,
                   &plan.ldB,  &plan.oR1,
                   &plan.oR2,  &plan.oT,   &plan.oE,   &plan.oB,
                   &plan.oX1,  &plan.oX2,  &plan.oX3,  &plan.szE,
                   &plan.szB,  &plan.oTab, &plan.smem};
  static_assert(sizeof(fields) / sizeof(fields[0]) == kPlanInts, "plan");
  for (int* f : fields) {
    if (*p < 0 || *p > kSmemLimit) return false;
    *f = static_cast<int>(*p++);
  }
  return true;
}

int64_t batch_items(const Meta& m) {
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) items *= m.nb[k];
  return items;
}

// Whether this code can run the plan: env groups of one or two chunks
// (pairs of c' in f32; one chunk in step 1's row order for the complex
// bodies), every operand's rows and the columns its product reads fit its
// leading dim, the regions are aligned and disjoint (T1 and T3 may share
// one when no padding row of one lies under the other's values), the
// tables and the total fit, and step 4's tiles fit the CTA. A plan that
// passes reads and writes only inside its own shared memory.
template <typename T>
bool check_plan(const Meta& m, const Plan& p) {
  constexpr int kind = Body<T>::kind, kq = Body<T>::kq;
  constexpr bool mma = kind == 1;
  constexpr int W = 16 / sizeof(T);
  const int ta = p.ta, kc = p.kc;
  if (ta < 1 || ta > m.nA || kc < 1 || kc > m.nc) return false;
  if (kind >= 2) {
    if (p.kl != kc || p.zn != m.nm * kc || p.sw != 0) return false;
  } else {
    if (p.kl != kc && !(kc == 2 && p.kl == 4)) return false;
    // pairs of c' in f32 stay inside an n block; f64 lanes step 8 kl / kc
    if (p.kl != kc && !mma && m.nm % 2 != 0) return false;
    if (p.zn < m.nm * p.kl || (mma && p.zn != m.nm * p.kl)) return false;
    // the swap permutes rows within aligned groups of 8 = 4 m x 2 c'
    if (p.sw != 0 && (p.sw != 1 || kc != 2 || m.nm % 4 != 0)) return false;
  }
  auto kp = [&](int x) { return round_up(x, kq); };
  const int M1 = m.nn * kc * m.nm, N1 = m.nu * ta, M2 = m.nn * kc * ta,
            N2 = m.nd * m.nr, M3 = m.ne * m.nf, N3 = kc * ta * m.nr,
            M4 = ta * m.nr * m.nf;
  const int lds[] = {p.ldE, p.ldT, p.ldR1, p.ldR2, p.ld1, p.ld2, p.ld3,
                     p.ldB};
  int need[8];
  if constexpr (kind <= 1) {
    // columns read: SIMT tiles of 4 (8 for bot), DMMA tiles of 32 and 16
    // (32); f64 reads T2 as step 3's X (T2^T R2), f32 as its Y (R2^T T2)
    auto wx = [&](int x) { return round_up(x, mma ? 32 : 4); };
    auto wy = [&](int x, bool last) {
      return round_up(x, mma ? (last ? 32 : 16) : (last ? 8 : 4));
    };
    const int n[] = {cdiv(wx(M1) / kc, m.nm) * p.zn, wy(N1, false),
                     wy(N2, false), wx(M3), wx(M2),
                     mma ? wx(N3) : wy(N3, false), wx(M4), wy(m.nC, true)};
    for (int i = 0; i < 8; ++i) need[i] = n[i];
  } else if constexpr (kind == 2) {
    // warp blocks of 16 (X) x 32 (Y); step 1 runs as Ts^T E
    const int n[] = {round_up(M1, 32), round_up(N1, 16), round_up(N2, 32),
                     round_up(M3, 16), round_up(M2, 16), round_up(N3, 32),
                     round_up(M4, 16), round_up(m.nC, 32)};
    for (int i = 0; i < 8; ++i) need[i] = n[i];
  } else {
    // MMA tiles of 16 (X) x 8 (Y), warp tiles of 32 x 16 in step 4; step 3
    // runs as T2^T R2
    const int n[] = {round_up(M1, 16), round_up(N1, 8), round_up(N2, 8),
                     round_up(M3, 8), round_up(M2, 16), round_up(N3, 16),
                     round_up(M4, 32), round_up(m.nC, 16)};
    for (int i = 0; i < 8; ++i) need[i] = n[i];
  }
  for (int i = 0; i < 8; ++i)
    if (lds[i] < need[i] || lds[i] % W != 0) return false;
  const int64_t x1 = int64_t(kp(m.nu * m.nm)) * p.ld1;
  const int64_t x3 = int64_t(kp(kc * m.ne)) * p.ld3;
  const bool shared13 = p.oX3 == p.oX1;
  if (shared13 && kq > 1 && ((m.nu * m.nm) % kq != 0 || (kc * m.ne) % kq != 0))
    return false;
  if (p.szE < int64_t(kp(m.na)) * p.ldE || p.szB < int64_t(kp(kc * m.ne)) * p.ldB)
    return false;
  struct Region { int64_t o, n; };
  const Region regions[] = {
      {p.oR1, int64_t(kp(m.nu * m.nm)) * p.ldR1},
      {p.oR2, int64_t(kp(m.nd * m.nn)) * p.ldR2},
      {p.oT, int64_t(kp(m.na)) * p.ldT},
      {p.oE, int64_t(p.szE)},
      {p.oB, 2 * int64_t(p.szB)},
      {p.oX1, shared13 && x3 > x1 ? x3 : x1},
      {p.oX2, int64_t(kp(m.nd * m.nn)) * p.ld2},
      {p.oX3, shared13 ? 0 : x3}};
  int64_t end = 0;
  for (int i = 0; i < 8; ++i) {
    const Region& a = regions[i];
    if (a.o % W != 0) return false;
    if (a.o + a.n > end) end = a.o + a.n;
    for (int j = 0; j < i; ++j) {
      const Region& c = regions[j];
      if (a.n > 0 && c.n > 0 && a.o < c.o + c.n && c.o < a.o + a.n)
        return false;
    }
  }
  if (p.szE % W != 0 || p.szB % W != 0) return false;
  const int64_t tab = int64_t(M1) + N1 + M2 + N2 + M3 + N3;
  if (p.oTab % 16 != 0 || p.oTab < end * int64_t(sizeof(T)) ||
      p.oTab + 4 * tab > p.smem || p.smem % 16 != 0 || p.smem > kSmemLimit)
    return false;
  if constexpr (kind == 0) return tiles(M4, 4, m.nC, 8) <= kThreads;
  if constexpr (kind == 1) return cdiv(M4, 32) * cdiv(m.nC, 32) <= kWarps;
  if constexpr (kind == 2) return cdiv(M4, 16) * cdiv(m.nC, 32) <= kWarps;
  return cdiv(M4, 32) * cdiv(m.nC, 16) <= kWarps;
}

int64_t gcd64(int64_t a, int64_t b) {
  a = a < 0 ? -a : a;
  b = b < 0 ? -b : b;
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Plan a box copy: dims in the destination's order; the dim of smallest
// |source stride| (of those longer than 1) becomes the threads' fastest,
// and moves up to wmax values a copy where it is contiguous on both sides
// and every other source step (other dims, the batch, the per-call offset,
// the base address: their gcd is `align`) keeps the vectors aligned.
Box make_box(int n0, int n1, int n2, int n3, int64_t s0, int64_t s1,
             int64_t s2, int64_t s3, int d0, int d1, int d2, int d3,
             int clip, int wmax, int64_t align) {
  Box b{{s0, s1, s2, s3}, {n0, n1, n2, n3}, {d0, d1, d2, d3}, {0, 0, 0, 0},
        clip, 1};
  int fast = 3;
  for (int k = 0; k < 3; ++k)
    if (b.n[k] > 1 && (b.n[fast] == 1 || llabs(b.s[k]) < llabs(b.s[fast])))
      fast = k;
  if (fast != 3) {
    const int64_t s = b.s[fast]; b.s[fast] = b.s[3]; b.s[3] = s;
    int t = b.n[fast]; b.n[fast] = b.n[3]; b.n[3] = t;
    t = b.d[fast]; b.d[fast] = b.d[3]; b.d[3] = t;
    b.clip = clip == fast ? 3 : clip == 3 ? fast : clip;
  }
  if (b.s[3] == 1 && b.d[3] == 1) {
    for (int v = wmax; v > 1; v /= 2) {
      bool ok = b.n[3] % v == 0 && align % v == 0;
      for (int k = 0; k < 3; ++k)
        ok = ok && (b.n[k] == 1 || (b.s[k] % v == 0 && b.d[k] % v == 0));
      if (ok) {
        b.vec = v;
        b.n[3] /= v;
        b.s[3] *= v;
        b.d[3] *= v;
        break;
      }
    }
  }
  int q = kThreads;
  for (int k = 3; k > 0; --k) {
    b.step[k] = q % b.n[k];
    q /= b.n[k];
  }
  b.step[0] = q;
  return b;
}

// The gcd of the batch strides an operand moves by (its per-item offsets).
int64_t batch_gcd(const Meta& m, const int64_t* strides) {
  int64_t g = 0;
  for (int k = 0; k < kMaxBatch; ++k)
    if (m.nb[k] > 1) g = gcd64(g, strides[k]);
  return g;
}

template <typename T>
Boxes make_boxes(const Meta& m, const Plan& p, const T* env, const T* top,
                 const T* row1, const T* row2, const T* bot) {
  constexpr int W = 16 / sizeof(T);
  auto base = [](const void* ptr) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
    return a % sizeof(T) ? int64_t(1) : int64_t(a / sizeof(T));
  };
  const int64_t* se = m.se + kMaxBatch;
  const int64_t* st = m.st + kMaxBatch;
  const int64_t* s1 = m.s1 + kMaxBatch;
  const int64_t* s2 = m.s2 + kMaxBatch;
  const int64_t* sb = m.sb + kMaxBatch;
  const int ta = p.ta, kc = p.kc;
  Boxes bx;
  // E[a][n*zn + m*kl + c''] = env[a, m, n, c0 + c'']
  bx.e = make_box(m.na, m.nm, m.nn, p.kl, se[0], se[1], se[2], se[3], p.ldE,
                  p.kl, p.zn, 1, 3, W,
                  gcd64(gcd64(base(env), batch_gcd(m, m.se)), p.kl * se[3]));
  // B[c'*ne + e][C] = bot[c0 + c', e, C]
  bx.b = make_box(1, kc, m.ne, m.nC, 0, sb[0], sb[1], sb[2], 0, m.ne * p.ldB,
                  p.ldB, 1, 1, W,
                  gcd64(gcd64(base(bot), batch_gcd(m, m.sb)), kc * sb[0]));
  // Ts[a][u*ta + A'] = top[a, u, A0 + A']
  bx.t = make_box(1, m.na, m.nu, ta, 0, st[0], st[1], st[2], 0, p.ldT, ta, 1,
                  3, W,
                  gcd64(gcd64(base(top), batch_gcd(m, m.st)), ta * st[2]));
  bx.r1 = make_box(m.nu, m.nm, m.nd, m.nr, s1[0], s1[1], s1[2], s1[3],
                   m.nm * p.ldR1, p.ldR1, m.nr, 1, -1, W,
                   gcd64(base(row1), batch_gcd(m, m.s1)));
  bx.r2 = make_box(m.nd, m.nn, m.ne, m.nf, s2[0], s2[1], s2[2], s2[3],
                   m.nn * p.ldR2, p.ldR2, m.nf, 1, -1, W,
                   gcd64(base(row2), batch_gcd(m, m.s2)));
  return bx;
}

constexpr int kMaxDevices = 64;

// Once per (instantiation, device): the kernel may take the whole 227 KB,
// and the SM keeps its largest shared-memory carveout.
template <typename T>
int prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  static bool done[kMaxDevices] = {};
  if (!done[dev]) {
    err = cudaFuncSetAttribute(pair_transfer_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(pair_transfer_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T>
int launch(const T* env, const T* top, const T* row1, const T* row2,
           const T* bot, T* out, const int64_t* meta, cudaStream_t stream) {
  const Meta m = unpack(meta);
  if (batch_items(m) == 0 || m.nA == 0 || m.nr == 0 || m.nf == 0 ||
      m.nC == 0)
    return static_cast<int>(cudaSuccess);
  Plan p;
  if (!unpack_plan(meta + kMetaInts, p) || !check_plan<T>(m, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ctas = batch_items(m) * cdiv(m.nA, p.ta);
  if (ctas >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare<T>();
  if (err != 0) return err;
  const Boxes bx = make_boxes<T>(m, p, env, top, row1, row2, bot);
  pair_transfer_kernel<T><<<static_cast<unsigned>(ctas), kThreads, p.smem,
                            stream>>>(env, top, row1, row2, bot, out, m, p,
                                      bx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attributes(int64_t smem, int64_t* out) {
  int err = prepare<T>();
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, pair_transfer_kernel<T>));
  if (err != 0) return err;
  int ctas = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, pair_transfer_kernel<T>, kThreads, static_cast<size_t>(smem)));
  if (err != 0) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = ctas;
  return 0;
}

// One warp: c <- x^T y + c on one 16 x 8 x 8 tile of complex128 (x [8][16],
// y [8][8], c [16][8], row-major) through the complex128 body's fragment
// loads, MMAs and fragment positions: the card test of the m16n8k8 layout.
__global__ void zmma_tile_kernel(const double2* x, const double2* y,
                                 double2* c) {
  const int lane = threadIdx.x & 31;
  double acc[1][1][2][4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const double2 cv = c[zrow(lane, v) * 8 + zcol(lane, v)];
    acc[0][0][0][v] = cv.x;
    acc[0][0][1][v] = cv.y;
  }
  zmma_acc<1, 1>(acc, x + (lane & 3) * 16 + (lane >> 2), 16,
                 y + (lane & 3) * 8 + (lane >> 2), 8, 8);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    c[zrow(lane, v) * 8 + zcol(lane, v)] =
        make_double2(acc[0][0][0][v], acc[0][0][1][v]);
}

}  // namespace

extern "C" {

int pair_transfer_f32(const float* env, const float* top, const float* row1,
                      const float* row2, const float* bot, float* out,
                      const int64_t* meta, void* stream) {
  return launch<float>(env, top, row1, row2, bot, out, meta,
                       static_cast<cudaStream_t>(stream));
}

int pair_transfer_f64(const double* env, const double* top,
                      const double* row1, const double* row2,
                      const double* bot, double* out, const int64_t* meta,
                      void* stream) {
  return launch<double>(env, top, row1, row2, bot, out, meta,
                        static_cast<cudaStream_t>(stream));
}

// complex64 / complex128 (interleaved (re, im) elements; meta as above)
int pair_transfer_c64(const void* env, const void* top, const void* row1,
                      const void* row2, const void* bot, void* out,
                      const int64_t* meta, void* stream) {
  using V = float2;
  return launch<V>(static_cast<const V*>(env), static_cast<const V*>(top),
                   static_cast<const V*>(row1), static_cast<const V*>(row2),
                   static_cast<const V*>(bot), static_cast<V*>(out), meta,
                   static_cast<cudaStream_t>(stream));
}

int pair_transfer_c128(const void* env, const void* top, const void* row1,
                       const void* row2, const void* bot, void* out,
                       const int64_t* meta, void* stream) {
  using V = double2;
  return launch<V>(static_cast<const V*>(env), static_cast<const V*>(top),
                   static_cast<const V*>(row1), static_cast<const V*>(row2),
                   static_cast<const V*>(bot), static_cast<V*>(out), meta,
                   static_cast<cudaStream_t>(stream));
}

// The one-tile check of the complex128 MMA fragments (zmma_tile_kernel).
int pair_transfer_zmma_tile(const void* x, const void* y, void* c,
                            void* stream) {
  zmma_tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(x), static_cast<const double2*>(y),
      static_cast<double2*>(c));
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel of one dtype at a plan's shared bytes: out[0..2] =
// registers a thread, local (spill) bytes a thread, CTAs an SM holds.
int pair_transfer_attributes(int elem_bytes, int64_t smem_bytes,
                             int64_t* out) {
  return elem_bytes == 8 ? attributes<double>(smem_bytes, out)
                         : attributes<float>(smem_bytes, out);
}

// The same for the complex bodies: elem_bytes 8 (complex64) or 16.
int pair_transfer_cx_attributes(int elem_bytes, int64_t smem_bytes,
                                int64_t* out) {
  return elem_bytes == 16 ? attributes<double2>(smem_bytes, out)
                          : attributes<float2>(smem_bytes, out);
}

}  // extern "C"
