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
// What bounds it on the H100: the reference fuses the two rows into one fat
// site [D, D^2, D, D^2] (1 MB at D = 8 in f32) so that the TPU's matrix unit
// sees wide products. Done that way a step costs 604 MFLOP at chi = 32,
// D = 8; done as four products it costs
//   2 (a m n c u A + m n c A u d r + n c A r d e f + A r f c e C)
// = 201.3 MFLOP per item against 0.55 MB of operands, so the transfer is
// compute-bound. f32 runs on the FP32 CUDA cores, which are its peak (no
// TF32: the main path keeps full f32 sums); f64 on DFMA, half the card's
// f64 peak (the DMMA tensor cores, which a later body may use).
//
// Design. One item's env and output are each chi^2 D^2 values (256 KB at
// chi = 32, D = 8 in f32), more than a CTA's shared memory, so a CTA owns
// one (item, tile of TA values of A) and streams env and bot in chunks of KC
// values of c. Per chunk, four register-tiled SIMT GEMMs whose operands both
// sit in shared memory (A' over the CTA's A tile, c' over the chunk):
//   step 1  T1[(u,m)][(n,c',A')]   = sum_a   E[a][(n,c',m)] Ts[a][(u,A')]
//   step 2  T2[(d,n)][(c',A',r)]   = sum_um  T1 R1[(u,m)][(d,r)]
//   step 3  T3[(c',e)][(A',r,f)]   = sum_dn  T2 R2[(d,n)][(e,f)]
//   step 4  acc[(A',r,f)][C]      += sum_c'e T3 B[(c',e)][C]
// Each step writes its result in the K-major layout the next step reads;
// the thread tile's columns are contiguous there, so it stores 16-byte
// vectors. T3 overwrites T1. The output tile (TA D^2 chi values) stays in
// registers across the chunks, so no global load sits inside a product
// loop. row1, row2 and the top tile are copied in once per CTA; env and bot
// stream with cp.async into two buffers each, so chunk k+1 lands while
// chunk k is multiplied. Every copy is planned on the host (Box) with the
// operand's own strides, consecutive threads on its smallest stride, and
// zero-fills what lies past the last c or A. Plans: f32 TA = 8, KC = 2
// (150 KB of shared memory, 4x8 tiles in steps 1-3, an 8x8 output tile per
// thread); f64 TA = 4, KC = 1 (2x4 and 4x8). TA shrinks when the output
// tiles would not fit in one per thread, KC and then TA when shared memory
// would not fit; a shape that fits neither is refused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;
constexpr size_t kSmemLimit = 232448;

struct Meta {
  int64_t nb[kMaxBatch];          // batch sizes, padded with 1
  int64_t se[kMaxBatch + 4];      // env strides: batch..., a, m, n, c
  int64_t st[kMaxBatch + 3];      // top strides: batch..., a, u, A
  int64_t s1[kMaxBatch + 4];      // row1 strides: batch..., u, m, d, r
  int64_t s2[kMaxBatch + 4];      // row2 strides: batch..., d, n, e, f
  int64_t sb[kMaxBatch + 3];      // bot strides: batch..., c, e, C
  int na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC;
};

// Thread tiles: steps 1-3 TM x TN, step 4 TM4 x TN4; default A tile, c chunk.
template <int TM_, int TN_, int TM4_, int TN4_, int TA_, int KC_>
struct Cfg {
  static constexpr int TM = TM_, TN = TN_, TM4 = TM4_, TN4 = TN4_;
  static constexpr int TA = TA_, KC = KC_;
};
using F32Cfg = Cfg<4, 8, 8, 8, 8, 2>;
using F64Cfg = Cfg<2, 4, 4, 8, 4, 1>;

// An asynchronous copy of a 4-D box of a global operand into shared memory,
// dst[sum i_k d_k] = src[sum i_k s_k], planned on the host: extents n, the
// block stride kThreads as digits (step), and the dim clipped per call
// (-1: none; c' of a partial last chunk, A' of a partial last tile).
struct Box {
  int64_t s[4];
  int n[4], d[4], step[4], clip;
};

// Row m of a product goes to (m / p) * x + (m % p) * y of the destination,
// column j to (j / q) * z + (j % q) * w.
struct Scatter {
  int p, x, y, q, z, w;
};

struct Plan {
  int ta, kc, n_split;
  int ldE, ldT, ldR1, ldR2, ld1, ld2, ld3, ldB;   // leading dims (elements)
  int oR1, oR2, oT, oE, oB, oX1, oX2;            // region offsets (elements)
  int szE, szB;                                  // one stream buffer
  Box bE, bB, bT, bR1, bR2;
  int64_t ctas;
  size_t smem;                                   // bytes
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

// The thread's first element of a box as four digits (once per CTA).
__device__ __forceinline__ int4 first_digits(const Box& b) {
  int r = threadIdx.x;
  const int i3 = r % b.n[3]; r /= b.n[3];
  const int i2 = r % b.n[2]; r /= b.n[2];
  const int i1 = r % b.n[1];
  return make_int4(r / b.n[1], i1, i2, i3);
}

// Copy a planned box, element by element (the clipped dim valid below cv,
// zero-filled beyond); the digits advance by the block stride with carries.
template <typename T>
__device__ __forceinline__ void run_box(const Box& b, int4 f, T* dst,
                                        const T* src, int cv) {
  int i0 = f.x, i1 = f.y, i2 = f.z, i3 = f.w;
  while (i0 < b.n[0]) {
    const int ic = b.clip == 0 ? i0 : b.clip == 1 ? i1 : b.clip == 2 ? i2 : i3;
    const bool ok = b.clip < 0 || ic < cv;
    const T* g = ok ? src + i0 * b.s[0] + i1 * b.s[1] + i2 * b.s[2] +
                          i3 * b.s[3]
                    : src;
    cp_async<sizeof(T)>(
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

// N consecutive shared values into registers with 16-byte loads.
template <int N>
__device__ __forceinline__ void load_frag(float (&x)[N], const float* p) {
  static_assert(N % 4 == 0, "f32 tile widths are multiples of 4");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_frag(double (&x)[N], const double* p) {
  static_assert(N % 2 == 0, "f64 tile widths are even");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const double2 v = reinterpret_cast<const double2*>(p)[i];
    x[2 * i] = v.x; x[2 * i + 1] = v.y;
  }
}

// N consecutive registers into shared memory with 16-byte stores.
template <int N>
__device__ __forceinline__ void store_frag(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
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

// dst <- a^T b for an M x N product with K-major operands in shared memory,
// each value placed by the scatter s; a thread's row of TN values is stored
// as 16-byte vectors where it is contiguous and aligned there.
template <typename T, int TM, int TN>
__device__ __forceinline__ void block_product(const T* a, int lda, const T* b,
                                              int ldb, int K, int M, int N,
                                              T* dst, const Scatter s) {
  constexpr int W = 16 / sizeof(T);
  const int n_mt = cdiv(M, TM), n_nt = cdiv(N, TN);
  const int total = tiles(M, TM, N, TN);
  for (int t = threadIdx.x; t < total; t += kThreads) {
    int mi, ni;
    if (!tile_of(t, n_mt, n_nt, mi, ni)) continue;
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    mma_tile<T, TM, TN>(acc, a + mi * TM, lda, b + ni * TN, ldb, K);
    int col[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = ni * TN + j;
      col[j] = n < N ? (n / s.q) * s.z + (n % s.q) * s.w : -1;
    }
    const bool contig = col[TN - 1] == col[0] + TN - 1;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = mi * TM + i;
      if (m >= M) continue;
      const int row = (m / s.p) * s.x + (m % s.p) * s.y;
      if (contig && (row + col[0]) % W == 0) {
        store_frag<TN>(dst + row + col[0], acc[i]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (col[j] >= 0) dst[row + col[j]] = acc[i][j];
      }
    }
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads, 1)
pair_transfer_kernel(const T* __restrict__ env, const T* __restrict__ top,
                     const T* __restrict__ row1, const T* __restrict__ row2,
                     const T* __restrict__ bot, T* __restrict__ out,
                     const Meta m, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  T* const R1 = sm + p.oR1;    // [u*nm + m][d*nr + r]
  T* const R2 = sm + p.oR2;    // [d*nn + n][e*nf + f]
  T* const Ts = sm + p.oT;     // [a][u*ta + A']
  T* const X1 = sm + p.oX1;    // T1 [u*nm + m][(n*kc + c')*ta + A'],
                               // then T3 [c'*ne + e][(A'*nr + r)*nf + f]
  T* const X2 = sm + p.oX2;    // T2 [d*nn + n][(c'*ta + A')*nr + r]

  const int tid = threadIdx.x;
  const int64_t item = blockIdx.x / p.n_split;
  const int A0 = static_cast<int>(blockIdx.x % p.n_split) * p.ta;
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
  const T* const e = env + oe;
  const T* const b = bot + ob;
  const int ta = p.ta, kc = p.kc;
  const int va = m.nA - A0 < ta ? m.nA - A0 : ta;   // valid A' of the tile

  run_box<T>(p.bR1, first_digits(p.bR1), R1, row1 + o1, 0);
  run_box<T>(p.bR2, first_digits(p.bR2), R2, row2 + o2, 0);
  run_box<T>(p.bT, first_digits(p.bT), Ts,
             top + ot + A0 * m.st[kMaxBatch + 2], va);
  const int4 first_e = first_digits(p.bE);
  const int4 first_b = first_digits(p.bB);
  auto stage_chunk = [&](int ch) {
    const int c0 = ch * kc;
    run_box<T>(p.bE, first_e, sm + p.oE + (ch & 1) * p.szE,
               e + c0 * m.se[kMaxBatch + 3], m.nc - c0);
    run_box<T>(p.bB, first_b, sm + p.oB + (ch & 1) * p.szB,
               b + c0 * m.sb[kMaxBatch], m.nc - c0);
  };
  stage_chunk(0);
  cp_async_commit();

  const int M1 = m.nn * kc * m.nm, N1 = m.nu * ta;
  const int M2 = m.nn * kc * ta, N2 = m.nd * m.nr;
  const int M3 = kc * ta * m.nr, N3 = m.ne * m.nf;
  const int M4 = ta * m.nr * m.nf, N4 = m.nC;
  const Scatter s1{m.nm, ta, p.ld1, ta, m.nm * p.ld1, 1};
  const Scatter s2{kc * ta, p.ld2, m.nr, m.nr, m.nn * p.ld2, 1};
  const Scatter s3{ta * m.nr, m.ne * p.ld3, m.nf, m.nf, p.ld3, 1};

  int mi4, ni4;
  const bool ok4 = tile_of(tid, cdiv(M4, C::TM4), cdiv(N4, C::TN4), mi4, ni4);
  T acc[C::TM4][C::TN4];
#pragma unroll
  for (int i = 0; i < C::TM4; ++i)
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) acc[i][j] = T(0);

  const int n_ch = cdiv(m.nc, kc);
  for (int ch = 0; ch < n_ch; ++ch) {
    cp_async_wait_all();
    __syncthreads();   // chunk ch has landed; chunk ch-1 is consumed
    if (ch + 1 < n_ch) {
      stage_chunk(ch + 1);
      cp_async_commit();
    }
    const T* E = sm + p.oE + (ch & 1) * p.szE;
    const T* B = sm + p.oB + (ch & 1) * p.szB;
    block_product<T, C::TM, C::TN>(E, p.ldE, Ts, p.ldT, m.na, M1, N1, X1, s1);
    __syncthreads();
    block_product<T, C::TM, C::TN>(X1, p.ld1, R1, p.ldR1, m.nu * m.nm, M2, N2,
                                   X2, s2);
    __syncthreads();
    block_product<T, C::TM, C::TN>(X2, p.ld2, R2, p.ldR2, m.nd * m.nn, M3, N3,
                                   X1, s3);
    __syncthreads();
    if (ok4)
      mma_tile<T, C::TM4, C::TN4>(acc, X1 + mi4 * C::TM4, p.ld3,
                                  B + ni4 * C::TN4, p.ldB, kc * m.ne);
  }

  if (!ok4) return;
  // out[item, A0 + A', r, f, C]: row (A', r, f) of the tile is row
  // A0 nr nf + m4 of the item
  const int rows = va * m.nr * m.nf;
  T* const o = out + (item * m.nA * m.nr * m.nf + int64_t(A0) * m.nr * m.nf) *
                         m.nC;
#pragma unroll
  for (int i = 0; i < C::TM4; ++i) {
    const int r = mi4 * C::TM4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < C::TN4; ++j) {
      const int c = ni4 * C::TN4 + j;
      if (c < N4) o[int64_t(r) * m.nC + c] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ host --

// meta layout (int64): nb[4], env strides[8], top strides[7], row1
// strides[8], row2 strides[8], bot strides[7], na, nm, nn, nc, nu, nA, nd,
// nr, ne, nf, nC.
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

int64_t batch_items(const Meta& m) {
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) items *= m.nb[k];
  return items;
}

// A leading dim: a multiple of 4 elements (16-byte rows), and not of 32.
int lead(int x) {
  const int ld = round_up(x, 4);
  return ld % 32 == 0 ? ld + 4 : ld;
}

// Plan a box copy: dims in the destination's order; the dim of smallest
// |source stride| (of those longer than 1) becomes the threads' fastest.
Box make_box(int n0, int n1, int n2, int n3, int64_t s0, int64_t s1,
             int64_t s2, int64_t s3, int d0, int d1, int d2, int d3,
             int clip) {
  Box b{{s0, s1, s2, s3}, {n0, n1, n2, n3}, {d0, d1, d2, d3}, {0, 0, 0, 0},
        clip};
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
  int q = kThreads;
  for (int k = 3; k > 0; --k) {
    b.step[k] = q % b.n[k];
    q /= b.n[k];
  }
  b.step[0] = q;
  return b;
}

// Lay out shared memory for A tile ta and c chunk kc; false when the output
// tiles exceed one per thread or the buffers exceed 227 KB.
template <typename T, typename C>
bool layout(const Meta& m, int ta, int kc, Plan& p) {
  p.ta = ta;
  p.kc = kc;
  p.ldE = lead(round_up(m.nn * kc * m.nm, C::TM));
  p.ldT = lead(round_up(m.nu * ta, C::TN));
  p.ld1 = lead(round_up(m.nn * kc * ta, C::TM));
  p.ldR1 = lead(round_up(m.nd * m.nr, C::TN));
  p.ld2 = lead(round_up(kc * ta * m.nr, C::TM));
  p.ldR2 = lead(round_up(m.ne * m.nf, C::TN));
  p.ld3 = lead(round_up(ta * m.nr * m.nf, C::TM4));
  p.ldB = lead(round_up(m.nC, C::TN4));
  p.szE = m.na * p.ldE;
  p.szB = kc * m.ne * p.ldB;
  p.oR1 = 0;
  p.oR2 = p.oR1 + m.nu * m.nm * p.ldR1;
  p.oT = p.oR2 + m.nd * m.nn * p.ldR2;
  p.oE = p.oT + m.na * p.ldT;
  p.oB = p.oE + 2 * p.szE;
  p.oX1 = p.oB + 2 * p.szB;
  const int x1 = m.nu * m.nm * p.ld1 > kc * m.ne * p.ld3
                     ? m.nu * m.nm * p.ld1 : kc * m.ne * p.ld3;
  p.oX2 = p.oX1 + x1;
  p.smem = sizeof(T) * static_cast<size_t>(p.oX2 + m.nd * m.nn * p.ld2);
  return tiles(ta * m.nr * m.nf, C::TM4, m.nC, C::TN4) <= kThreads &&
         p.smem <= kSmemLimit;
}

template <typename T, typename C>
bool plan_for(const Meta& m, Plan& p) {
  int ta = m.nA < C::TA ? m.nA : C::TA;
  int kc = m.nc < C::KC ? m.nc : C::KC;
  while (!layout<T, C>(m, ta, kc, p)) {
    if (tiles(ta * m.nr * m.nf, C::TM4, m.nC, C::TN4) > kThreads && ta > 1)
      ta = cdiv(ta, 2);
    else if (kc > 1) kc = cdiv(kc, 2);
    else if (ta > 1) ta = cdiv(ta, 2);
    else return false;
  }
  p.n_split = cdiv(m.nA, ta);
  p.ctas = batch_items(m) * p.n_split;
  const int64_t* se = m.se + kMaxBatch;
  const int64_t* st = m.st + kMaxBatch;
  const int64_t* s1 = m.s1 + kMaxBatch;
  const int64_t* s2 = m.s2 + kMaxBatch;
  const int64_t* sb = m.sb + kMaxBatch;
  // E[a][(n*kc + c')*nm + m] = env[a, m, n, c0 + c']
  p.bE = make_box(m.na, m.nm, m.nn, kc, se[0], se[1], se[2], se[3], p.ldE, 1,
                  kc * m.nm, m.nm, 3);
  // B[c'*ne + e][C] = bot[c0 + c', e, C]
  p.bB = make_box(1, kc, m.ne, m.nC, 0, sb[0], sb[1], sb[2], 0, m.ne * p.ldB,
                  p.ldB, 1, 1);
  // Ts[a][u*ta + A'] = top[a, u, A0 + A']
  p.bT = make_box(1, m.na, m.nu, ta, 0, st[0], st[1], st[2], 0, p.ldT, ta, 1,
                  3);
  p.bR1 = make_box(m.nu, m.nm, m.nd, m.nr, s1[0], s1[1], s1[2], s1[3],
                   m.nm * p.ldR1, p.ldR1, m.nr, 1, -1);
  p.bR2 = make_box(m.nd, m.nn, m.ne, m.nf, s2[0], s2[1], s2[2], s2[3],
                   m.nn * p.ldR2, p.ldR2, m.nf, 1, -1);
  return true;
}

template <typename T>
bool make_plan(const Meta& m, Plan& p) {
  if constexpr (sizeof(T) == 8) return plan_for<T, F64Cfg>(m, p);
  else return plan_for<T, F32Cfg>(m, p);
}

constexpr int kMaxDevices = 64;

template <typename T, typename C>
int launch_cfg(const T* env, const T* top, const T* row1, const T* row2,
               const T* bot, T* out, const Meta& m, const Plan& p,
               cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  // once per (instantiation, device), not per launch
  static bool attr_set[kMaxDevices] = {};
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(pair_transfer_kernel<T, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  pair_transfer_kernel<T, C><<<static_cast<unsigned>(p.ctas), kThreads,
                               p.smem, stream>>>(env, top, row1, row2, bot,
                                                 out, m, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* env, const T* top, const T* row1, const T* row2,
           const T* bot, T* out, const int64_t* meta, cudaStream_t stream) {
  const Meta m = unpack(meta);
  if (batch_items(m) == 0 || m.nA == 0 || m.nr == 0 || m.nf == 0 ||
      m.nC == 0)
    return static_cast<int>(cudaSuccess);
  Plan p;
  if (!make_plan<T>(m, p) || p.ctas >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 8)
    return launch_cfg<T, F64Cfg>(env, top, row1, row2, bot, out, m, p,
                                 stream);
  else
    return launch_cfg<T, F32Cfg>(env, top, row1, row2, bot, out, m, p,
                                 stream);
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

// The plan a call with this meta takes: plan[0..3] = A tile, c chunk, CTAs,
// shared bytes.
int pair_transfer_plan(const int64_t* meta, int elem_bytes, int64_t* plan) {
  const Meta m = unpack(meta);
  Plan p;
  const bool ok = elem_bytes == 8 ? make_plan<double>(m, p)
                                  : make_plan<float>(m, p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.ta;
  plan[1] = p.kc;
  plan[2] = p.ctas;
  plan[3] = static_cast<int64_t>(p.smem);
  return 0;
}

}  // extern "C"
