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
// What bounds it on the H100: at the main-path shapes (chi = 32, D = 8,
// c in {32, 40}) one item is ~11 MFLOP against ~0.1 MB of operands, so the
// transfer is compute-bound on the FP32/FP64 CUDA cores, while the einsum
// chain it replaces writes two chi^2 D^2 intermediates per item to device
// memory. Design: one block per (item n, tile of TA output top indices A).
// The block keeps the top tile [a,u,TA], the site [u,l,d,r] and both
// intermediates T1[TA,l,u,c] = env.top and T2[TA,d,r,c] = T1.site in shared
// memory; only the result goes back to device memory. env and bot are read
// from device memory (L2) once per block, each value feeding a register
// tile of TA*8 (env) or 8 (bot) multiply-adds, and the shared-memory
// operands of each inner loop are warp-wide broadcasts. TA is the largest of
// 4, 2, 1 whose shared memory fits the 227 KB a block may use (TA = 4 at
// every main-path shape, 205 KB at c = 40 in f64). No tensor cores (wgmma)
// and no TMA yet: that is tuning work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 4;
constexpr int kUC = 8;     // u register tile of step 1
constexpr int kDC = 4;     // d register tile of step 2
constexpr int kRC = 8;     // r register tile of steps 2 and 3
constexpr size_t kSmemLimit = 232448;

struct Meta {
  int64_t nb[kMaxBatch];              // batch sizes, padded with 1
  int64_t se[kMaxBatch + 3];          // env strides: batch..., a, l, c
  int64_t st[kMaxBatch + 3];          // top strides: batch..., a, u, A
  int64_t ss[kMaxBatch + 4];          // site strides: batch..., u, l, d, r
  int64_t sb[kMaxBatch + 3];          // bot strides: batch..., c, d, C
  int na, nl, nc, nu, nA, nd, nr, nC;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <typename T>
size_t smem_bytes(const Meta& m, int ta) {
  const size_t nu_p = round_up(m.nu, kUC);
  const size_t nd_p = round_up(m.nd, kDC), nr_p = round_up(m.nr, kRC);
  return sizeof(T) * (m.na * nu_p * ta + m.nu * m.nl * nd_p * nr_p +
                      static_cast<size_t>(ta) * m.nl * m.nu * m.nc +
                      static_cast<size_t>(ta) * m.nd * m.nr * m.nc);
}

template <typename T, int TA>
__global__ void __launch_bounds__(kThreads)
col_transfer_kernel(const T* __restrict__ env, const T* __restrict__ top,
                    const T* __restrict__ site, const T* __restrict__ bot,
                    T* __restrict__ out, const Meta m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nu_p = round_up(m.nu, kUC);
  const int nd_p = round_up(m.nd, kDC), nr_p = round_up(m.nr, kRC);
  T* top_s = reinterpret_cast<T*>(smem_raw);         // [a][u_p][TA]
  T* site_s = top_s + m.na * nu_p * TA;               // [u][l][d_p][r_p]
  T* t1 = site_s + m.nu * m.nl * nd_p * nr_p;         // [TA][l][u][c]
  T* t2 = t1 + TA * m.nl * m.nu * m.nc;               // [TA][d][r][c]

  const int tid = threadIdx.x;
  const int n_at = (m.nA + TA - 1) / TA;
  const int64_t item = blockIdx.x / n_at;
  const int A0 = static_cast<int>(blockIdx.x % n_at) * TA;

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
  const T* e = env + off_e;
  const T* tp = top + off_t;
  const T* s = site + off_s;
  const T* b = bot + off_b;
  const int64_t* se = m.se + kMaxBatch;
  const int64_t* st = m.st + kMaxBatch;
  const int64_t* ss = m.ss + kMaxBatch;
  const int64_t* sb = m.sb + kMaxBatch;

  // stage the top tile and the site, zero-padded to the register tiles
  for (int i = tid; i < m.na * nu_p * TA; i += kThreads) {
    const int ta = i % TA;
    const int u = (i / TA) % nu_p;
    const int a = i / (TA * nu_p);
    const int A = A0 + ta;
    top_s[i] = (u < m.nu && A < m.nA)
                   ? tp[a * st[0] + u * st[1] + A * st[2]] : T(0);
  }
  for (int i = tid; i < m.nu * m.nl * nd_p * nr_p; i += kThreads) {
    const int r = i % nr_p;
    const int d = (i / nr_p) % nd_p;
    const int l = (i / (nr_p * nd_p)) % m.nl;
    const int u = i / (nr_p * nd_p * m.nl);
    site_s[i] = (d < m.nd && r < m.nr)
                    ? s[u * ss[0] + l * ss[1] + d * ss[2] + r * ss[3]] : T(0);
  }
  __syncthreads();

  // step 1: T1[ta,l,u,c] = sum_a env[a,l,c] top[a,u,A0+ta]
  // lanes run over c (coalesced env reads); the top tile is a broadcast
  const int n_uc = nu_p / kUC;
  for (int it = tid; it < m.nc * m.nl * n_uc; it += kThreads) {
    const int c = it % m.nc;
    const int l = (it / m.nc) % m.nl;
    const int u0 = (it / (m.nc * m.nl)) * kUC;
    T acc[kUC][TA];
#pragma unroll
    for (int uu = 0; uu < kUC; ++uu)
#pragma unroll
      for (int ta = 0; ta < TA; ++ta) acc[uu][ta] = T(0);
    const T* ep = e + l * se[1] + c * se[2];
    for (int a = 0; a < m.na; ++a) {
      const T ev = ep[a * se[0]];
      const T* tv = top_s + (a * nu_p + u0) * TA;
#pragma unroll
      for (int uu = 0; uu < kUC; ++uu)
#pragma unroll
        for (int ta = 0; ta < TA; ++ta) acc[uu][ta] += ev * tv[uu * TA + ta];
    }
#pragma unroll
    for (int uu = 0; uu < kUC; ++uu) {
      const int u = u0 + uu;
      if (u < m.nu) {
#pragma unroll
        for (int ta = 0; ta < TA; ++ta)
          t1[((ta * m.nl + l) * m.nu + u) * m.nc + c] = acc[uu][ta];
      }
    }
  }
  __syncthreads();

  // step 2: T2[ta,d,r,c] = sum_{l,u} T1[ta,l,u,c] site[u,l,d,r]
  // lanes run over c; the site tile is a broadcast
  const int n_dc = nd_p / kDC, n_rc = nr_p / kRC;
  for (int it = tid; it < m.nc * n_dc * n_rc * TA; it += kThreads) {
    const int c = it % m.nc;
    const int r0 = ((it / m.nc) % n_rc) * kRC;
    const int d0 = ((it / (m.nc * n_rc)) % n_dc) * kDC;
    const int ta = it / (m.nc * n_rc * n_dc);
    T acc[kDC][kRC];
#pragma unroll
    for (int dd = 0; dd < kDC; ++dd)
#pragma unroll
      for (int rr = 0; rr < kRC; ++rr) acc[dd][rr] = T(0);
    const T* t1p = t1 + ta * m.nl * m.nu * m.nc + c;
    for (int l = 0; l < m.nl; ++l) {
      for (int u = 0; u < m.nu; ++u) {
        const T tv = t1p[(l * m.nu + u) * m.nc];
        const T* sp = site_s + ((u * m.nl + l) * nd_p + d0) * nr_p + r0;
#pragma unroll
        for (int dd = 0; dd < kDC; ++dd)
#pragma unroll
          for (int rr = 0; rr < kRC; ++rr) acc[dd][rr] += tv * sp[dd * nr_p + rr];
      }
    }
#pragma unroll
    for (int dd = 0; dd < kDC; ++dd) {
      const int d = d0 + dd;
#pragma unroll
      for (int rr = 0; rr < kRC; ++rr) {
        const int r = r0 + rr;
        if (d < m.nd && r < m.nr)
          t2[((ta * m.nd + d) * m.nr + r) * m.nc + c] = acc[dd][rr];
      }
    }
  }
  __syncthreads();

  // step 3: out[A0+ta, r, C] = sum_{c,d} T2[ta,d,r,c] bot[c,d,C]
  // lanes run over C (coalesced bot reads and output writes)
  for (int it = tid; it < m.nC * n_rc * TA; it += kThreads) {
    const int C = it % m.nC;
    const int r0 = ((it / m.nC) % n_rc) * kRC;
    const int ta = it / (m.nC * n_rc);
    const int A = A0 + ta;
    if (A >= m.nA) continue;
    T acc[kRC];
#pragma unroll
    for (int rr = 0; rr < kRC; ++rr) acc[rr] = T(0);
    const T* bp = b + C * sb[2];
    const T* t2p = t2 + ta * m.nd * m.nr * m.nc;
    for (int c = 0; c < m.nc; ++c) {
      for (int d = 0; d < m.nd; ++d) {
        const T bv = bp[c * sb[0] + d * sb[1]];
        const T* tv = t2p + (d * m.nr + r0) * m.nc + c;
#pragma unroll
        for (int rr = 0; rr < kRC; ++rr)
          if (r0 + rr < m.nr) acc[rr] += tv[rr * m.nc] * bv;
      }
    }
    T* o = out + ((item * m.nA + A) * m.nr) * m.nC + C;
#pragma unroll
    for (int rr = 0; rr < kRC; ++rr)
      if (r0 + rr < m.nr) o[(r0 + rr) * m.nC] = acc[rr];
  }
}

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

template <typename T, int TA>
int launch_tile(const T* env, const T* top, const T* site, const T* bot,
                T* out, const Meta& m, int64_t items, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(m, TA);
  const int64_t blocks = items * ((m.nA + TA - 1) / TA);
  if (blocks >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      col_transfer_kernel<T, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  col_transfer_kernel<T, TA><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(env, top, site, bot, out, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* env, const T* top, const T* site, const T* bot, T* out,
           const int64_t* meta, cudaStream_t stream) {
  const Meta m = unpack(meta);
  int64_t items = 1;
  for (int k = 0; k < kMaxBatch; ++k) items *= m.nb[k];
  if (items == 0 || m.nA == 0) return static_cast<int>(cudaSuccess);
  if (smem_bytes<T>(m, 4) <= kSmemLimit)
    return launch_tile<T, 4>(env, top, site, bot, out, m, items, stream);
  if (smem_bytes<T>(m, 2) <= kSmemLimit)
    return launch_tile<T, 2>(env, top, site, bot, out, m, items, stream);
  if (smem_bytes<T>(m, 1) <= kSmemLimit)
    return launch_tile<T, 1>(env, top, site, bot, out, m, items, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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

const char* peps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
