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
// What bounds it: bytes. Each source value is read once a chain and each
// output written once, with a few integer operations a value. Design:
//  - The grid is (chain, unit): a unit is a whole slab, one (y, x, a) of
//    D^4 contiguous values, or, where the slabs are too few to fill the
//    card, a chunk of it (a multiple of kChunk 16-byte vectors, one
//    unrolled pass of the CTA); a chain's units past the grid's y limit
//    go round-robin. More short CTAs than the card holds resident let the
//    block scheduler balance the load (one wave of equal ranges and one
//    pass a CTA both measured slower: each CTA pays its prologue). One
//    read of a value feeds all nf flagged outputs (a, f), so the two
//    flags no longer read the source twice.
//  - The chain's configuration (one byte a site) is staged in shared
//    memory by all threads at once; the snake prefix parity of every site
//    is computed from it once a CTA, by warp 0: one ballot per 32 snake
//    positions, the words and their running parity in shared memory; a
//    site's Pp0 is then one popcount, and a projection's value a one
//    shared byte.
//  - A slab's sign depends on i only through the four leg parities
//    q(i) = p(i_u) | p(i_l) << 1 | p(i_d) << 2 | p(i_r) << 3. The leg
//    indices come from i by multiply-high division by D (exact for
//    i < 2^24, D <= 64), each parity from a D-bit bond-parity mask held in
//    a register. The slab's site terms fold into one 16-bit table T_f[q]
//    per flag, both flags packed in one register, built bit-parallel over
//    the 16 q (a few dozen instructions a thread and slab).
//  - Values move as 16-byte vectors (kUnroll in flight a thread) and the
//    sign is an XOR of each real component's sign bit. Where a slab is not
//    16-byte aligned (odd D, odd strides), the wrapper sets vec = 0 and the
//    same loop runs value by value (the tail path).
// The result is exact: a multiply by +-1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll;   // vectors an unrolled pass

struct DressMeta {
  int64_t nb, ly, lx, d, D, y0, ny, select, f0, nf;
  int64_t sb, sy, sx, sa;   // tps strides in elements (sb 0: shared)
  int64_t pp_mask;          // bit s: parity of physical state s (d <= 32)
  int64_t bp_mask;          // bit k: parity of bond index k (D <= 64)
  int64_t splits;           // CTAs a chain: its work units, <= 65535
  int64_t vec;              // 1: every slab and stride 16-byte aligned
  int64_t chunk;            // vectors (values) a work unit, kChunk-aligned
};
constexpr int kMetaInts = 19;

// The 16-bit table E(q) of one slab: bit q is the sign exponent of the
// values whose four leg parities are q. Bit-parallel over the 16 q: leg
// g's parity over q is the mask kLeg[g], a leg pair's the AND of two.
__device__ __forceinline__ unsigned sign_table(int code, int pi, int pp) {
  constexpr unsigned kLeg[4] = {0xAAAAu, 0xCCCCu, 0xF0F0u, 0xFF00u};
  // leg pairs (u,l) (u,d) (u,r) (l,d) (l,r) (d,r): bits 5..10
  constexpr int pg[6] = {0, 0, 0, 1, 1, 2};
  constexpr int ph[6] = {1, 2, 3, 2, 3, 3};
  const int pc = pp ^ pi;
  const int sc = ((code & pi) ^ ((code >> 1) & pi & pp) ^
                  ((code >> 2) & pi & pc) ^ ((code >> 3) & pp) ^
                  ((code >> 4) & pc)) & 1;
  unsigned table = sc ? 0xFFFFu : 0u;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int c = code >> (11 + 4 * g);
    const int legc = ((c & 1) ^ ((c >> 1) & pi) ^ ((c >> 2) & pp) ^
                      ((c >> 3) & pc)) & 1;
    table ^= legc ? kLeg[g] : 0u;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
    table ^= ((code >> (5 + k)) & 1) ? (kLeg[pg[k]] & kLeg[ph[k]]) : 0u;
  return table;
}

// q(i) of the value at flat index i < D^4 of a slab.
__device__ __forceinline__ unsigned leg_bits(uint32_t i, uint32_t D,
                                             uint32_t magic, uint64_t bp) {
  const uint32_t i1 = __umulhi(i, magic);
  const uint32_t ir = i - i1 * D;
  const uint32_t i2 = __umulhi(i1, magic);
  const uint32_t id = i1 - i2 * D;
  const uint32_t iu = __umulhi(i2, magic);
  const uint32_t il = i2 - iu * D;
  return static_cast<unsigned>(((bp >> iu) & 1) | (((bp >> il) & 1) << 1) |
                               (((bp >> id) & 1) << 2) |
                               (((bp >> ir) & 1) << 3));
}

// Flip the sign bits of the real components of a 16-byte vector: EW 32-bit
// words a value, RW words a real component; bit e of `signs` negates
// value e.
template <int EW, int RW>
__device__ __forceinline__ uint4 flip(uint4 v, unsigned signs) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k % RW == RW - 1) w[k] ^= ((signs >> (k / EW)) & 1u) << 31;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int EW, int RW>
__global__ void __launch_bounds__(kThreads)
dress_kernel(const uint32_t* __restrict__ tps,
             const int64_t* __restrict__ cfg, const int* __restrict__ codes,
             uint32_t* __restrict__ out, DressMeta m) {
  extern __shared__ uint32_t prefix_words[];   // [2 nwords], then npos bytes
  constexpr int kVec = 4 / EW;                 // values a 16-byte vector
  const int64_t b = blockIdx.x;
  const int64_t lx = m.lx;
  const int64_t* c_b = cfg + b * m.ly * lx;

  // the chain's configuration of rows [0, y0 + ny), one byte a site, read
  // by all threads at once; then the snake prefix parity, one ballot per
  // 32 positions by warp 0: word w bit j is the parity at snake position
  // 32 w + j, pre[w] the parity of all positions before the word
  const int64_t npos = (m.y0 + m.ny) * lx;
  const int64_t nwords = (npos + 31) / 32;
  uint32_t* words = prefix_words;
  uint32_t* pre = prefix_words + nwords;
  uint8_t* cfg_s = reinterpret_cast<uint8_t*>(pre + nwords);
  for (int64_t p = threadIdx.x; p < npos; p += kThreads)
    cfg_s[p] = static_cast<uint8_t>(c_b[p]);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned carry = 0;
    for (int64_t w = 0; w < nwords; ++w) {
      const int64_t s = w * 32 + lane;
      int bit = 0;
      if (s < npos) {
        const int64_t yy = s / lx, kk = s - yy * lx;
        const int64_t xx = (yy & 1) ? (lx - 1 - kk) : kk;
        bit = static_cast<int>((m.pp_mask >> cfg_s[yy * lx + xx]) & 1);
      }
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) {
        words[w] = word;
        pre[w] = carry;
      }
      carry ^= __popc(word) & 1u;
    }
  }
  __syncthreads();

  const int64_t na = m.select ? 1 : m.d;
  const int64_t per_row = lx * na;
  const int64_t slabs = m.ny * per_row;
  const uint32_t D = static_cast<uint32_t>(m.D);
  const uint32_t magic =
      static_cast<uint32_t>(((uint64_t{1} << 32) + D - 1) / D);
  const uint64_t bp = static_cast<uint64_t>(m.bp_mask);
  const int64_t d4 = m.D * m.D * m.D * m.D;
  const int nf = static_cast<int>(m.nf);

  // work units: chunks of m.chunk vectors (values on the value path) of a
  // slab; CTA (b, s) takes units s, s + gridDim.y, ... of chain b
  const int64_t unit = m.vec ? d4 / kVec : d4;   // vectors or values a slab
  const int64_t chunks = (unit + m.chunk - 1) / m.chunk;
  for (int64_t t = blockIdx.y; t < slabs * chunks; t += gridDim.y) {
    const int64_t k = t / chunks;
    const int64_t lo = (t - k * chunks) * m.chunk;
    const int64_t hi = lo + m.chunk < unit ? lo + m.chunk : unit;
    const int64_t y = m.y0 + k / per_row;
    const int64_t rest = k - (y - m.y0) * per_row;
    const int64_t x = rest / na;
    const int64_t a = m.select ? cfg_s[y * lx + x] : rest - x * na;
    const int pi = static_cast<int>((m.pp_mask >> a) & 1);
    const int64_t s = y * lx + ((y & 1) ? (lx - 1 - x) : x);
    const uint32_t below = (1u << (s & 31)) - 1u;
    const int pp0 = static_cast<int>(
        (pre[s >> 5] ^ __popc(words[s >> 5] & below)) & 1u);
    const int code = codes[y * lx + x];
    const int f0 = static_cast<int>(m.f0);
    // T_{f0} in bits 0-15, T_{f0+1} in bits 16-31
    const unsigned tab = sign_table(code, pi, pp0 ^ f0) |
                         (sign_table(code, pi, pp0 ^ f0 ^ 1) << 16);
    const uint32_t* src =
        tps + EW * (b * m.sb + y * m.sy + x * m.sx + a * m.sa);
    uint32_t* dst = out + EW * (b * slabs + k) * nf * d4;

    if (m.vec) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* o4 = reinterpret_cast<uint4*>(dst);
      for (int64_t v0 = lo + threadIdx.x; v0 < hi; v0 += kThreads * kUnroll) {
        uint4 r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t v = v0 + u * kThreads;
          if (v < hi) r[u] = __ldg(s4 + v);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t v = v0 + u * kThreads;
          if (v >= hi) break;
          unsigned s0 = 0, s1 = 0;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const unsigned q = leg_bits(
                static_cast<uint32_t>(v * kVec + e), D, magic, bp);
            s0 |= ((tab >> q) & 1u) << e;
            s1 |= ((tab >> (16 + q)) & 1u) << e;
          }
          o4[v] = flip<EW, RW>(r[u], s0);
          if (nf == 2) o4[unit + v] = flip<EW, RW>(r[u], s1);
        }
      }
    } else {
      for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
        const unsigned q = leg_bits(static_cast<uint32_t>(i), D, magic, bp);
        uint32_t w[EW];
#pragma unroll
        for (int k2 = 0; k2 < EW; ++k2) w[k2] = __ldg(src + EW * i + k2);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (f == nf) break;
          const uint32_t sign = ((tab >> (16 * f + q)) & 1u) << 31;
#pragma unroll
          for (int k2 = 0; k2 < EW; ++k2)
            dst[EW * (f * d4 + i) + k2] =
                (k2 % RW == RW - 1) ? (w[k2] ^ sign) : w[k2];
        }
      }
    }
  }
}

template <int EW, int RW>
int launch(const void* tps, const int64_t* cfg, const int* codes, void* out,
           const int64_t* meta, void* stream) {
  DressMeta m;
  int64_t* f = &m.nb;
  for (int k = 0; k < kMetaInts; ++k) f[k] = meta[k];
  if (m.nb <= 0 || m.ny <= 0 || m.lx <= 0) return 0;
  if (m.nb >= (int64_t{1} << 31) || m.splits < 1 || m.splits > 65535 ||
      m.chunk < 1 || m.chunk % kChunk != 0 ||
      m.D < 1 || m.D > 64 || m.d < 1 || m.d > 32 || m.nf < 1 ||
      m.f0 + m.nf > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t npos = (m.y0 + m.ny) * m.lx;
  const size_t smem = static_cast<size_t>(2 * ((npos + 31) / 32)) *
                          sizeof(uint32_t) + static_cast<size_t>(npos);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m.nb),
                  static_cast<unsigned>(m.splits));
  dress_kernel<EW, RW><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tps), cfg, codes,
      static_cast<uint32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fermion_dress_f32(const void* tps, const int64_t* cfg, const int* codes,
                      void* out, const int64_t* meta, void* stream) {
  return launch<1, 1>(tps, cfg, codes, out, meta, stream);
}

int fermion_dress_f64(const void* tps, const int64_t* cfg, const int* codes,
                      void* out, const int64_t* meta, void* stream) {
  return launch<2, 2>(tps, cfg, codes, out, meta, stream);
}

int fermion_dress_c64(const void* tps, const int64_t* cfg, const int* codes,
                      void* out, const int64_t* meta, void* stream) {
  return launch<2, 1>(tps, cfg, codes, out, meta, stream);
}

int fermion_dress_c128(const void* tps, const int64_t* cfg,
                       const int* codes, void* out, const int64_t* meta,
                       void* stream) {
  return launch<4, 2>(tps, cfg, codes, out, meta, stream);
}

}  // extern "C"
