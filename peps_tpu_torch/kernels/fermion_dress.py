"""K4: the fermionic sign dressing of a graded TPS, and its plain PyTorch
version.

    out[b, y, x, a, f, i] = tps[b, y, x, a, i] * (-1)^E(b, y, x, a, f, i)

with i = (i_u, i_l, i_d, i_r) the virtual legs and E the XOR of
  - the site's scalar term in (pi(a), Pp, Pc), Pp = Pp0[b, y, x] ^ f the
    snake prefix parity before the site (flipped by f) and Pc = Pp ^ pi(a);
  - the site's static leg-pair bits p(i_g) p(i_h);
  - per leg g, the bond parity p(i_g) times that leg's coefficient in
    (1, pi, Pp, Pc).
The coefficients are the static tables of
:func:`peps_tpu_torch.fermion.convert._static_tables` (:class:`DressTables`).
This is what ``peps_tpu/fermion/convert.py:fermion_project`` and
``peps_tpu/fermion/tables.py:fermion_candidates`` / ``fermion_flip_mask``
compute; XLA fused their elementwise chains on the TPU.

Two modes, one kernel: every value a of the rows [y0, y0+ny) (the
candidates, ``select_config=False``), or the configuration's value a =
config[b, y, x] (the projection, ``select_config=True``); the flags f run
over [f0, f0+nf). The output is [B, ny, Lx, na, nf, D, D, D, D], na = d or
1. tps is [Ly, Lx, d, D^4] (shared by every chain) or [B, Ly, Lx, d, D^4];
its last four axes must be contiguous, the others may have any stride
(stride 0 along a undresses a gradient: the dressing is its own inverse).
Pp0 is computed in the kernel from config [B, Ly, Lx].

On a CPU tensor :func:`fermion_dress` runs the plain version; on a CUDA
tensor it launches the kernel (``csrc/fermion_dress.cu``) or raises. The
wrapper keeps its host work small, since a call moves a few tens of
microseconds of data: the device statics are cached by the tables
object's identity, the launch meta is one ``struct.pack``, and the device
context is entered only when the tensor is not on the current device.
"""
from __future__ import annotations

import struct
from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

ENTRIES = {torch.float32: "fermion_dress_f32",
           torch.float64: "fermion_dress_f64",
           torch.complex64: "fermion_dress_c64",
           torch.complex128: "fermion_dress_c128"}
META_INTS = 19
SCALAR_TERMS = ("pi", "pi_pp", "pi_pc", "pp", "pc")
PAIR_LEGS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))   # u l d r
LEG_TERMS = ("static", "pi", "pp", "pc")


class DressTables(NamedTuple):
    """Static 0/1 dressing coefficients of an Ly x Lx lattice: scalar
    [Ly, Lx, 5] (SCALAR_TERMS), pairs [Ly, Lx, 6] (PAIR_LEGS), legs
    [Ly, Lx, 4, 4] (leg u, l, d, r x LEG_TERMS), with the physical and bond
    parities."""
    scalar: np.ndarray
    pairs: np.ndarray
    legs: np.ndarray
    phys_parity: tuple
    bond_parity: tuple

    def codes(self) -> np.ndarray:
        """One int32 per site, as the kernel reads it: bits 0-4 the scalar
        terms, 5-10 the leg pairs, 11 + 4g + k leg g's term k."""
        code = np.zeros(self.scalar.shape[:2], dtype=np.int64)
        for k in range(5):
            code |= self.scalar[..., k].astype(np.int64) << k
        for k in range(6):
            code |= self.pairs[..., k].astype(np.int64) << (5 + k)
        for g in range(4):
            for k in range(4):
                code |= self.legs[..., g, k].astype(np.int64) << (11 + 4 * g + k)
        return code.astype(np.int32)


def prefix_parity(config, phys_parity):
    """(Pp, Pc) [..., Ly, Lx] int64: the configuration's cumulative parity
    along the snake order before / including each site."""
    ly, lx = config.shape[-2:]
    pp = torch.as_tensor(phys_parity, dtype=torch.int64,
                         device=config.device)
    pi = pp[config.long()]
    odd = (torch.arange(ly, device=config.device) % 2 == 1)[:, None]
    snake = torch.where(odd, pi.flip(-1), pi).flatten(-2)
    cur = torch.cumsum(snake, -1) % 2
    prev = cur - snake % 2
    prev = torch.remainder(prev, 2)

    def unflatten(v):
        m = v.reshape(*v.shape[:-1], ly, lx)
        return torch.where(odd, m.flip(-1), m)

    return unflatten(prev), unflatten(cur)


def _leg_parity(bond_parity, device):
    """p(i_u), p(i_l), p(i_d), p(i_r) as int64 tensors broadcasting over
    [D, D, D, D]."""
    pb = torch.as_tensor(bond_parity, dtype=torch.int64, device=device)
    D = pb.shape[0]
    return [pb.reshape([D if j == g else 1 for j in range(4)])
            for g in range(4)]


def _operands(tps, config, y0, ny, select_config, d):
    """(values [B, ny, Lx, na, D^4-shaped], a [B or 1, ny, Lx, na]) of the
    plain version: the tps slabs of each output row."""
    b = config.shape[0]
    rows = slice(y0, y0 + ny)
    t = tps[..., rows, :, :, :, :, :, :]
    if t.dim() == 7:
        t = t.unsqueeze(0)
    if select_config:
        a = config[:, rows].long()[..., None]               # [B, ny, Lx, 1]
        idx = a.reshape(*a.shape, 1, 1, 1, 1).expand(
            -1, -1, -1, -1, *t.shape[-4:])
        vals = t.expand(b, *t.shape[1:]).gather(3, idx)
    else:
        a = torch.arange(d, device=config.device).expand(
            1, ny, t.shape[2], d)
        vals = t
    return vals, a


def fermion_dress_plain(tps, config, tables: DressTables, y0: int = 0,
                        ny: int | None = None, select_config: bool = False,
                        f0: int = 0, nf: int = 2):
    """The plain PyTorch version: the reference's elementwise chain (scalar
    sign, static pair masks, per-leg masks) on the rows [y0, y0+ny)."""
    ly, lx = config.shape[-2:]
    ny = ly - y0 if ny is None else ny
    if not 0 <= y0 <= y0 + ny <= ly:
        raise ValueError(f"fermion_dress: rows [{y0}, {y0 + ny}) of {ly}")
    d = tps.shape[-5]
    dev = config.device
    vals, a = _operands(tps, config, y0, ny, select_config, d)
    pp = torch.as_tensor(tables.phys_parity, dtype=torch.int64, device=dev)
    pi = pp[a][..., None]                                    # [.., na, 1]
    pp0, _ = prefix_parity(config, tables.phys_parity)
    f = torch.arange(f0, f0 + nf, device=dev)
    p_prev = (pp0[:, y0:y0 + ny, :, None, None] + f) % 2     # [B,ny,Lx,1,nf]
    p_cur = (p_prev + pi) % 2

    def site(arr):
        return torch.as_tensor(arr[y0:y0 + ny], dtype=torch.int64,
                               device=dev)[None, :, :, None, None]

    sc, pr, lg = (site(tables.scalar), site(tables.pairs),
                  site(tables.legs))
    terms = (pi, pi * p_prev, pi * p_cur, p_prev, p_cur)
    e = sum(sc[..., k] * terms[k] for k in range(5)) % 2     # [B,ny,Lx,na,nf]
    legp = _leg_parity(tables.bond_parity, dev)
    expo = e[..., None, None, None, None]
    for k, (g, h) in enumerate(PAIR_LEGS):
        expo = expo + pr[..., k, None, None, None, None] * legp[g] * legp[h]
    for g in range(4):
        coef = (lg[..., g, 0] + lg[..., g, 1] * pi + lg[..., g, 2] * p_prev
                + lg[..., g, 3] * p_cur) % 2
        expo = expo + coef[..., None, None, None, None] * legp[g]
    sign = (1 - 2 * (expo % 2)).to(vals.real.dtype)
    return vals[:, :, :, :, None] * sign


def entry_name(dtype) -> str:
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA fermion_dress takes {list(ENTRIES)}, got "
                        f"{dtype}")
    return ENTRIES[dtype]


_STATIC: dict = {}
_META = struct.Struct(f"{META_INTS}q")
PASS_VECTORS = 1024  # kChunk of the source: one unrolled pass of a CTA
TARGET_CTAS = 132 * 8  # the H100's SMs x 8: fewer slabs are split


def _static_device(tables: DressTables, device):
    """(codes int32 [Ly*Lx] on the device, pp_mask, bp_mask) of ``tables``,
    cached per tables object and device: the key is the object's id, and a
    hit holds the object itself, so a recycled id is not mistaken for it."""
    key = (id(tables), device)
    hit = _STATIC.get(key)
    if hit is None or hit[0] is not tables:
        pp_mask = sum(int(p) << s for s, p in enumerate(tables.phys_parity))
        bp_mask = sum(int(p) << s for s, p in enumerate(tables.bond_parity))
        hit = _STATIC[key] = (
            tables, torch.as_tensor(tables.codes().reshape(-1),
                                    device=device), pp_mask, bp_mask)
    return hit[1:]


def work_units(nb: int, slabs: int, per_slab: int):
    """(CTAs a chain, vectors a CTA) of a launch over nb chains of ``slabs``
    slabs of ``per_slab`` 16-byte vectors (values where the slabs are not
    aligned): a whole slab a CTA, split into chunks of whole passes
    (PASS_VECTORS each) only where the slabs do not reach TARGET_CTAS;
    at most 65535 CTAs a chain (the grid's y limit; the kernel takes the
    rest round-robin)."""
    passes = -(-per_slab // PASS_VECTORS)
    chunks = max(1, min(passes, -(-TARGET_CTAS // max(nb * slabs, 1))))
    chunk = -(-passes // chunks) * PASS_VECTORS
    return max(1, min(slabs * -(-per_slab // chunk), 65535)), chunk


def launch_args(tps, config, tables: DressTables, y0: int, ny: int | None,
                select_config: bool, f0: int, nf: int):
    """(tps, config, codes, out, meta) of one kernel call: the operands as
    the kernel reads them (tps [Ly, Lx, d, ...] shared or [1 or B, Ly, Lx,
    d, ...] with its last four axes contiguous, config int64 contiguous,
    the site codes), the output allocated, and the packed launch meta
    (``DressMeta`` in the source). Raises on what the kernel does not
    take."""
    ly, lx = config.shape[-2:]
    ny = ly - y0 if ny is None else ny
    b = config.shape[0]
    shape = tps.shape
    d, D = shape[-5], shape[-1]
    if shape[-4:] != (D, D, D, D) or tuple(shape[-7:-5]) != (ly, lx):
        raise ValueError(f"fermion_dress: tps {tuple(shape)} against a "
                         f"{ly}x{lx} configuration")
    if D > 64 or d > 32 or not 0 <= y0 <= y0 + ny <= ly or nf < 1 \
            or f0 + nf > 2 or (y0 + ny) * lx > 39000:
        raise ValueError(f"fermion_dress: D={D}, d={d}, rows [{y0}, "
                         f"{y0 + ny}) of width {lx}, flags [{f0}, "
                         f"{f0 + nf})")
    nd = len(shape)
    if nd not in (7, 8) or (nd == 8 and shape[0] not in (1, b)):
        raise ValueError(f"fermion_dress: tps {tuple(shape)} for {b} chains")
    # a lazily conjugated or negated view holds other values than its data
    if tps.is_conj() or tps.is_neg():
        tps = tps.resolve_conj().resolve_neg()
    d4 = D ** 4
    st = tps.stride()
    if st[-4:] != (D ** 3, D ** 2, D, 1):
        tps = tps.contiguous()
        st = tps.stride()
    sb = st[0] if nd == 8 and shape[0] > 1 else 0
    sy, sx, sa = st[-7:-4]
    dev = tps.device
    if config.dtype != torch.int64 or config.device != dev \
            or not config.is_contiguous():
        config = config.to(device=dev, dtype=torch.int64).contiguous()
    codes, pp_mask, bp_mask = _static_device(tables, dev)
    na = 1 if select_config else d
    out = torch.empty(b, ny, lx, na, nf, D, D, D, D, dtype=tps.dtype,
                      device=dev)
    es = tps.element_size()
    vec = int(all(v * es % 16 == 0 for v in (sb, sy, sx, sa, d4))
              and tps.data_ptr() % 16 == 0)
    splits, chunk = work_units(b, ny * lx * na,
                               d4 * es // 16 if vec else d4)
    meta = _META.pack(b, ly, lx, d, D, y0, ny, int(select_config), f0, nf,
                      sb, sy, sx, sa, pp_mask, bp_mask, splits, vec, chunk)
    return tps, config, codes, out, meta


def fermion_dress(tps, config, tables: DressTables, y0: int = 0,
                  ny: int | None = None, select_config: bool = False,
                  f0: int = 0, nf: int = 2):
    """K4 wrapper. CPU tensors: plain version. CUDA tensors: the kernel.
    Returns [B, ny, Lx, na, nf, D, D, D, D] (na = 1 with select_config,
    else d)."""
    dev = tps.device
    if dev.type == "cpu":
        return fermion_dress_plain(tps, config, tables, y0, ny,
                                   select_config, f0, nf)
    if dev.type != "cuda":
        raise RuntimeError(f"fermion_dress runs on cpu or cuda, not {dev}")
    from peps_tpu_torch.kernels._build import check, cuda_library
    name = entry_name(tps.dtype)
    fn = getattr(cuda_library().lib, name)
    tps, config, codes, out, meta = launch_args(
        tps, config, tables, y0, ny, select_config, f0, nf)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with (nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        check(fn(tps.data_ptr(), config.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), meta, stream))
    fermion_dress.launches += 1
    return out


fermion_dress.launches = 0
