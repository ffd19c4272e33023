"""Kernel K4's plain version (peps_tpu_torch.kernels.fermion_dress, the
fermionic sign dressing) against the JAX package, exactly: the dressed
projection equals fermion_project, the candidates fermion_candidates and
the prefix-flipped projection net * fermion_flip_mask, in every dtype,
also for a row range and for a per-chain input with stride 0 along the
physical axis (the undressing of a gradient). The dressed network's plain
contraction equals exact_coefficients of the graded state, and the
kernel's packed per-site codes reproduce the plain signs."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.fermion.convert import fermion_project as j_project
from peps_tpu.fermion.peps import FermionSpace as JSpace
from peps_tpu.fermion.tables import (fermion_candidates as j_candidates,
                                     fermion_flip_mask as j_flip_mask)
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.fermion.convert import dress_tables, fermion_project
from peps_tpu_torch.fermion.exact import exact_coefficients, snake_order
from peps_tpu_torch.fermion.peps import FermionSpace
from peps_tpu_torch.fermion.tables import (fermion_candidates,
                                           fermion_flip_mask)
from peps_tpu_torch.kernels.fermion_dress import (fermion_dress_plain,
                                                  prefix_parity)
from peps_tpu_torch.linalg import TruncParams
from torch_fermion_util import random_graded_tps

DTYPES = {"float32": np.float32, "float64": np.float64,
          "complex64": np.complex64, "complex128": np.complex128}


@pytest.mark.parametrize("shape", [(3, 3), (2, 4), (4, 3)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dressing_equals_reference_exactly(shape, dtype):
    ly, lx = shape
    rng = np.random.default_rng(ly * 10 + lx)
    sp, jsp = FermionSpace((0, 1, 1), 2, 2), JSpace((0, 1, 1), 2, 2)
    tps = random_graded_tps(rng, ly, lx, sp, "complex" in dtype) \
        .astype(DTYPES[dtype])
    cfgs = rng.integers(0, 3, size=(4, ly, lx)).astype(np.int32)
    t, c = torch.as_tensor(tps), torch.as_tensor(cfgs).long()
    both = fermion_project(t, c, sp, flags=(0, 1))
    cands = fermion_candidates(t, c, sp)
    rows = fermion_candidates(t, c, sp, 1, ly - 1)
    flip = fermion_flip_mask(c, sp, ly, lx, t.dtype)
    for b in range(4):
        jn = np.asarray(j_project(jnp.asarray(tps), jnp.asarray(cfgs[b]),
                                  jsp))
        jf = np.asarray(j_flip_mask(jnp.asarray(cfgs[b]), jsp, ly, lx,
                                    jnp.asarray(tps).dtype))
        jc = np.asarray(j_candidates(jnp.asarray(tps), jnp.asarray(cfgs[b]),
                                     jsp))
        assert np.array_equal(both[b, 0].numpy(), jn)
        assert np.array_equal(both[b, 1].numpy(), jn * jf)
        assert np.array_equal(flip[b].numpy(), jf)
        assert np.array_equal(cands[b].numpy(), jc)
        assert np.array_equal(rows[b].numpy(), jc[1:])
    # per-chain input, stride 0 along the physical axis: the dressing is its
    # own inverse, so dressing the dressed projection gives the bare one
    wide = both[:, 0].unsqueeze(3).expand(-1, -1, -1, 3, -1, -1, -1, -1)
    bare = fermion_dress_plain(wide, c, dress_tables(sp, ly, lx),
                               select_config=True, nf=1)[:, :, :, 0, 0]
    xs = torch.arange(lx)
    ref = t[torch.arange(ly)[:, None], xs[None, :]][
        torch.arange(ly)[None, :, None], xs[None, None, :], c]
    assert torch.equal(bare, ref)


def test_packed_codes_reproduce_the_plain_signs():
    """The kernel's algorithm on its packed per-site int32 codes, emulated
    with numpy: a 16-entry table over the leg parities per (site, a, f)."""
    ly, lx = 3, 4
    sp = FermionSpace((0, 1, 1, 0), 2, 2)
    tab = dress_tables(sp, ly, lx)
    codes = tab.codes().reshape(-1)
    rng = np.random.default_rng(0)
    cfg = torch.as_tensor(rng.integers(0, 4, size=(3, ly, lx)))
    ones = torch.ones(ly, lx, 4, 4, 4, 4, 4, dtype=torch.float64)
    plain = fermion_dress_plain(ones, cfg, tab)
    pp0, _ = prefix_parity(cfg, sp.phys_parity)
    pb = np.asarray(sp.bond_parity)
    q = (pb[:, None, None, None] | pb[None, :, None, None] << 1
         | pb[None, None, :, None] << 2 | pb[None, None, None, :] << 3)
    mask = sum(p << s for s, p in enumerate(sp.phys_parity))
    pg, ph = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)
    for b, y, x, a, f in itertools.product(range(3), range(ly), range(lx),
                                           range(4), range(2)):
        pi = (mask >> a) & 1
        P = int(pp0[b, y, x]) ^ f
        Pc = P ^ pi
        code = int(codes[y * lx + x])
        sc = ((code & 1) & pi) ^ ((code >> 1) & 1 & pi & P) \
            ^ ((code >> 2) & 1 & pi & Pc) ^ ((code >> 3) & 1 & P) \
            ^ ((code >> 4) & 1 & Pc)
        legc = [((code >> (11 + 4 * g)) & 1)
                ^ ((code >> (12 + 4 * g)) & pi)
                ^ ((code >> (13 + 4 * g)) & P)
                ^ ((code >> (14 + 4 * g)) & Pc) for g in range(4)]
        table = 0
        for qq in range(16):
            e = sc
            for g in range(4):
                e ^= legc[g] & (qq >> g)
            for k in range(6):
                e ^= (code >> (5 + k)) & 1 & (qq >> pg[k]) & (qq >> ph[k])
            table |= (e & 1) << qq
        sign = np.where((table >> q) & 1, -1.0, 1.0)
        assert np.array_equal(plain[b, y, x, a, f].numpy(), sign)


def _exact_amplitudes(net):
    """The plain contraction of networks net [B, Ly, Lx, u, l, d, r]
    (boundary legs at index 0), exactly, as one einsum."""
    ly, lx = net.shape[1], net.shape[2]
    letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
    v = {(y, x): next(letters) for y in range(1, ly) for x in range(lx)}
    h = {(y, x): next(letters) for y in range(ly) for x in range(1, lx)}
    ops, terms = [], []
    for y in range(ly):
        for x in range(lx):
            t = net[:, y, x]
            legs = [v.get((y, x)), h.get((y, x)), v.get((y + 1, x)),
                    h.get((y, x + 1))]
            for axis, leg in reversed(list(enumerate(legs))):
                if leg is None:
                    t = t.select(axis + 1, 0)
            ops.append(t)
            terms.append("Z" + "".join(leg for leg in legs if leg))
    return torch.einsum(",".join(terms) + "->Z", *ops)


@pytest.mark.parametrize("shape", [(2, 3), (3, 2)])
def test_dressed_contraction_equals_exact_coefficients(shape):
    """The dressed network's plain (exact) contraction equals the graded
    state's exact coefficients for every configuration."""
    ly, lx = shape
    rng = np.random.default_rng(5)
    sp = FermionSpace((0, 1, 1), 2, 2)
    tps = torch.as_tensor(random_graded_tps(rng, ly, lx, sp))
    coef = exact_coefficients(tps, sp.phys_parity, sp.bond_parity)
    order = snake_order(ly, lx)
    cfgs = torch.as_tensor(list(itertools.product(range(3),
                                                  repeat=ly * lx)))
    cfgs = cfgs.reshape(-1, ly, lx)
    psi = _exact_amplitudes(fermion_project(tps, cfgs, sp)).numpy()
    ref = np.array([coef[tuple(int(cf[y, x]) for y, x in order)]
                    for cf in cfgs])
    assert np.abs(psi - ref).max() < 1e-12 * np.abs(ref).max()
    # and the boundary-MPS contraction of a few of them
    mant, logw = bmps.amplitude(fermion_project(tps, cfgs[::97], sp), 16,
                                TruncParams(16, 1, 0.0))
    assert np.abs((mant * torch.exp(logw)).numpy() - ref[::97]).max() \
        < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("nb,slabs,per_slab", [
    (32, 36, 1024), (32, 18, 4096), (1, 36, 4096), (2, 9, 81),
    (3, 100000, 1024), (1, 1, 1)])
def test_work_units_cover_every_vector(nb, slabs, per_slab):
    """K4's work units: whole passes a unit, every vector of every slab in
    exactly one unit, whole slabs where the slabs fill the card, at most
    65535 CTAs a chain (the kernel takes the rest round-robin)."""
    from peps_tpu_torch.kernels import fermion_dress as k4
    splits, chunk = k4.work_units(nb, slabs, per_slab)
    assert chunk % k4.PASS_VECTORS == 0 and 1 <= splits <= 65535
    units = slabs * -(-per_slab // chunk)
    assert splits == min(units, 65535)
    assert -(-per_slab // chunk) * chunk >= per_slab > (
        -(-per_slab // chunk) - 1) * chunk
    if nb * slabs >= k4.TARGET_CTAS:
        assert chunk >= per_slab


def test_launch_args_meta():
    """The launch meta the wrapper packs for the card, read back on CPU
    tensors: a shared tps has chain stride 0, a per-chain one its own;
    16-byte-aligned slabs take the vector path and a misaligned view the
    value path; the output has the documented shape."""
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    tab = dress_tables(FermionSpace((0, 1, 1), 2, 2), 3, 2)
    cfg = torch.zeros(4, 3, 2, dtype=torch.int32)
    fields = ("nb", "ly", "lx", "d", "D", "y0", "ny", "select", "f0", "nf",
              "sb", "sy", "sx", "sa", "pp_mask", "bp_mask", "splits", "vec",
              "chunk")
    shared = torch.zeros(3, 2, 3, 4, 4, 4, 4)
    per = torch.zeros(4, 3, 2, 3, 4, 4, 4, 4)
    odd = torch.zeros(3 * 2 * 3 * 256 + 1)[1:].reshape(3, 2, 3, 4, 4, 4, 4)
    for t, kw, want in (
            (shared, {}, {"sb": 0, "vec": 1, "select": 0, "nf": 2}),
            (per, {"select_config": True, "nf": 1},
             {"sb": 3 * 2 * 3 * 256, "vec": 1, "select": 1, "nf": 1}),
            (odd, {"y0": 1, "ny": 2, "f0": 1, "nf": 1},
             {"vec": 0, "y0": 1, "ny": 2, "f0": 1})):
        kw = {"y0": 0, "ny": None, "select_config": False, "f0": 0,
              "nf": 2, **kw}
        _, c, _, out, meta = k4.launch_args(t, cfg, tab, **kw)
        m = dict(zip(fields, k4._META.unpack(meta)))
        assert c.dtype == torch.int64 and c.is_contiguous()
        assert m["pp_mask"] == 0b110 and m["D"] == 4 and m["d"] == 3
        for k, v in want.items():
            assert m[k] == v, (k, m[k], v)
        ny = 3 - kw["y0"] if kw["ny"] is None else kw["ny"]
        na = 1 if kw["select_config"] else 3
        assert tuple(out.shape) == (4, ny, 2, na, kw["nf"], 4, 4, 4, 4)
