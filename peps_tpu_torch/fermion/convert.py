"""Fermionic projection: graded TPS + configuration -> DRESSED bosonic
network (port of ``peps_tpu/fermion/convert.py``).

    <S|psi>  =  plain bosonic contraction of  M~[y,x] ,
    M~[y,x]  =  tps[y, x, S[y,x]] * (-1)^{E(y,x)} ,

where E is a GF(2) form in pi (the physical parity of the selected
component), the virtual leg parities, and the snake-order PREFIX parity of
the configuration. The coefficient table is the reference's (solved
against the canonical graded contraction, :mod:`~peps_tpu_torch.fermion.
exact`). The dressed network is plain bosonic, so the whole bosonic
contraction stack (BMPS, K1, K3, the ratio tables) applies unchanged.

The dressing runs on kernel K4 (:mod:`peps_tpu_torch.kernels.fermion_dress`)
batched over chains: config [nc, Ly, Lx].
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from peps_tpu_torch.kernels.fermion_dress import (PAIR_LEGS, DressTables,
                                                  fermion_dress,
                                                  prefix_parity)

# class = (y%2)*4 + (x==0)*2 + (x==lx-1); monomials over
# {pi, u, l, d, r, Pp (prefix parity before site), Pc (including site)}
_CLS_TERMS = {
    0: (("pi",), ("l",), ("pi", "u"), ("pi", "l"), ("pi", "d"),
        ("u", "l"), ("u", "d"), ("l", "d"), ("u", "Pp")),
    1: (("l",), ("u", "l"), ("pi", "Pp"), ("l", "Pp")),
    2: (("pi",), ("pi", "u"), ("pi", "d"), ("u", "d")),
    3: (),
    4: (("l",), ("pi", "d"), ("u", "l"), ("u", "d"), ("l", "d"),
        ("d", "Pp")),
    5: (("pi",), ("u", "l"), ("pi", "Pp"), ("l", "Pp")),
    6: (("u", "d"),),
    7: (),
}

_LEGS = ("u", "l", "d", "r")
_SCALAR = {("pi",): 0, ("pi", "Pp"): 1, ("pi", "Pc"): 2, ("Pp",): 3,
           ("Pc",): 4}
_LEG_TERM = {"pi": 1, "Pp": 2, "Pc": 3}


def _site_class(y, x, lx):
    return (y % 2) * 4 + (1 if x == 0 else 0) * 2 + (1 if x == lx - 1 else 0)


@lru_cache(maxsize=None)
def _static_tables(ly, lx, bond_parity, phys_parity=(0, 1)) -> DressTables:
    """The static 0/1 dressing coefficients of every site (K4's
    :class:`~peps_tpu_torch.kernels.fermion_dress.DressTables`)."""
    scalar = np.zeros((ly, lx, 5), dtype=np.int64)
    pairs = np.zeros((ly, lx, 6), dtype=np.int64)
    legs = np.zeros((ly, lx, 4, 4), dtype=np.int64)
    axis = {g: k for k, g in enumerate(_LEGS)}
    for y in range(ly):
        for x in range(lx):
            for term in _CLS_TERMS[_site_class(y, x, lx)]:
                if term in _SCALAR:
                    scalar[y, x, _SCALAR[term]] ^= 1
                elif len(term) == 1 and term[0] in _LEGS:
                    legs[y, x, axis[term[0]], 0] ^= 1
                elif term[0] == "pi" and term[1] in _LEGS:
                    legs[y, x, axis[term[1]], 1] ^= 1
                elif term[0] in _LEGS and term[1] in _LEG_TERM:
                    legs[y, x, axis[term[0]], _LEG_TERM[term[1]]] ^= 1
                elif term[0] in _LEGS and term[1] in _LEGS:
                    pair = (axis[term[0]], axis[term[1]])
                    pairs[y, x, PAIR_LEGS.index(pair)] ^= 1
                else:
                    raise AssertionError(term)
    return DressTables(scalar, pairs, legs, tuple(phys_parity),
                       tuple(bond_parity))


def dress_tables(space, ly: int, lx: int) -> DressTables:
    """The dressing tables of an Ly x Lx lattice in ``space``."""
    return _static_tables(ly, lx, tuple(space.bond_parity),
                          tuple(space.phys_parity))


def snake_prefix_parity(config, phys_parity):
    """(Pi_prev, Pi_cur) [..., Ly, Lx] int64: the configuration's cumulative
    parity along the snake order, before / including each site."""
    return prefix_parity(config, phys_parity)


def fermion_project(tps, config, space, flags=(0,)):
    """Dressed projected networks [nc, Ly, Lx, D, D, D, D] (axes u, l, d, r)
    whose plain bosonic contraction is the snake-JW amplitude <S|psi>, for
    config [nc, Ly, Lx] (one K4 launch). flags (0, 1) returns [nc, 2, Ly,
    Lx, ...]: the projection and the prefix-flipped one (the reference's
    ``net * fermion_flip_mask``)."""
    ly, lx = config.shape[-2:]
    f0, nf = min(flags), len(flags)
    assert tuple(flags) in ((0,), (1,), (0, 1)), flags
    out = fermion_dress(tps, config, dress_tables(space, ly, lx),
                        select_config=True, f0=f0, nf=nf)[:, :, :, 0]
    if nf == 1:
        return out[:, :, :, 0]
    return out.movedim(3, 1)
