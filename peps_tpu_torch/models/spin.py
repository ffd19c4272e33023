"""Spin-1/2 model tensors (numpy; copy of the part of
``peps_tpu/models/spin.py`` that the port's main path uses, so that the
port never imports the JAX package).

A model is a set of dense couplings h_bond[d,d,d,d] = <p1' p2'| h |p1 p2>
plus an onsite h_site[d,d]. State 0 = spin up, 1 = spin down.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def spin_half_ops():
    sz = np.array([[0.5, 0.0], [0.0, -0.5]])
    sp = np.array([[0.0, 1.0], [0.0, 0.0]])
    sm = sp.T
    sx = 0.5 * np.array([[0.0, 1.0], [1.0, 0.0]])
    sy = 0.5j * np.array([[0.0, -1.0], [1.0, 0.0]])
    return sz, sp, sm, sx, sy


def two_site(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (x) b as [d,d,d,d] = <p1' p2'|a(x)b|p1 p2>."""
    return np.einsum("ac,bd->abcd", a, b)


def xxz_bond(jz: float = 1.0, jxy: float = 1.0) -> np.ndarray:
    """H_bond = jz Sz Sz + jxy/2 (S+ S- + S- S+)."""
    sz, sp, sm, _, _ = spin_half_ops()
    return (jz * two_site(sz, sz)
            + 0.5 * jxy * (two_site(sp, sm) + two_site(sm, sp)))


def heisenberg_bond(j: float = 1.0) -> np.ndarray:
    return j * xxz_bond(1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class SquareLatticeModel:
    """Generic square-lattice two-body model (bosonic); fields as in the
    JAX package. The port evaluates h_h, h_v and h_site; the longer-range
    terms come with ROADMAP queue 1, item 9."""
    phys_dim: int
    h_h: np.ndarray | None = None
    h_v: np.ndarray | None = None
    h_d: np.ndarray | None = None
    h_ad: np.ndarray | None = None
    h_site: np.ndarray | None = None
    h_s5a: np.ndarray | None = None
    h_s5b: np.ndarray | None = None
    h_tnn_h: np.ndarray | None = None
    h_tnn_v: np.ndarray | None = None
    name: str = "model"


def heisenberg(j: float = 1.0) -> SquareLatticeModel:
    hb = heisenberg_bond(j)
    return SquareLatticeModel(2, hb, hb, name="heisenberg")


def xxz(jz: float, jxy: float) -> SquareLatticeModel:
    hb = xxz_bond(jz, jxy)
    return SquareLatticeModel(2, hb, hb, name="xxz")
