"""Spin-1/2 model tensors (numpy; copy of the spin models of
``peps_tpu/models/spin.py``, so that the port never imports the JAX
package).

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


def ising_zz_bond(j: float = 1.0) -> np.ndarray:
    """-j sigma^z sigma^z with Pauli operators (sigma = 2S), the TFIM's
    bond."""
    sz = np.diag([1.0, -1.0])
    return -j * two_site(sz, sz)


def transverse_field_site(h: float) -> np.ndarray:
    """-h sigma^x, the TFIM's one-site term."""
    return -h * np.array([[0.0, 1.0], [1.0, 0.0]])


@dataclasses.dataclass(frozen=True)
class SquareLatticeModel:
    """Generic square-lattice two-body model (bosonic); fields as in the
    JAX package. h_h / h_v: nearest-neighbour bonds; h_d on (y,x)-(y+1,x+1),
    h_ad on (y+1,x)-(y,x+1); h_s5a on ((y+1,x),(y,x+2)) and h_s5b on
    ((y+2,x),(y,x+1)), each in (lower-left, upper-right) index order;
    h_tnn_h on ((y,x),(y,x+2)) and h_tnn_v on ((y,x),(y+2,x)); h_site: the
    onsite term. Any of them may be None; the port evaluates all of them
    (``algorithm/energy.py``)."""
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


def j1j2_xxz(j1z: float, j1xy: float, j2z: float,
             j2xy: float) -> SquareLatticeModel:
    """J1-J2 model: J1 on the nearest-neighbour bonds, J2 on both
    diagonals."""
    h1 = xxz_bond(j1z, j1xy)
    h2 = xxz_bond(j2z, j2xy)
    return SquareLatticeModel(2, h1, h1, h2, h2, name="j1j2_xxz")


def triangle_heisenberg(j: float = 1.0) -> SquareLatticeModel:
    """Triangular-lattice Heisenberg on a square PEPS: the nearest-neighbour
    bonds plus the (y,x)-(y+1,x+1) diagonal."""
    hb = heisenberg_bond(j)
    return SquareLatticeModel(2, hb, hb, h_d=hb, name="triangle_heisenberg")


def triangle_j1j2_heisenberg(j1: float, j2: float) -> SquareLatticeModel:
    """Triangular-lattice J1-J2 Heisenberg on a square PEPS: J1 on the
    triangular nearest-neighbour bonds (horizontal, vertical and the
    anti-diagonal (y+1,x)-(y,x+1)), J2 on the triangular next-nearest ones
    (the diagonal (y,x)-(y+1,x+1) and both sqrt5 families)."""
    h1 = heisenberg_bond(j1)
    h2 = heisenberg_bond(j2)
    return SquareLatticeModel(2, h1, h1, h_d=h2, h_ad=h1, h_s5a=h2, h_s5b=h2,
                              name="triangle_j1j2")


def triangle_j1j2_nnn(j1: float, j2: float) -> SquareLatticeModel:
    """Square-lattice NNN variant: J1 on the nearest-neighbour bonds and the
    diagonal, J2 on the anti-diagonal."""
    h1 = heisenberg_bond(j1)
    h2 = heisenberg_bond(j2)
    return SquareLatticeModel(2, h1, h1, h_d=h1, h_ad=h2,
                              name="triangle_j1j2_nnn")


def transverse_field_ising(j: float = 1.0, h: float = 1.0) -> SquareLatticeModel:
    """H = -j sum_<ij> sigma^z_i sigma^z_j - h sum_i sigma^x_i; Sz is not
    conserved, so it samples with a rule that flips single spins (the
    Suwa-Todo update of a bond)."""
    hb = ising_zz_bond(j)
    return SquareLatticeModel(2, hb, hb, h_site=transverse_field_site(h),
                              name="tfim")
