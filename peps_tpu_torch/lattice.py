"""Lattice conventions (port of ``peps_tpu/lattice.py``).

TPS site tensor A[p, u, l, d, r], the full TPS one tensor
[Ly, Lx, d, D, D, D, D]. Open-boundary edge bonds are embedded at index 0 of
a D-dimensional axis; the other slots are exact zeros (:func:`boundary_mask`).
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class BoundaryCondition(enum.Enum):
    OPEN = "open"
    PERIODIC = "periodic"


def boundary_mask(ly: int, lx: int, d: int, D: int,
                  bc: BoundaryCondition = BoundaryCondition.OPEN) -> np.ndarray:
    """0/1 mask [Ly, Lx, d, D, D, D, D] zeroing padded boundary slots."""
    mask = np.ones((ly, lx, d, D, D, D, D), dtype=np.float32)
    if bc == BoundaryCondition.PERIODIC:
        return mask
    edge = np.zeros(D, dtype=np.float32)
    edge[0] = 1.0
    mask[0] *= edge[None, None, :, None, None, None]
    mask[:, 0] *= edge[None, None, None, :, None, None]
    mask[ly - 1] *= edge[None, None, None, None, :, None]
    mask[:, lx - 1] *= edge[None, None, None, None, None, :]
    return mask


def nn_bonds_h(ly: int, lx: int,
               bc: BoundaryCondition = BoundaryCondition.OPEN) -> list:
    """Horizontal nearest-neighbour bonds ((y, x), (y, x+1)), row by row;
    on the torus also the wrap bonds ((y, Lx-1), (y, 0))."""
    xs = range(lx - 1) if bc == BoundaryCondition.OPEN else range(lx)
    return [((y, x), (y, (x + 1) % lx)) for y in range(ly) for x in xs]


def nn_bonds_v(ly: int, lx: int,
               bc: BoundaryCondition = BoundaryCondition.OPEN) -> list:
    """Vertical nearest-neighbour bonds ((y, x), (y+1, x)), row by row;
    on the torus also the wrap bonds ((Ly-1, x), (0, x))."""
    ys = range(ly - 1) if bc == BoundaryCondition.OPEN else range(ly)
    return [((y, x), ((y + 1) % ly, x)) for y in ys for x in range(lx)]


def transpose_lattice(tn: torch.Tensor) -> torch.Tensor:
    """Reflect a projected network [.., Ly, Lx, u, l, d, r] across the
    diagonal: [.., Lx, Ly, l, u, r, d], so vertical structures become
    horizontal. Returns a view."""
    nd = tn.ndim
    perm = list(range(nd - 6)) + [nd - 5, nd - 6, nd - 3, nd - 4, nd - 1,
                                  nd - 2]
    return tn.permute(perm)


def transpose_tps(tps: torch.Tensor) -> torch.Tensor:
    """Reflect a TPS [.., Ly, Lx, p, u, l, d, r] across the diagonal:
    [.., Lx, Ly, p, l, u, r, d], so vertical bonds become horizontal.
    Returns a view."""
    nd = tps.ndim
    perm = list(range(nd - 7)) + [nd - 6, nd - 7, nd - 5, nd - 3, nd - 4,
                                  nd - 1, nd - 2]
    return tps.permute(perm)
