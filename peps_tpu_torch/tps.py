"""TPS state container (port of ``peps_tpu/tps.py``).

One tensor [Ly, Lx, d, D, D, D, D] with site axes (p, u, l, d, r); boundary
bonds padded at index 0 (:func:`peps_tpu_torch.lattice.boundary_mask`).
Files are written in the JAX package's format (``<path>.npz`` holding
``tps`` plus ``<path>_meta.json``), so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.lattice import BoundaryCondition


@dataclasses.dataclass(frozen=True)
class TPSMeta:
    ly: int
    lx: int
    phys_dim: int
    bond_dim: int
    bc: BoundaryCondition = BoundaryCondition.OPEN


def project(tps: torch.Tensor, config: torch.Tensor) -> torch.Tensor:
    """tn[..., y, x] = tps[y, x, config[..., y, x]].

    tps: [Ly, Lx, d, D, D, D, D]; config: [..., Ly, Lx] int (leading chain
    dims allowed) -> [..., Ly, Lx, D, D, D, D]."""
    ly, lx = tps.shape[:2]
    ys = torch.arange(ly, device=tps.device)[:, None]
    xs = torch.arange(lx, device=tps.device)[None, :]
    return tps[ys, xs, config.long()]


def save_tps(path: str, tps: torch.Tensor, meta: TPSMeta) -> None:
    """Write ``<path>.npz`` and ``<path>_meta.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = path[:-4] if path.endswith(".npz") else path
    np.savez(base + ".npz", tps=tps.detach().cpu().numpy())
    with open(base + "_meta.json", "w") as f:
        json.dump({"ly": meta.ly, "lx": meta.lx, "phys_dim": meta.phys_dim,
                   "bond_dim": meta.bond_dim, "bc": meta.bc.value}, f)


def load_tps(path: str, device=None):
    """Read a TPS written by either package. Returns (tensor, TPSMeta)."""
    base = path[:-4] if path.endswith(".npz") else path
    with np.load(base + ".npz") as f:
        arr = f["tps"]
    with open(base + "_meta.json") as f:
        m = json.load(f)
    meta = TPSMeta(m["ly"], m["lx"], m["phys_dim"], m["bond_dim"],
                   BoundaryCondition(m["bc"]))
    return torch.as_tensor(arr, device=resolve_device(device)), meta


# ---------------------------------------------------------------------------
# Brute-force oracles (tests only; exponential in lattice size), numpy
# ---------------------------------------------------------------------------

def exact_contract(tn: np.ndarray):
    """Exactly contract a small projected network [Ly, Lx, u, l, d, r]
    (boundary legs closed at index 0) by absorbing rows into a dense top
    boundary."""
    tn = np.asarray(tn)
    ly, lx, D = tn.shape[0], tn.shape[1], tn.shape[2]
    v = np.zeros((D,) * lx, dtype=tn.dtype)
    v[(0,) * lx] = 1.0
    for y in range(ly):
        w = v
        for x in range(lx):
            if x == 0:
                w = np.tensordot(tn[y, 0][:, 0, :, :], w, axes=([0], [0]))
            else:
                w = np.tensordot(w, tn[y, x], axes=([x, x + 1], [1, 0]))
                w = np.moveaxis(w, -2, x)
                w = np.moveaxis(w, -1, x + 1)
        v = w[tuple([slice(None)] * lx + [0])]
    return v[(0,) * lx]


def exact_amplitude(tps, config):
    """psi(config) by brute force; tps [Ly, Lx, d, ...], config [Ly, Lx]."""
    tps = np.asarray(tps)
    config = np.asarray(config)
    ly, lx = config.shape
    tn = tps[np.arange(ly)[:, None], np.arange(lx)[None, :], config]
    return exact_contract(tn)
