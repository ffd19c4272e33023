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
from peps_tpu_torch.lattice import BoundaryCondition, boundary_mask


@dataclasses.dataclass(frozen=True)
class TPSMeta:
    ly: int
    lx: int
    phys_dim: int
    bond_dim: int
    bc: BoundaryCondition = BoundaryCondition.OPEN


def _mask(ly, lx, d, D, like, bc=BoundaryCondition.OPEN) -> torch.Tensor:
    return torch.as_tensor(boundary_mask(ly, lx, d, D, bc),
                           dtype=like.real.dtype, device=like.device)


def _normal(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """Standard normal draws on the generator's device; a complex dtype
    takes its real and imaginary parts from two draws."""
    if dtype.is_complex:
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        re = torch.randn(shape, generator=generator, dtype=rdt,
                         device=generator.device)
        im = torch.randn(shape, generator=generator, dtype=rdt,
                         device=generator.device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def random_tps(generator: torch.Generator, ly: int, lx: int, phys_dim: int,
               bond_dim: int, dtype=torch.float32,
               bc: BoundaryCondition = BoundaryCondition.OPEN,
               scale: float = 1.0, device=None) -> torch.Tensor:
    """Random TPS [Ly, Lx, d, D, D, D, D], Gaussian entries from
    ``generator`` times scale, boundary padding masked to exact zeros.
    device None: the current CUDA device."""
    shape = (ly, lx, phys_dim) + (bond_dim,) * 4
    arr = _normal(generator, shape, dtype).to(resolve_device(device))
    return arr * scale * _mask(ly, lx, phys_dim, bond_dim, arr, bc)


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flattened Euclidean inner product <a|b>, conjugating a (the
    reference's SplitIndexTPS operator*)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def norm_square(a: torch.Tensor) -> torch.Tensor:
    """<a|a>, real."""
    return inner_product(a, a).real


def wavefunction_sum(a: torch.Tensor, b: torch.Tensor, ca: float = 1.0,
                     cb: float = 1.0) -> torch.Tensor:
    """ca |a> + cb |b> as one TPS of bond dimension Da + Db: the two states
    block-diagonal in every bond, ca and cb folded into site (0, 0), and on
    each boundary leg b's slot Da moved onto slot 0, so that the index-0
    closure sums the two states."""
    ly, lx, d, da = a.shape[0], a.shape[1], a.shape[2], a.shape[3]
    dn = da + b.shape[3]
    out = torch.zeros((ly, lx, d) + (dn,) * 4,
                      dtype=torch.result_type(a, b), device=a.device)
    out[:, :, :, :da, :da, :da, :da] = a
    out[:, :, :, da:, da:, da:, da:] = b
    out[0, 0, :, :da] *= ca
    out[0, 0, :, da:] *= cb
    for axis, rows, cols in ((3, 0, slice(None)), (4, slice(None), 0),
                             (5, ly - 1, slice(None)),
                             (6, slice(None), lx - 1)):
        src = [rows, cols] + [slice(None)] * 5
        dst = list(src)
        src[axis], dst[axis] = da, 0
        out[tuple(dst)] += out[tuple(src)]
        out[tuple(src)] = 0.0
    return out * _mask(ly, lx, d, dn, out)


def expand_bond_dim(tps: torch.Tensor, new_bond_dim: int, noise: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Zero-pad every virtual leg to new_bond_dim (the represented state is
    unchanged); with noise > 0, Gaussian noise from ``generator`` on the
    new slots only, masked off the boundary legs."""
    ly, lx, d, db = tps.shape[0], tps.shape[1], tps.shape[2], tps.shape[3]
    if new_bond_dim < db:
        raise ValueError(f"new_bond_dim {new_bond_dim} < bond_dim {db}")
    out = torch.nn.functional.pad(tps, (0, new_bond_dim - db) * 4)
    if noise > 0.0:
        if generator is None:
            raise ValueError("noise > 0 needs a generator")
        full = _normal(generator, out.shape, out.dtype).to(out.device) * noise
        full[:, :, :, :db, :db, :db, :db] = 0.0
        out = out + full * _mask(ly, lx, d, new_bond_dim, out)
    return out


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


def exact_contract_pbc(tn: np.ndarray):
    """Exactly contract a small torus network [Ly, Lx, u, l, d, r] (u of
    (y, x) meets d of (y-1 mod Ly, x), l meets r of (y, x-1 mod Lx)): the
    row transfer matrices over the vertical-bond product space, each row's
    horizontal ring traced, then the trace of their product. The torus
    oracle; exponential in Lx."""
    tn = np.asarray(tn)
    ly, lx, D = tn.shape[0], tn.shape[1], tn.shape[2]
    total = None
    for y in range(ly):
        w = np.moveaxis(tn[y, 0], 1, 0)                 # [l0, u0, d0, r0]
        for x in range(1, lx):
            w = np.tensordot(w, tn[y, x], axes=([-1], [1]))
        w = np.trace(w, axis1=0, axis2=w.ndim - 1)      # close the ring
        perm = list(range(0, 2 * lx, 2)) + list(range(1, 2 * lx, 2))
        w = np.transpose(w, perm).reshape(D ** lx, D ** lx)
        total = w if total is None else total @ w
    return np.trace(total)
