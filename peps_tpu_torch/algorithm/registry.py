"""Observable registry, bosonic part (port of
``peps_tpu/algorithm/registry.py``): models declare their observables as
data.

Each :class:`Observable` carries a per-sample-step ``compute(ctx)`` batched
over chains; the measurement executor evaluates every registered
observable, aggregates binned means and errors, and dumps
``stats/<key>.csv`` plus ``<key>_coords.txt``. The fermionic registry comes
with ROADMAP queue 1, item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch


class MeasureContext(NamedTuple):
    """Inputs handed to Observable.compute for one sample step: config
    [nc, Ly, Lx], e_loc [nc]; stacks / stacks_t: the env stacks of these
    configurations in the normal / transposed frame when the executor has
    them (the walker observables build their own otherwise)."""
    tps: torch.Tensor
    tps_t: torch.Tensor
    config: torch.Tensor
    e_loc: torch.Tensor
    chi: int
    trunc: object
    stacks: object = None
    stacks_t: object = None


@dataclasses.dataclass(frozen=True)
class Observable:
    key: str
    description: str
    compute: Callable                    # (MeasureContext) -> [nc, ...]
    coords: Callable | None = None       # (ly, lx) -> [K, ncoord] ints
    index_labels: tuple = ()
    needs_envs: bool = False             # a walker: runs in the env pass
    uses_stacks: bool = False            # reads ctx.stacks
    uses_stacks_t: bool = False          # reads ctx.stacks_t


def site_coords(ly, lx):
    return np.array([(y, x) for y in range(ly) for x in range(lx)])


def pair_coords(ly, lx):
    s = site_coords(ly, lx)
    return np.array([(*a, *b) for a in s for b in s])


def row_segment_coords(ly, lx):
    """(y, x1, x2) for in-row pairs x1 < x2 (walker correlators)."""
    return np.array([(y, x1, x2) for y in range(ly)
                     for x1 in range(lx) for x2 in range(x1 + 1, lx)])


def _values(values, ctx):
    return torch.as_tensor(values, dtype=ctx.e_loc.dtype,
                           device=ctx.config.device)


def _diag_map(values):
    def compute(ctx):
        return _values(values, ctx)[ctx.config]
    return compute


def _diag_pair(values):
    def compute(ctx):
        flat = _values(values, ctx)[ctx.config].reshape(
            ctx.config.shape[0], -1)
        return flat[:, :, None] * flat[:, None, :]
    return compute


def spin_registry(params) -> list:
    """Spin-1/2 observables: <Sz>, all-to-all <Sz Sz> and, with
    measure_offdiag_corr, the in-row and in-column <S+ S-> walkers."""
    sz = np.array([0.5, -0.5])
    obs = [
        Observable("sz", "Local <Sz> per site", _diag_map(sz), site_coords,
                   ("y", "x")),
        Observable("szsz", "All-to-all <Sz_i Sz_j>", _diag_pair(sz),
                   pair_coords, ("y1", "x1", "y2", "x2")),
    ]
    if getattr(params, "measure_offdiag_corr", True):
        from peps_tpu_torch.algorithm.measure import _row_offdiag_corr
        from peps_tpu_torch.contraction import bmps
        from peps_tpu_torch.tps import project
        sp = np.array([[0.0, 1.0], [0.0, 0.0]])
        sm = sp.T

        def walker(tps, config, stacks, ctx):
            tn = project(tps, config)
            if stacks is None:
                stacks = bmps.all_env_stacks(tn, ctx.chi, ctx.trunc)
            op = lambda m: torch.as_tensor(m, dtype=tps.dtype,
                                           device=tps.device)
            return _row_offdiag_corr(tps, tn, config, op(sp), op(sm),
                                     ctx.chi, ctx.trunc, stacks).real

        def spsm_row(ctx):
            return walker(ctx.tps, ctx.config, ctx.stacks, ctx)

        def spsm_col(ctx):
            return walker(ctx.tps_t, ctx.config.transpose(1, 2),
                          ctx.stacks_t, ctx)

        obs.append(Observable(
            "spsm_row", "In-row <S+_i S-_j> (S+S- walker channel)",
            spsm_row, None, ("y", "x1", "x2"), needs_envs=True,
            uses_stacks=True))
        obs.append(Observable(
            "spsm_col", "In-column <S+_i S-_j>", spsm_col, None,
            ("x", "y1", "y2"), needs_envs=True, uses_stacks_t=True))
    return obs


def structure_factor_spsm_row(spsm_row_mean: np.ndarray, lx: int
                              ) -> np.ndarray:
    """In-row transverse structure factor S^{+-}(q_x) from the measured
    S+S- walker channel [Ly, Lx, Lx] (entries at x1 < x2), averaged over
    rows."""
    c = np.asarray(spsm_row_mean)
    ly = c.shape[0]
    c = c + np.transpose(c, (0, 2, 1))     # the hermitian partner
    qx = 2 * np.pi * np.fft.fftfreq(lx)
    out = np.zeros(lx)
    xs = np.arange(lx)
    for iq, q in enumerate(qx):
        ph = np.exp(1j * q * xs)
        out[iq] = np.real(np.einsum("i,yij,j->", ph.conj(), c, ph)) \
            / (lx * ly)
    return out
