"""Observable registry (port of ``peps_tpu/algorithm/registry.py``):
models declare their observables as data.

Each :class:`Observable` carries a per-sample-step ``compute(ctx)`` batched
over chains; the measurement executor evaluates every registered
observable, aggregates binned means and errors, and dumps
``stats/<key>.csv`` plus ``<key>_coords.txt``. Spin models take
:func:`spin_registry`, fermionic models :func:`fermion_registry` (and
graded t-J states :func:`graded_pair_observables`).
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
    them (the walker observables build their own otherwise); for a graded
    state stacks is the configurations' GradedEnvShared."""
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


def fermion_registry(ft, params) -> list:
    """Fermionic observables of a FermionTensors ft: densities, density-
    density, and with spin the down density, Sz maps, the hole density
    (t-J) or the double occupancy (Hubbard); with measure_pair_corr on a
    t-J basis the Jordan-Wigner singlet pair correlators of both frames."""
    n_up = ft.n_up.cpu().numpy()
    n_dn = ft.n_dn.cpu().numpy()
    d = len(n_up)
    ntot = n_up + n_dn
    obs = [
        Observable("n_up", "Up-electron density", _diag_map(n_up),
                   site_coords, ("y", "x")),
        Observable("density", "Total electron density", _diag_map(ntot),
                   site_coords, ("y", "x")),
        Observable("nn", "Density-density <n_i n_j>", _diag_pair(ntot),
                   pair_coords, ("y1", "x1", "y2", "x2")),
    ]
    if not ft.spinless:
        sz = 0.5 * (n_up - n_dn)
        obs.insert(1, Observable("n_dn", "Down-electron density",
                                 _diag_map(n_dn), site_coords, ("y", "x")))
        obs.append(Observable("sz", "Local <Sz>", _diag_map(sz),
                              site_coords, ("y", "x")))
        obs.append(Observable("szsz", "All-to-all <Sz_i Sz_j>",
                              _diag_pair(sz), pair_coords,
                              ("y1", "x1", "y2", "x2")))
        hole = (ntot == 0).astype(float)
        if np.any(hole):
            obs.append(Observable("hole_density", "Hole density <1-n_i>",
                                  _diag_map(hole), site_coords, ("y", "x")))
        docc = ((n_up == 1) & (n_dn == 1)).astype(float)
        if np.any(docc):
            obs.append(Observable(
                "double_occupancy", "Double occupancy <n_up n_dn>",
                _diag_map(docc), site_coords, ("y", "x")))
    if getattr(params, "measure_pair_corr", False) and not ft.spinless \
            and d == 3:
        from peps_tpu_torch.algorithm.measure_fermion import (
            tj_singlet_pair_corr_col, tj_singlet_pair_corr_row)

        def pair_corr(ctx):
            return tj_singlet_pair_corr_row(ctx.tps, ctx.config, ctx.chi,
                                            ctx.trunc, ctx.stacks).real

        def pair_corr_c(ctx):
            return tj_singlet_pair_corr_col(ctx.tps, ctx.config, ctx.chi,
                                            ctx.trunc, ctx.stacks_t).real

        obs.append(Observable(
            "pair_corr_row", "t-J singlet pair correlation "
            "<Delta^dag_i Delta_j> (in-row horizontal bond pairs)",
            pair_corr, None, ("y", "x1", "x2"), needs_envs=True,
            uses_stacks=True))
        obs.append(Observable(
            "pair_corr_col", "t-J singlet pair correlation "
            "<Delta^dag_i Delta_j> (in-column vertical bond pairs)",
            pair_corr_c, None, ("x", "y1", "y2"), needs_envs=True,
            uses_stacks_t=True))
    return obs


def graded_pair_observables(space) -> list:
    """The env-shared pair correlators of a graded t-J state in both
    frames; ctx.stacks is the configurations' GradedEnvShared, built once
    in the energy pass and shared by both."""
    from peps_tpu_torch.algorithm.measure_fermion import (
        tj_singlet_pair_corr_graded_colshared,
        tj_singlet_pair_corr_graded_rowshared)

    def row(ctx):
        return tj_singlet_pair_corr_graded_rowshared(
            ctx.tps, ctx.config, space, ctx.chi, ctx.trunc, ctx.stacks)

    def col(ctx):
        return tj_singlet_pair_corr_graded_colshared(
            ctx.tps, ctx.config, space, ctx.chi, ctx.trunc, ctx.stacks)

    return [
        Observable("pair_corr_row", "t-J singlet pair correlation (graded "
                   "state, in-row horizontal bond pairs; env-shared walker)",
                   row, None, ("y", "x1", "x2"), needs_envs=True,
                   uses_stacks=True),
        Observable("pair_corr_col", "t-J singlet pair correlation (graded "
                   "state, in-column vertical bond pairs; env-shared "
                   "excited-BMPS walker)", col, None, ("x", "y1", "y2"),
                   needs_envs=True, uses_stacks=True)]


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
