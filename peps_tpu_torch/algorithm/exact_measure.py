"""Exact-summation measurement, the oracle of the measurement code (port of
``peps_tpu/algorithm/exact_measure.py``): enumerate the configurations and
average the observables with exact |psi|^2 weights; for graded t-J states
the sector-summed pair correlator (:func:`exact_sum_pair_corr_graded`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from peps_tpu_torch.algorithm.energy import (_local_energy,
                                             bosonic_model_tensors)
from peps_tpu_torch.algorithm.measure import (_one_point_diag,
                                              _row_offdiag_corr)
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project


class ExactMeasureResult(NamedTuple):
    values: dict     # key -> exact expectation value (float64 ndarray)
    weight_sum: torch.Tensor


def exact_sum_measure(tps: torch.Tensor, configs, model, chi: int,
                      trunc: TruncParams,
                      observables=("energy", "sz", "szsz", "spsm_row"),
                      sz_values=None, op_a=None, op_b=None
                      ) -> ExactMeasureResult:
    """Exact expectation values of the standard observables over the
    configurations [Nc, Ly, Lx] (all of them, or a sector), as one chain
    batch. sz_values / op_a / op_b default to spin 1/2 (Sz, S+, S-)."""
    d = tps.shape[2]
    dev = tps.device
    mt = bosonic_model_tensors(model, tps.dtype, dev, "exact_sum_measure")
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    if sz_values is None and d == 2:
        sz_values = [0.5, -0.5]
    if op_a is None and d == 2:
        op_a = np.array([[0.0, 1.0], [0.0, 0.0]])   # S+
        op_b = op_a.T                                # S-
    cfg = torch.as_tensor(configs, device=dev).long()
    tn = project(tps, cfg)
    stacks = bmps.all_env_stacks(tn, chi, trunc)
    e, _, log_abs, mant = _local_energy(tps, cfg, mt, chi, trunc, stacks)
    out = {}
    if "energy" in observables:
        out["energy"] = e.real
    if "sz" in observables or "szsz" in observables:
        sz = _one_point_diag(cfg, torch.as_tensor(sz_values, dtype=rdt,
                                                  device=dev))
        if "sz" in observables:
            out["sz"] = sz
        if "szsz" in observables:
            flat = sz.reshape(cfg.shape[0], -1)
            out["szsz"] = flat[:, :, None] * flat[:, None, :]
    if "spsm_row" in observables:
        op = lambda m: torch.as_tensor(m, dtype=tps.dtype, device=dev)
        out["spsm_row"] = _row_offdiag_corr(tps, tn, cfg, op(op_a), op(op_b),
                                            chi, trunc, stacks).real
    logw = 2.0 * log_abs
    w = torch.where(mant == 0, torch.zeros_like(logw),
                    torch.exp(logw - logw.max()))
    z = w.sum()
    values = {}
    for key, arr in out.items():
        wn = (w / z).reshape((-1,) + (1,) * (arr.ndim - 1))
        values[key] = (wn * arr).sum(0).cpu().numpy()
    return ExactMeasureResult(values, z)


def _pair_corr_support(view: np.ndarray) -> np.ndarray:
    """Boolean [N]: whether any line of the configurations view [N, nlines,
    L] holds both a hole bond (two adjacent empty sites) and a singlet-
    ordered pair bond (adjacent up-down in either order) at in-line bond
    distance > 1, the support of the pair-correlation tables."""
    a, b = view[..., :-1], view[..., 1:]
    hole = (a == 0) & (b == 0)
    pair = ((a == 1) & (b == 2)) | ((a == 2) & (b == 1))
    nb = hole.shape[-1]
    gap = np.abs(np.arange(nb)[:, None] - np.arange(nb)[None, :]) > 1
    m = ((hole[..., :, None] & pair[..., None, :])
         | (pair[..., :, None] & hole[..., None, :])) & gap
    return m.any(axis=(-1, -2, -3))


def exact_sum_pair_corr_graded(tps, configs, space, chi: int,
                               trunc: TruncParams, frames=("row", "col"),
                               batch_size: int = 16, amp_batch: int = 256):
    """Exact sector-summed <Delta^dag_i Delta_k> of a graded t-J state:
    C[l, i, k] = sum_S |psi(S)|^2 table(S)[l, i, k] / sum_S |psi(S)|^2 over
    the enumerated configurations [N, Ly, Lx] (a charge sector), table the
    env-shared walker of the frame. One batched amplitude pass over the
    sector (amp_batch configurations a call), then the walkers on the
    supported configurations only (batch_size a call, one GradedEnvShared
    each). The operator conserves (N_up, N_dn), so the sector sum is exact
    for the sector-projected state. Returns ({frame: float64 table},
    weight_sum)."""
    from peps_tpu_torch.algorithm.measure_fermion import (
        graded_env_shared, tj_singlet_pair_corr_graded_colshared,
        tj_singlet_pair_corr_graded_rowshared)
    from peps_tpu_torch.fermion.vmc import log_abs_psi_fermion

    cf = np.asarray(configs)
    cfg = torch.as_tensor(cf, device=tps.device).long()
    parts = [log_abs_psi_fermion(tps, cfg[s:s + amp_batch], space, chi,
                                 trunc)
             for s in range(0, cfg.shape[0], amp_batch)]
    logs = torch.cat([p[0] for p in parts]).double().cpu().numpy()
    dead = (torch.cat([p[1] for p in parts]) == 0).cpu().numpy()
    w = np.where(dead, 0.0, np.exp(2.0 * (logs - logs[~dead].max())))
    z = float(w.sum())
    walkers = {"row": tj_singlet_pair_corr_graded_rowshared,
               "col": tj_singlet_pair_corr_graded_colshared}
    ly, lx = cf.shape[1], cf.shape[2]
    shapes = {"row": (ly, lx - 1, lx - 1), "col": (lx, ly - 1, ly - 1)}
    out = {}
    for frame in frames:
        view = cf if frame == "row" else np.swapaxes(cf, 1, 2)
        idx = np.nonzero(_pair_corr_support(view))[0]
        if idx.size == 0:
            out[frame] = np.zeros(shapes[frame])
            continue
        tables = []
        for s in range(0, idx.size, batch_size):
            c = cfg[torch.as_tensor(idx[s:s + batch_size], device=tps.device)]
            shared = graded_env_shared(tps, c, space, chi, trunc)
            tables.append(walkers[frame](tps, c, space, chi, trunc, shared)
                          .real.double().cpu())
        out[frame] = np.einsum("s,s...->...", w[idx] / z,
                               torch.cat(tables).numpy())
    return out, z
