"""Exact-summation measurement, the oracle of the measurement code (port of
the bosonic part of ``peps_tpu/algorithm/exact_measure.py``): enumerate the
configurations and average the observables with exact |psi|^2 weights.
The graded pair-correlation sum comes with ROADMAP queue 1, item 10.
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
