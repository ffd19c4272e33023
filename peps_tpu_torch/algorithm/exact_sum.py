"""Exact-summation energy and gradient, the deterministic test oracle (port
of the OBC bosonic part of ``peps_tpu/algorithm/exact_sum.py``).

Enumerate the configurations, weight each by |psi|^2 and sum exactly. The
configuration batch goes through the chain-batched local energy in pieces
of ``batch_size`` (``torch.split``, where the reference uses ``lax.map``):
the bosonic one, the Jordan-Wigner one of a fermionic model, or the graded
one of a ``GradedFermionModel``; with ``bc=PERIODIC`` the torus local
energy of the coarse-graining contractor (bosonic models only; the
reference's exact sum would take a fermionic model's open-boundary
evaluator there, the port refuses it).
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from peps_tpu_torch.algorithm.energy import (EnergyHoles,
                                             local_energy_and_holes,
                                             model_kind, model_tensors)
from peps_tpu_torch.algorithm.energy_fermion import \
    local_energy_and_holes_fermion
from peps_tpu_torch.algorithm.energy_pbc import local_energy_and_holes_pbc
from peps_tpu_torch.algorithm.mc_evaluator import require_bosonic_for_pbc
from peps_tpu_torch.lattice import BoundaryCondition
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.optimizer.optimizer import Evaluation


def all_configs(ly: int, lx: int, d: int) -> np.ndarray:
    """The full configuration space [d^N, Ly, Lx] int32, in lexicographic
    order."""
    out = np.array(list(itertools.product(range(d), repeat=ly * lx)),
                   dtype=np.int32)
    return out.reshape(-1, ly, lx)


def sector_configs(ly: int, lx: int, occupancy: dict[int, int]) -> np.ndarray:
    """Configurations with fixed occupation numbers {state: count} (e.g. an
    Sz sector), [N, Ly, Lx] int32 in lexicographic order. The counts must
    sum to Ly*Lx."""
    n = ly * lx
    base = []
    for state, count in sorted(occupancy.items()):
        base.extend([state] * count)
    if len(base) != n:
        raise ValueError(f"occupancy counts sum to {len(base)} but the "
                         f"lattice has {n} sites; occupancy={occupancy!r}")
    out = []
    perm = list(base)
    while True:          # distinct permutations in order ("next permutation")
        out.append(list(perm))
        i = n - 2
        while i >= 0 and perm[i] >= perm[i + 1]:
            i -= 1
        if i < 0:
            break
        j = n - 1
        while perm[j] <= perm[i]:
            j -= 1
        perm[i], perm[j] = perm[j], perm[i]
        perm[i + 1:] = perm[i + 1:][::-1]
    return np.array(out, dtype=np.int32).reshape(-1, ly, lx)


def pad_configs(configs: np.ndarray,
                n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the batch to a multiple of n_shards by repeating configs[0];
    returns (padded configs, valid mask). The evaluators give padding rows
    (mask False) exactly zero weight."""
    nc = configs.shape[0]
    pad = (-nc) % n_shards
    mask = np.ones(nc + pad, dtype=bool)
    if pad:
        mask[nc:] = False
        configs = np.concatenate(
            [configs, np.repeat(configs[:1], pad, axis=0)], axis=0)
    return configs, mask


class ExactSumResult(NamedTuple):
    energy: torch.Tensor              # real scalar
    gradient: torch.Tensor | None     # tps-shaped
    weight_sum: torch.Tensor          # sum of |psi|^2


def _evaluate(tps, configs, model, chi, trunc, with_holes, batch_size, bc):
    """EnergyHoles of every configuration, in pieces of batch_size."""
    model = model_tensors(model, tps.dtype, tps.device, "exact sum")
    require_bosonic_for_pbc(model, bc)
    kind = model_kind(model)
    if kind == "graded":
        from peps_tpu_torch.fermion.vmc import local_energy_and_holes_graded
        local = local_energy_and_holes_graded
    elif kind == "jw":
        local = local_energy_and_holes_fermion
    elif bc == BoundaryCondition.PERIODIC:
        local = local_energy_and_holes_pbc
    else:
        local = local_energy_and_holes
    configs = torch.as_tensor(configs, device=tps.device).long()
    pieces = torch.split(configs, batch_size) if batch_size else (configs,)
    res = [local(tps, c, model, chi, trunc, with_holes=with_holes)
           for c in pieces]
    return EnergyHoles(*(None if parts[0] is None else torch.cat(parts)
                         for parts in zip(*res)))


def _weights(res: EnergyHoles, mask):
    """(w [Nc] = |psi|^2 / max |psi|^2, 0 for psi = 0 and masked rows,
    max of 2 log|psi|)."""
    logw = 2.0 * res.log_abs_psi
    logw_max = logw.max()
    w = torch.where(res.psi_mant == 0, torch.zeros_like(logw),
                    torch.exp(logw - logw_max))
    if mask is not None:
        w = torch.where(torch.as_tensor(mask, device=w.device), w,
                        torch.zeros_like(w))
    return w, logw_max


def exact_sum_energy_gradient(tps: torch.Tensor, configs, model, chi: int,
                              trunc: TruncParams, with_grad: bool = True,
                              batch_size: int | None = None,
                              bc: BoundaryCondition = BoundaryCondition.OPEN,
                              mask=None) -> ExactSumResult:
    """Exact <H> and gradient over an enumerated configuration set.

    The gradient is dE/d(theta*) for a complex state and the true gradient
    2 Re <(E_loc - E) conj(O)> for a real one, as the reference's. mask
    (bool [Nc]) zero-weights :func:`pad_configs` rows."""
    res = _evaluate(tps, configs, model, chi, trunc, with_grad, batch_size,
                    bc)
    w, logw_max = _weights(res, mask)
    z = w.sum()
    energy = (w * res.e_loc.real).sum() / z
    grad = None
    if with_grad:
        o = res.o_tensor
        wc = (w * (res.e_loc - energy)).to(o.dtype)
        grad = torch.tensordot(wc, o.conj(), dims=([0], [0])) / z
        if not tps.is_complex():
            grad = 2.0 * grad.real
    return ExactSumResult(energy, grad, z * torch.exp(logw_max))


def exact_sum_evaluation(tps: torch.Tensor, configs, model, chi: int,
                         trunc: TruncParams, with_sr_buffers: bool = False,
                         batch_size: int | None = None,
                         bc: BoundaryCondition = BoundaryCondition.OPEN,
                         mask=None) -> Evaluation:
    """The optimizer's Evaluation from an exact sum: energy, gradient and,
    with SR, the centered sqrt-weighted sample matrix A and residuals eps
    with S = A^H A and gradient = A^H eps (x2 for a real state)."""
    res = _evaluate(tps, configs, model, chi, trunc, True, batch_size, bc)
    w, _ = _weights(res, mask)
    wn = w / w.sum()
    energy = (wn * res.e_loc.real).sum()
    nc = res.e_loc.shape[0]
    o_flat = res.o_tensor.reshape(nc, -1)
    obar = (wn[:, None] * o_flat).sum(0)
    sq = torch.sqrt(wn).to(o_flat.dtype)
    a = sq[:, None] * (o_flat - obar[None, :])
    eps = sq * (res.e_loc - energy).to(o_flat.dtype)
    if not tps.is_complex():
        eps = 2.0 * eps
    grad = (a.mH @ eps).reshape(tps.shape)
    if not tps.is_complex():
        grad = grad.real
    return Evaluation(energy=energy, gradient=grad.to(tps.dtype),
                      energy_error=torch.zeros((), dtype=energy.dtype,
                                               device=energy.device),
                      o_samples=a if with_sr_buffers else None,
                      e_samples=eps if with_sr_buffers else None,
                      accept_rate=None)
