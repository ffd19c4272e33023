"""VMC optimizer loop (port of the SR and SGD part of
``peps_tpu/optimizer/optimizer.py``).

The parameter vector is the TPS tensor. SR solves (S + shift) x = g by
matrix-free CG on the centered sample matrix (two matrix-vector products
per iteration, left to cuBLAS). Covered: SR and SGD with a constant learning
rate and the JSONL log; spike detection stays off as the reference's
default. AdaGrad, Adam, MinSR and L-BFGS, momentum, clipping, schedulers,
the step selector, spike recovery and checkpoints come with ROADMAP queue 1,
items 6 and 9.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, NamedTuple

import torch

from peps_tpu_torch.optimizer.cg import CGParams, cg_solve


@dataclasses.dataclass(frozen=True)
class SGDParams:
    """Plain gradient descent (the reference's momentum 0)."""


@dataclasses.dataclass(frozen=True)
class SRParams:
    """diag_shift: Tikhonov shift on S; cg_warm_start: seed each solve with
    the previous natural gradient."""
    cg: CGParams = CGParams()
    diag_shift: float = 1e-3
    cg_warm_start: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    max_iters: int
    algorithm: object               # SRParams or SGDParams
    lr: float = 0.1                 # constant learning rate
    log_path: str | None = None     # JSONL per-iteration records

    def __post_init__(self):
        if not isinstance(self.algorithm, (SRParams, SGDParams)):
            raise NotImplementedError(
                f"optimizer {type(self.algorithm).__name__}: ROADMAP queue 1, "
                "items 6 and 9")
        if not isinstance(self.lr, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers: ROADMAP queue 1, item 6")


class Evaluation(NamedTuple):
    """What an energy evaluator returns."""
    energy: torch.Tensor
    gradient: torch.Tensor
    energy_error: torch.Tensor | None = None
    o_samples: torch.Tensor | None = None   # [Ns, P] centered, scaled
    e_samples: torch.Tensor | None = None   # [Ns] centered, scaled
    accept_rate: torch.Tensor | None = None
    aux: dict | None = None


class IterationRecord(NamedTuple):
    step: int
    energy: float
    energy_error: float
    grad_norm: float
    lr: float
    accept_rate: float
    sr_iters: int
    sr_residual: float
    natural_grad_norm: float
    eval_seconds: float
    update_seconds: float


class OptimizeResult(NamedTuple):
    state: torch.Tensor
    lowest_state: torch.Tensor
    energies: list
    lowest_energy: float
    records: list


def sr_natural_gradient(evaluation: Evaluation, p: SRParams, shape, x0=None):
    """Solve (A^H A + shift) x = g with A the centered sample matrix."""
    a = evaluation.o_samples
    g = evaluation.gradient.reshape(-1).to(a.dtype)
    shift = p.diag_shift

    def matvec(v):
        return a.mH @ (a @ v) + shift * v

    res = cg_solve(matvec, g, x0, p.cg)
    return res.x.reshape(shape), res


def iterative_optimize(state: torch.Tensor,
                       evaluate: Callable[[torch.Tensor, int], Evaluation],
                       params: OptimizerParams,
                       callback: Callable | None = None) -> OptimizeResult:
    """The optimization loop: evaluate, update, record. Each iteration reads
    the energy, its error, the gradient norm and the CG statistics back to
    the host once, for the record."""
    alg = params.algorithm
    energies, records = [], []
    lowest_e, lowest_state = math.inf, state
    nat_x0 = None
    log_f = None
    if params.log_path:
        os.makedirs(os.path.dirname(params.log_path) or ".", exist_ok=True)
        log_f = open(params.log_path, "a")
    try:
        for step in range(params.max_iters):
            t0 = time.perf_counter()
            ev = evaluate(state, step)
            energy = float(ev.energy)
            eval_s = time.perf_counter() - t0
            err = float(ev.energy_error) if ev.energy_error is not None else 0.0
            gn = float(torch.linalg.vector_norm(ev.gradient))
            energies.append(energy)
            if energy < lowest_e:
                lowest_e, lowest_state = energy, state
            lr = float(params.lr)

            t1 = time.perf_counter()
            sr_iters, sr_res, nat_norm = 0, 0.0, 0.0
            if isinstance(alg, SGDParams):
                new_state = state - lr * ev.gradient
            else:
                nat, res = sr_natural_gradient(ev, alg, state.shape, x0=nat_x0)
                if alg.cg_warm_start:
                    nat_x0 = res.x.reshape(-1)
                new_state = state - lr * nat.to(state.dtype)
                sr_iters = int(res.iterations)
                sr_res = float(res.residual_norm)
                nat_norm = float(torch.linalg.vector_norm(nat))
            upd_s = time.perf_counter() - t1
            state = new_state

            rec = IterationRecord(
                step, energy, err, gn, lr,
                float(ev.accept_rate) if ev.accept_rate is not None else 1.0,
                sr_iters, sr_res, nat_norm, eval_s, upd_s)
            records.append(rec)
            if log_f:
                d = rec._asdict()
                if ev.aux:
                    d.update({k: v for k, v in ev.aux.items() if k not in d})
                log_f.write(json.dumps(d) + "\n")
                log_f.flush()
            if callback is not None:
                callback(rec, state)
    finally:
        if log_f:
            log_f.close()
    return OptimizeResult(state, lowest_state, energies, lowest_e, records)
