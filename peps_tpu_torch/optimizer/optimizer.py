"""VMC optimizer: the iterative loop and its update algorithms (port of
``peps_tpu/optimizer/optimizer.py``).

The parameter vector is the TPS tensor. Covered: SGD (momentum,
Nesterov), AdaGrad, Adam (bias correction, weight decay), SR by
matrix-free CG (``normalize_update``, warm start), MinSR (dense eigh of the
Ns x Ns Gram, or matrix-free Lanczos in ``optimizer/krylov.py``), L-BFGS
(fixed, Armijo and strong-Wolfe line searches), value and norm clipping,
learning-rate schedulers, the step selector, spike detection S1-S4 with
rollback, checkpoints, the JSONL log, the trajectory and spike CSVs,
``should_stop`` and a ``torch.profiler`` window.

The update rules build new tensors and never write into their inputs: the
rollback snapshot holds the optimizer moments by reference (as the
reference's immutable arrays are held), so an in-place update would change
the snapshot too and a rollback would restore nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.optimizer.cg import CGParams, cg_solve
from peps_tpu_torch.optimizer.krylov import (minsr_krylov_natural_gradient,
                                             minsr_soft_filter)
from peps_tpu_torch.optimizer.schedulers import LearningRateScheduler


@dataclasses.dataclass(frozen=True)
class SGDParams:
    momentum: float = 0.0
    nesterov: bool = False


@dataclasses.dataclass(frozen=True)
class AdaGradParams:
    eps: float = 1e-8
    initial_accumulator: float = 0.0


@dataclasses.dataclass(frozen=True)
class AdamParams:
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class SRParams:
    """Stochastic reconfiguration. diag_shift: Tikhonov shift on S;
    normalize_update: rescale the natural gradient to unit S-norm;
    cg_warm_start: seed each solve with the previous natural gradient."""
    cg: CGParams = CGParams()
    diag_shift: float = 1e-3
    normalize_update: bool = False
    cg_warm_start: bool = True


@dataclasses.dataclass(frozen=True)
class MinSRParams:
    """Minimal-norm SR. diag_shift is not used (as in the reference): the
    soft cutoff lam^5 / (lam^6 + c^6), c = pseudo_inverse_cutoff * lam_max,
    regularizes. krylov_iters > 0 takes the matrix-free Lanczos path with
    that Krylov dimension (>= Ns reproduces the dense path)."""
    diag_shift: float = 1e-8
    pseudo_inverse_cutoff: float = 1e-8
    krylov_iters: int = 0


@dataclasses.dataclass(frozen=True)
class LBFGSParams:
    """L-BFGS with the two-loop recursion. line_search: "strong_wolfe"
    (bracket and bisection zoom with gradient evaluations), "armijo"
    (energy-only backtracking through evaluate_energy_only) or "fixed"
    (alpha = lr)."""
    history: int = 10
    c1: float = 1e-4       # sufficient-decrease constant
    c2: float = 0.9        # strong-Wolfe curvature constant
    line_search: str = "strong_wolfe"
    max_eval: int = 20     # evaluations per strong-Wolfe search
    min_step: float = 1e-12
    max_step: float = 1e3
    tolerance_change: float = 1e-9
    tolerance_grad: float = 0.0
    fallback_scale: float = 0.1   # fixed fallback alpha = lr*scale on failure
    max_line_search: int = 8      # armijo backtracks
    initial_step: float = 1.0


@dataclasses.dataclass(frozen=True)
class StepSelectorParams:
    """Probe the scheduled lr times each candidate with energy-only
    evaluations and keep the best."""
    candidates: tuple = (0.5, 1.0, 2.0)
    every_n: int = 0                      # 0 = only at the first iteration


@dataclasses.dataclass(frozen=True)
class SpikeParams:
    """Spike detection and recovery.

    S1: energy error bar > threshold x EMA         (before the update)
    S2: gradient norm    > threshold x EMA         (before the update)
    S3: natural-gradient norm > factor_ngrad x EMA, or at most
        sr_min_iters_suspicious CG iterations (SR and MinSR, after the
        solve)
    S4: energy above EMA mean + sigma_k x EMA std (enable_rollback)
    Actions: resample (evaluate again, up to max_retries per signal), then
    rollback: restore the last accepted state and the optimizer moments,
    the L-BFGS memory and the CG warm start as they were before it."""
    enabled: bool = False
    threshold: float = 5.0
    factor_ngrad: float = 5.0
    sr_min_iters_suspicious: int = 0
    enable_rollback: bool = False
    sigma_k: float = 6.0
    ema_alpha: float = 0.2
    max_retries: int = 2
    log_csv: str | None = None    # spike-event log


@dataclasses.dataclass(frozen=True)
class OptimizerParams:
    max_iters: int
    algorithm: object                      # one of the *Params above
    lr: LearningRateScheduler | float = 0.1
    clip_norm: float = 0.0                 # 0 = no clipping
    clip_value: float = 0.0
    spike: SpikeParams = SpikeParams()
    step_selector: StepSelectorParams | None = None
    checkpoint_every: int = 0
    checkpoint_path: str | None = None     # directory of state_step{n}.npy
    log_path: str | None = None            # JSONL per-iteration records
    trajectory_csv: str | None = None      # step,energy,energy_error
    should_stop: Callable | None = None    # (IterationRecord) -> bool
    # torch.profiler over iterations [profile_start, profile_stop); the
    # Chrome trace is written into profile_dir
    profile_dir: str | None = None
    profile_start: int = 1
    profile_stop: int = 3

    def __post_init__(self):
        if self.profile_dir is not None and \
                self.profile_stop <= self.profile_start:
            raise ValueError(
                f"profile_stop ({self.profile_stop}) must be > "
                f"profile_start ({self.profile_start})")

    def lr_at(self, step: int, energy=None) -> float:
        if isinstance(self.lr, (int, float)):
            return float(self.lr)
        return float(self.lr(step, energy))


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
    spike_events: list = []     # (step, signal, action, value, threshold)


# ---------------------------------------------------------------------------
# Update rules (out of place: see the module docstring)
# ---------------------------------------------------------------------------


def _rdot(a, b):
    """Re <a, b> over all elements, a 0-d tensor."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x))


def _clip(g, params: OptimizerParams):
    if params.clip_value > 0:
        g = torch.clamp(g, -params.clip_value, params.clip_value)
    if params.clip_norm > 0:
        n = torch.linalg.vector_norm(g)
        g = torch.where(n > params.clip_norm, g * (params.clip_norm / n), g)
    return g


def sgd_update(state, grad, lr, opt_state, p: SGDParams):
    if p.momentum == 0.0:
        return state - lr * grad, opt_state
    v = opt_state.get("v", torch.zeros_like(state))
    v = p.momentum * v + grad
    step = (grad + p.momentum * v) if p.nesterov else v
    return state - lr * step, {"v": v}


def adagrad_update(state, grad, lr, opt_state, p: AdaGradParams):
    acc = opt_state.get("acc", torch.full_like(state.real,
                                               p.initial_accumulator))
    acc = acc + grad.abs() ** 2
    return state - lr * (grad / (torch.sqrt(acc) + p.eps)), {"acc": acc}


def adam_update(state, grad, lr, opt_state, p: AdamParams):
    t = opt_state.get("t", 0) + 1
    m = opt_state.get("m", torch.zeros_like(state))
    v = opt_state.get("v", torch.zeros_like(state.real))
    m = p.beta1 * m + (1 - p.beta1) * grad
    v = p.beta2 * v + (1 - p.beta2) * grad.abs() ** 2
    mh = m / (1 - p.beta1 ** t)
    vh = v / (1 - p.beta2 ** t)
    upd = mh / (torch.sqrt(vh) + p.eps)
    if p.weight_decay:
        upd = upd + p.weight_decay * state
    return state - lr * upd, {"t": t, "m": m, "v": v}


def sr_natural_gradient(evaluation: Evaluation, p: SRParams, shape, x0=None):
    """Solve (A^H A + shift) x = g with A the centered sample matrix;
    with normalize_update the returned x is divided by sqrt(Re <x, g>)
    (the CGResult keeps the raw solution for the warm start)."""
    a = evaluation.o_samples
    g = evaluation.gradient.reshape(-1).to(a.dtype)
    shift = p.diag_shift

    def matvec(v):
        return a.mH @ (a @ v) + shift * v

    res = cg_solve(matvec, g, x0, p.cg)
    nat = res.x
    if p.normalize_update:
        tiny = torch.finfo(g.real.dtype).tiny
        nat = nat / torch.sqrt(torch.clamp(_rdot(nat, g), min=tiny))
    return nat.reshape(shape), res


def minsr_natural_gradient(evaluation: Evaluation, p: MinSRParams, shape):
    """nat = A^H f(A A^H) eps with the soft pseudo-inverse f.

    The [Ns, Ns] Gram is one product in A's dtype; its eigendecomposition
    and the filter run in float64 (``krylov.minsr_soft_filter``) and y is
    cast back. The reference filters in A's dtype, where lam^6 and c^6
    underflow to 0 in float32 and a centered Gram's round-off eigenvalue
    gives 0/0: NaN. In float64 the two agree to round-off."""
    a = evaluation.o_samples                  # [Ns, P]
    wide = torch.complex128 if a.is_complex() else torch.float64
    lam, u = torch.linalg.eigh((a @ a.mH).to(wide))
    inv = minsr_soft_filter(lam, p.pseudo_inverse_cutoff).to(wide)
    y = u @ (inv * (u.mH @ evaluation.e_samples.to(wide)))
    return (a.mH @ y.to(a.dtype)).reshape(shape)


# ---------------------------------------------------------------------------
# L-BFGS: two-loop recursion and the strong-Wolfe line search
# ---------------------------------------------------------------------------


class _LBFGSMemory:
    def __init__(self, m):
        self.m = m
        self.s = []
        self.y = []

    def push(self, s, y):
        if float(_rdot(s, y)) > 1e-12:
            self.s.append(s)
            self.y.append(y)
            if len(self.s) > self.m:
                self.s.pop(0)
                self.y.pop(0)

    def reset(self):
        self.s, self.y = [], []

    def snapshot(self):
        return (list(self.s), list(self.y))

    def restore(self, snap):
        self.s, self.y = list(snap[0]), list(snap[1])

    def direction(self, grad):
        q = grad
        alphas = []
        for s, y in zip(reversed(self.s), reversed(self.y)):
            rho = 1.0 / _rdot(y, s)
            alpha = rho * _rdot(s, q)
            q = q - alpha * y
            alphas.append((alpha, rho, s, y))
        if self.s:
            s, y = self.s[-1], self.y[-1]
            q = (_rdot(s, y) / torch.clamp(_rdot(y, y), min=1e-300)) * q
        for alpha, rho, s, y in reversed(alphas):
            beta = rho * _rdot(y, q)
            q = q + (alpha - beta) * s
        return q


def _strong_wolfe(eval_fg, phi0, dphi0, lr, p: LBFGSParams):
    """Strong-Wolfe line search: bracketing, then bisection zoom.
    ``eval_fg(alpha)`` returns (phi, dphi, candidate) at x + alpha*d.
    Returns (ok, candidate, alpha, n_evals)."""
    if dphi0 >= 0.0:
        return False, None, 0.0, 0
    curv = max(-p.c2 * dphi0, p.tolerance_grad)
    n = [0]

    def ev(a):
        n[0] += 1
        return eval_fg(a)

    def zoom(alo, phi_alo, ahi):
        while n[0] < p.max_eval:
            a = 0.5 * (alo + ahi)
            phi, dphi, cand = ev(a)
            if phi > phi0 + p.c1 * a * dphi0 or phi >= phi_alo:
                ahi = a
            else:
                if abs(dphi) <= curv:
                    return True, cand, a
                if dphi * (ahi - alo) >= 0.0:
                    ahi = alo
                alo, phi_alo = a, phi
            if abs(ahi - alo) <= p.tolerance_change:
                break
        return False, None, 0.0

    a_prev, phi_prev = 0.0, phi0
    a = min(max(lr, p.min_step), p.max_step)
    outer = 0
    while n[0] < p.max_eval:
        phi, dphi, cand = ev(a)
        if phi > phi0 + p.c1 * a * dphi0 or (outer > 0 and phi >= phi_prev):
            ok, c, al = zoom(a_prev, phi_prev, a)
            return ok, c, al, n[0]
        if abs(dphi) <= curv:
            return True, cand, a, n[0]
        if dphi >= 0.0:
            ok, c, al = zoom(a, phi, a_prev)
            return ok, c, al, n[0]
        a_prev, phi_prev = a, phi
        na = min(2.0 * a, p.max_step)
        if na - a <= p.tolerance_change:
            break
        a = na
        outer += 1
    return False, None, 0.0, n[0]


class _EMA:
    """Exponential moving average of a value and of its variance."""

    def __init__(self, alpha):
        self.alpha, self.mean, self.var = alpha, None, 0.0

    @property
    def initialized(self):
        return self.mean is not None

    def update(self, x):
        if self.mean is None:
            self.mean, self.var = x, 0.0
        else:
            a = self.alpha
            d = x - self.mean
            self.mean += a * d
            self.var = (1 - a) * (self.var + a * d * d)

    @property
    def std(self):
        return math.sqrt(max(self.var, 0.0))


# ---------------------------------------------------------------------------
# The iterative loop
# ---------------------------------------------------------------------------


def _open_log(stack, path, header=None):
    """Open path for appending; write header only into a new or empty file
    (the reference writes it on every open, so a resumed run's CSV holds
    one header per run)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path) or os.path.getsize(path) == 0
    f = stack.enter_context(open(path, "a"))
    if header and new:
        f.write(header)
    return f


class _Profile:
    """torch.profiler over a window of iterations; stop() writes the Chrome
    trace ``trace_steps{start}-{stop}.json`` into the directory."""

    def __init__(self, directory, device, start):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.directory, self.start_step = directory, start
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self, stop_step):
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.directory,
            f"trace_steps{self.start_step}-{stop_step}.json"))


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def iterative_optimize(state: torch.Tensor,
                       evaluate: Callable[[torch.Tensor, int], Evaluation],
                       params: OptimizerParams,
                       evaluate_energy_only: Callable | None = None,
                       callback: Callable | None = None) -> OptimizeResult:
    """The optimization loop: evaluate, check for spikes, update, record.

    ``evaluate(state, step)`` returns an Evaluation, with o_samples and
    e_samples for SR and MinSR. ``evaluate_energy_only(state)`` returns an
    energy without moving the sampler; it powers the step selector and the
    Armijo line search. The iteration's energy, error, gradient norm and
    solver statistics are read back to the host once, for the record;
    update_seconds ends with a device synchronization, so it holds the
    update's device time."""
    alg = params.algorithm
    sp = params.spike
    opt_state: dict = {}
    lbfgs_mem = _LBFGSMemory(alg.history) if isinstance(alg, LBFGSParams) \
        else None
    prev_state, prev_grad = state, None
    energies, records, spike_events = [], [], []
    lowest_e, lowest_state = math.inf, state
    ema_err, ema_gnorm = _EMA(sp.ema_alpha), _EMA(sp.ema_alpha)
    ema_ngrad, ema_energy = _EMA(sp.ema_alpha), _EMA(sp.ema_alpha)
    accepted = None   # rollback snapshot: last accepted state and moments
    nat_x0 = None
    profile = None

    def rollback():
        """Restore the last accepted state and its optimizer state as they
        were before its update."""
        nonlocal state, opt_state, prev_grad, nat_x0
        if accepted is None:
            return False
        state = accepted["state"]
        opt_state = dict(accepted["opt_state"])
        if lbfgs_mem is not None:
            lbfgs_mem.restore(accepted["lbfgs"])
        prev_grad = None
        nat_x0 = accepted["nat_x0"]
        return True

    with contextlib.ExitStack() as files:
        log_f = _open_log(files, params.log_path) if params.log_path \
            else None
        traj_f = _open_log(files, params.trajectory_csv,
                           "step,energy,energy_error\n") \
            if params.trajectory_csv else None
        spike_f = _open_log(files, sp.log_csv,
                            "step,signal,action,value,threshold\n") \
            if sp.log_csv else None

        def log_spike(step, signal, action, value, thr):
            spike_events.append((step, signal, action, value, thr))
            if spike_f:
                spike_f.write(f"{step},{signal},{action},{value!r},{thr!r}\n")
                spike_f.flush()

        try:
            for step in range(params.max_iters):
                if params.profile_dir is not None:
                    if step == params.profile_start and profile is None:
                        profile = _Profile(params.profile_dir, state.device,
                                           step)
                    if step == params.profile_stop and profile is not None:
                        profile.stop(step)
                        profile = None
                t0 = time.perf_counter()
                ev = evaluate(state, step)

                # ---- S1/S2: error-bar or gradient-norm anomaly ----
                if sp.enabled:
                    retries = 0
                    while True:
                        err_v = float(ev.energy_error) \
                            if ev.energy_error is not None else 0.0
                        gn_v = _norm(ev.gradient)
                        signal = None
                        if ema_err.initialized and ema_err.mean > 0 and \
                                err_v > sp.threshold * ema_err.mean:
                            signal, val, thr = ("S1", err_v,
                                                sp.threshold * ema_err.mean)
                        elif ema_gnorm.initialized and ema_gnorm.mean > 0 \
                                and gn_v > sp.threshold * ema_gnorm.mean:
                            signal, val, thr = ("S2", gn_v,
                                                sp.threshold * ema_gnorm.mean)
                        if signal is None:
                            break
                        if retries < sp.max_retries:
                            log_spike(step, signal, "resample", val, thr)
                            retries += 1
                            # drop the rejected evaluation first: its
                            # [Ns, P] buffer would otherwise be held twice
                            ev = None
                            ev = evaluate(state, step)
                            continue
                        log_spike(step, signal, "rollback", val, thr)
                        if rollback():
                            ev = None
                            ev = evaluate(state, step)
                        break

                # ---- S4: upward energy spike -> rollback ----
                if sp.enable_rollback and ema_energy.initialized and step > 0:
                    e_v = float(ev.energy)
                    delta = e_v - ema_energy.mean
                    if delta > 0 and ema_energy.std > 0 and \
                            delta > sp.sigma_k * ema_energy.std:
                        log_spike(step, "S4", "rollback", e_v,
                                  ema_energy.mean
                                  + sp.sigma_k * ema_energy.std)
                        if rollback():
                            ev = None
                            ev = evaluate(state, step)
                energy = float(ev.energy)
                eval_s = time.perf_counter() - t0

                err = float(ev.energy_error) \
                    if ev.energy_error is not None else 0.0
                gn = _norm(ev.gradient)
                ema_err.update(err)
                ema_gnorm.update(gn)
                ema_energy.update(energy)
                energies.append(energy)
                if energy < lowest_e:
                    lowest_e, lowest_state = energy, state

                lr = params.lr_at(step, energy)
                grad = _clip(ev.gradient, params)

                # ---- step selector: energy-only probes ----
                sel = params.step_selector
                if sel is not None and evaluate_energy_only is not None and (
                        step == 0 or (sel.every_n and step % sel.every_n == 0)):
                    best_lr, best_e = lr, None
                    for mult in sel.candidates:
                        e_c = float(evaluate_energy_only(
                            state - (lr * mult) * grad))
                        if best_e is None or e_c < best_e:
                            best_e, best_lr = e_c, lr * mult
                    lr = best_lr

                # rollback snapshot: this state's evaluation passed, the
                # moments as they are before this iteration's update
                pre_snapshot = {
                    "state": state, "opt_state": dict(opt_state),
                    "lbfgs": lbfgs_mem.snapshot() if lbfgs_mem is not None
                    else None,
                    "nat_x0": nat_x0}

                # ---- update ----
                t1 = time.perf_counter()
                sr_iters, sr_res, nat_norm = 0, 0.0, 0.0
                skip_update = False
                if isinstance(alg, SGDParams):
                    new_state, opt_state = sgd_update(state, grad, lr,
                                                      opt_state, alg)
                elif isinstance(alg, AdaGradParams):
                    new_state, opt_state = adagrad_update(state, grad, lr,
                                                          opt_state, alg)
                elif isinstance(alg, AdamParams):
                    new_state, opt_state = adam_update(state, grad, lr,
                                                       opt_state, alg)
                elif isinstance(alg, (SRParams, MinSRParams)):
                    s3_attempts = 0
                    while True:
                        if isinstance(alg, SRParams):
                            nat, res = sr_natural_gradient(
                                ev, alg, state.shape, x0=nat_x0)
                            sr_iters = int(res.iterations)
                            sr_res = float(res.residual_norm)
                            few_iters = sr_iters <= sp.sr_min_iters_suspicious
                        elif alg.krylov_iters > 0:
                            nat = minsr_krylov_natural_gradient(
                                ev.o_samples, ev.e_samples,
                                alg.pseudo_inverse_cutoff, alg.krylov_iters,
                                state.shape)
                            few_iters = False
                        else:
                            nat = minsr_natural_gradient(ev, alg,
                                                         state.shape)
                            few_iters = False
                        nat_norm = _norm(nat)
                        # ---- S3: natural-gradient anomaly ----
                        if not (sp.enabled and step > 0):
                            break
                        s3 = few_iters or (
                            ema_ngrad.initialized and ema_ngrad.mean > 0 and
                            nat_norm > sp.factor_ngrad * ema_ngrad.mean)
                        if not s3:
                            break
                        thr = sp.factor_ngrad * (ema_ngrad.mean or 0.0)
                        if s3_attempts < sp.max_retries:
                            log_spike(step, "S3", "resample", nat_norm, thr)
                            s3_attempts += 1
                            ev = None
                            ev = evaluate(state, step)
                            continue
                        log_spike(step, "S3", "rollback", nat_norm, thr)
                        rollback()
                        skip_update = True
                        break
                    if skip_update:
                        new_state = state
                    else:
                        if isinstance(alg, SRParams) and alg.cg_warm_start:
                            nat_x0 = res.x.reshape(-1)
                        ema_ngrad.update(nat_norm)
                        new_state = state - lr * nat.to(state.dtype)
                elif isinstance(alg, LBFGSParams):
                    new_state = _lbfgs_step(
                        alg, lbfgs_mem, state, grad, prev_state, prev_grad,
                        lr, energy, gn, step, evaluate, evaluate_energy_only)
                else:
                    raise ValueError(f"unknown algorithm {alg!r}")
                _sync(new_state)
                upd_s = time.perf_counter() - t1

                if not skip_update:
                    # an S3-rejected state must not become the anchor
                    accepted = pre_snapshot
                    prev_state, prev_grad = state, grad
                state = new_state

                rec = IterationRecord(
                    step, energy, err, gn, lr,
                    float(ev.accept_rate) if ev.accept_rate is not None
                    else 1.0,
                    sr_iters, sr_res, nat_norm, eval_s, upd_s)
                records.append(rec)
                if log_f:
                    d = rec._asdict()
                    if ev.aux:
                        d.update({k: v for k, v in ev.aux.items()
                                  if k not in d})
                    log_f.write(json.dumps(d) + "\n")
                    log_f.flush()
                if traj_f:
                    traj_f.write(f"{step},{energy!r},{err!r}\n")
                    traj_f.flush()
                if params.checkpoint_every and params.checkpoint_path and \
                        (step + 1) % params.checkpoint_every == 0:
                    os.makedirs(params.checkpoint_path, exist_ok=True)
                    np.save(os.path.join(params.checkpoint_path,
                                         f"state_step{step + 1}.npy"),
                            state.detach().cpu().numpy())
                if callback is not None:
                    callback(rec, state)
                if params.should_stop is not None and params.should_stop(rec):
                    break
        finally:
            if profile is not None:
                # a stop index the loop never reached
                profile.stop(len(records))
    return OptimizeResult(state, lowest_state, energies, lowest_e, records,
                          spike_events)


def _lbfgs_step(alg: LBFGSParams, mem: _LBFGSMemory, state, grad, prev_state,
                prev_grad, lr, energy, gn, step, evaluate,
                evaluate_energy_only):
    """One L-BFGS update: push the curvature pair (x_k - x_{k-1},
    g_k - g_{k-1}), take the two-loop direction (reset to -g when it is
    not a descent direction) and step along it by the line search."""
    if prev_grad is not None:
        mem.push(state - prev_state, grad - prev_grad)
    direction = -mem.direction(grad)
    gd = float(_rdot(grad, direction))
    if gd >= 0.0:
        mem.reset()
        direction = -grad
        gd = -float(_rdot(grad, grad))
    if alg.line_search == "fixed":
        return state + lr * direction
    if alg.line_search == "armijo":
        e_only = evaluate_energy_only or (
            lambda s: evaluate(s, step).energy)
        step_len = lr if step > 0 else min(
            lr, alg.initial_step / max(gn, 1e-12))
        for _ in range(alg.max_line_search):
            if float(e_only(state + step_len * direction)) <= \
                    energy + alg.c1 * step_len * gd:
                return state + step_len * direction
            step_len *= 0.5
        return state - lr * grad
    if alg.line_search == "strong_wolfe":
        def eval_fg(alpha):
            cand = state + alpha * direction
            ev_c = evaluate(cand, step)
            return (float(ev_c.energy),
                    float(_rdot(ev_c.gradient, direction)), cand)
        ok, cand, _, _ = _strong_wolfe(eval_fg, energy, gd, lr, alg)
        if ok:
            return cand
        return state + max(alg.min_step, lr * alg.fallback_scale) * direction
    raise ValueError(f"unknown L-BFGS line_search {alg.line_search!r}")
