"""Monte Carlo energy/gradient evaluator (port of
``peps_tpu/algorithm/mc_evaluator.py``).

Per sample step: one sweep of every chain, then local energies and holes of
every chain. The bottom env stacks built for the evaluation are handed to
the next step's first sweep (the pre-sweep network is exactly the evaluated
one), as in the reference. For SR and MinSR the holes of all steps are
kept and the centered, scaled sample matrix is written once by kernel K2; the
un-centered O buffer is never formed. ``MCParams.eval_chunk`` runs the local
energies and holes over slices of that many chains; as in the reference,
the env stacks stay at full chain batch, so it bounds only the table and
hole intermediates. The reference's 1D flattening of the holes is a TPU
tile-padding workaround and is not ported.

Three kinds of model take this loop: bosonic ``ModelTensors``, fermionic
models in the Jordan-Wigner representation (``FermionTensors``: the
bosonic sweep and ratio tables with string signs) and graded fermionic
states (``GradedFermionModel``: the env-shared graded sweep, without the
carried bottom stacks, and the graded local energy, whose holes are the
O entries at the configuration and go to K2 with psi_loc = 1).

On the torus (``bc=PERIODIC``, bosonic models only) a sample step is a
torus sweep (:mod:`~peps_tpu_torch.montecarlo.sweep_pbc`: the full
recompute, or the frozen trial/commit sweep with ``MCParams.trial_sweep``)
and the torus local energy of
:mod:`~peps_tpu_torch.algorithm.energy_pbc`; its holes and mantissa (as
psi_loc, the same at every site) go to K2 as the OBC ones do. Each sweep's
uniforms are then one tensor [nc, 2 Ly Lx].
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from peps_tpu_torch.algorithm.energy import (_local_energy, model_kind,
                                             o_tensor_of)
from peps_tpu_torch.algorithm.energy_fermion import jw_tables_and_energy
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.kernels.centered_o import centered_o
from peps_tpu_torch.lattice import BoundaryCondition, transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.statistics import mean_and_binned_error
from peps_tpu_torch.montecarlo.sweep import UpdateRule, mc_sweep
from peps_tpu_torch.montecarlo.sweep_pbc import (mc_sweep_pbc,
                                                 mc_sweep_pbc_trial)
from peps_tpu_torch.optimizer.optimizer import Evaluation
from peps_tpu_torch.tps import project


@dataclasses.dataclass(frozen=True)
class MCParams:
    num_samples: int = 100          # sample steps per chain
    num_warmup_sweeps: int = 100
    sweeps_between_samples: int = 1
    nchains: int = 64
    # chains per local-energy pass (None: all at once); the env stacks stay
    # at full chain batch, so it bounds the table and hole intermediates
    eval_chunk: int | None = None
    # torus only: the sample sweeps recompute the whole contraction per
    # proposal (False, the reference's default off the TPU) or go through
    # the frozen trial/commit cache (True: cheaper a sweep, but biased at a
    # truncating chi, ROADMAP section 3)
    trial_sweep: bool = False


UniformSource = Callable[[], tuple]


def require_bosonic_for_pbc(model, bc) -> None:
    """Periodic boundaries contract through the coarse-graining
    contractor, which is boson-only as the reference's: a fermionic model
    with ``bc=PERIODIC`` is refused (ValueError), as the reference's
    ``require_bosonic_for_pbc``."""
    if bc != BoundaryCondition.PERIODIC:
        return
    if model_kind(model) in ("jw", "graded") or hasattr(model, "channels_h"):
        raise ValueError(
            "periodic boundaries use the coarse-graining contractor, which "
            "is boson-only (as the reference's); fermionic models require "
            "BoundaryCondition.OPEN")


def _periodic(bc) -> bool:
    return bc is not None and bc == BoundaryCondition.PERIODIC


def _local_fn(tps, model, chi, trunc, with_grad, bc=None):
    """local(configs, stacks) -> (e_loc, holes [n, Ly, Lx, D, D, D, D] or
    None, psi_loc [n, Ly, Lx] or None, log|psi|) of the model's kind (on
    the torus: the torus local energy, psi_loc the mantissa at every
    site)."""
    kind = model_kind(model)
    if _periodic(bc):
        from peps_tpu_torch.algorithm.energy_pbc import pbc_energy_and_holes

        def local(c, stacks):
            e, holes, mant, log_abs = pbc_energy_and_holes(
                tps, c, model, chi, trunc, with_grad)
            psi = None if holes is None else \
                mant[:, None, None].expand(c.shape)
            return e, holes, psi, log_abs
        return local
    if kind == "jw":
        def local(c, stacks):
            e, tabs = jw_tables_and_energy(tps, c, model, chi, trunc,
                                           with_grad, stacks)
            return e, tabs.holes, tabs.psi_loc, tabs.log_abs_psi
        return local
    if kind == "graded":
        from peps_tpu_torch.fermion.vmc import graded_energy_and_holes

        def local(c, stacks):
            e, holes, log_abs, _ = graded_energy_and_holes(
                tps, c, model, chi, trunc, with_grad)
            psi = None if holes is None else torch.ones(
                holes.shape[:3], dtype=holes.dtype, device=holes.device)
            return e, holes, psi, log_abs
        return local

    def local(c, stacks):
        e, rp, log_abs, _ = _local_energy(tps, c, model, chi, trunc, stacks)
        return e, rp.holes, rp.psi_loc, log_abs
    return local


def _sweep_fn(tps, model, chi, trunc, rule, bc=None, trial_sweep=False):
    """(sweep, shares_stacks): sweep(configs, uniforms, bots) ->
    (configs', accepted, trials) of the model's kind; bots None for the
    graded sweep, which builds its own bottom stacks, and for the torus
    sweeps (trial_sweep: the frozen trial/commit sweep, else the full
    recompute)."""
    if _periodic(bc):
        def sweep(configs, uniforms, bots):
            if trial_sweep:
                configs, st = mc_sweep_pbc_trial(tps, configs, chi, trunc,
                                                 rule, uniforms)
            else:
                configs, st = mc_sweep_pbc(tps, configs, chi, trunc, rule,
                                           uniforms)
            return configs, st.accepted.sum(), st.trials.sum()
        return sweep, False
    if model_kind(model) == "graded":
        from peps_tpu_torch.fermion.sweep import mc_sweep_fermion_shared

        def sweep(configs, uniforms, bots):
            configs, st = mc_sweep_fermion_shared(tps, model.space, configs,
                                                  chi, trunc, uniforms)
            return configs, st.accepted.sum(), st.trials.sum()
        return sweep, False
    tps_t = transpose_tps(tps)

    def sweep(configs, uniforms, bots):
        configs, st = mc_sweep(tps, tps_t, configs, chi, trunc,
                               uniforms=uniforms, bots=bots, rule=rule)
        return configs, st.accepted, st.trials
    return sweep, True


def _mc_collect(tps, configs, model, chi, trunc, n_samples,
                with_sr, uniform_source, rule: UpdateRule = UpdateRule(),
                sweeps_between: int = 1, with_grad: bool = True,
                eval_chunk: int | None = None, bc=None,
                trial_sweep: bool = False):
    """Sample loop: sweeps_between sweeps per sample step, the first one
    from the evaluated network's bottom stack (bosonic and JW models on
    open boundaries); the local energies and holes of eval_chunk chains at
    a time (None: all). On the torus the sweep is trial_sweep's (see
    :func:`_sweep_fn`).
    Returns (configs', accepted, trials, outs) with outs a dict: e_locs
    [S, nc], log_psi [S, nc]; with SR: holes [S, nc, Ly, Lx, D^4], psi_loc
    [S, nc, Ly, Lx], cfgs [S, nc, Ly, Lx]; with a plain gradient: o_sum and
    eo_sum [P] (sums of O and E_loc O over samples); with_grad=False keeps
    the energies only."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    configs = configs.long()
    sweep, shares_stacks = _sweep_fn(tps, model, chi, trunc, rule, bc,
                                     trial_sweep)
    local = _local_fn(tps, model, chi, trunc, with_grad, bc)
    bots = None
    if shares_stacks:
        ftops, _ = bmps.all_top_envs(bmps.flip_vertical(project(tps,
                                                                configs)),
                                     chi, trunc)
        bots = torch.flip(ftops, [-5])
    acc = torch.zeros((), dtype=torch.int64, device=tps.device)
    tri = torch.zeros_like(acc)
    outs = {"e_locs": [], "log_psi": [], "holes": [], "psi_loc": [],
            "cfgs": []}
    o_sum = eo_sum = None
    for _ in range(n_samples):
        for i in range(sweeps_between):
            configs, a, t = sweep(configs, uniform_source(),
                                  bots if i == 0 else None)
            acc = acc + a
            tri = tri + t
        stacks = None
        if shares_stacks:
            stacks = bmps.all_env_stacks(project(tps, configs), chi, trunc)
            bots = stacks.bots
        nc = configs.shape[0]
        step = {k: [] for k in ("e_locs", "log_psi", "holes", "psi_loc")}
        for sl in bmps.chain_slices(nc, eval_chunk):
            c = configs[sl]
            e, holes, psi_loc, log_abs = local(c, bmps.sub_stacks(stacks,
                                                                  sl))
            step["e_locs"].append(e)
            step["log_psi"].append(log_abs)
            if not with_grad:
                continue
            if with_sr:
                step["holes"].append(holes.reshape(c.shape[0], ly, lx, -1))
                step["psi_loc"].append(psi_loc)
            else:
                o = o_tensor_of(holes, psi_loc, c, d).reshape(c.shape[0], -1)
                step_o = o.conj().sum(0)
                step_eo = (e[:, None] * o.conj()).sum(0)
                o_sum = step_o if o_sum is None else o_sum + step_o
                eo_sum = step_eo if eo_sum is None else eo_sum + step_eo
        for k, parts in step.items():
            if parts:
                outs[k].append(torch.cat(parts))
        if with_grad and with_sr:
            outs["cfgs"].append(configs)
    outs = {k: torch.stack(v) for k, v in outs.items() if v}
    if o_sum is not None:
        outs["o_sum"], outs["eo_sum"] = o_sum, eo_sum
    return configs, acc, tri, outs


def _center_scale(holes, psi_loc, cfgs, d):
    """The centered, sqrt(Ns)-scaled SR sample matrix a [Ns, P] through
    kernel K2; holes [S, nc, Ly, Lx, K], psi_loc/cfgs [S, nc, Ly, Lx]."""
    s, nc, ly, lx, k = holes.shape
    ns = s * nc
    return centered_o(holes.reshape(ns, ly * lx, k),
                      psi_loc.reshape(ns, ly * lx),
                      cfgs.reshape(ns, ly * lx), d)


def mc_energy_only(tps, configs, model, chi: int,
                   trunc: TruncParams, rule: UpdateRule, n_samples: int,
                   uniform_source: UniformSource, sweeps_between: int = 1,
                   eval_chunk: int | None = None,
                   bc: BoundaryCondition = BoundaryCondition.OPEN,
                   trial_sweep: bool = False):
    """Energy-only MC estimate, no holes kept and no gradient (the
    reference's EvaluateEnergyOnly); eval_chunk and trial_sweep as in
    MCParams. Returns (energy, stderr) as 0-d tensors."""
    require_bosonic_for_pbc(model, bc)
    _, _, _, outs = _mc_collect(tps, configs, model, chi, trunc, n_samples,
                                False, uniform_source, rule, sweeps_between,
                                with_grad=False, eval_chunk=eval_chunk,
                                bc=bc, trial_sweep=trial_sweep)
    return mean_and_binned_error(outs["e_locs"].real)


def mc_energy_grad(tps, configs, model, chi: int,
                   trunc: TruncParams, params: MCParams,
                   uniform_source: UniformSource,
                   with_sr_buffers: bool = False,
                   rule: UpdateRule = UpdateRule(),
                   bc: BoundaryCondition = BoundaryCondition.OPEN):
    """One VMC energy/gradient estimate. Returns (Evaluation, configs',
    log_psi [S, nc]).

    g = 2 Re <conj(O) (E_loc - E)> for a real state, as the reference.
    uniform_source() returns each sweep's uniforms ((u_h, u_v) on open
    boundaries, [nc, 2 Ly Lx] on the torus). Reads one integer (the
    non-finite sample count) back to the host."""
    require_bosonic_for_pbc(model, bc)
    configs, acc, tri, outs = _mc_collect(
        tps, configs, model, chi, trunc, params.num_samples, with_sr_buffers,
        uniform_source, rule, params.sweeps_between_samples,
        eval_chunk=params.eval_chunk, bc=bc, trial_sweep=params.trial_sweep)
    e_locs = outs["e_locs"]
    s, c = e_locs.shape
    n = s * c
    energy, err = mean_and_binned_error(e_locs.real)
    nonfinite = int((~torch.isfinite(e_locs.real)).sum())
    aux = {"nonfinite_samples": nonfinite} if nonfinite else None
    accept = acc / torch.clamp(tri, min=1)
    real = not tps.is_complex()
    if with_sr_buffers:
        a = _center_scale(outs["holes"], outs["psi_loc"], outs["cfgs"],
                          tps.shape[2])
        root = torch.sqrt(torch.tensor(float(n), dtype=a.dtype,
                                       device=a.device))
        eps = (e_locs.reshape(n) - energy).to(a.dtype) / root
        if real:
            eps = 2.0 * eps
        grad = a.mH @ eps
        if real:
            grad = grad.real
        grad = grad.reshape(tps.shape).to(tps.dtype)
        ev = Evaluation(energy, grad, err, a, eps, accept, aux)
    else:
        grad = outs["eo_sum"] / n - energy * (outs["o_sum"] / n)
        if real:
            grad = 2.0 * grad.real
        ev = Evaluation(energy, grad.reshape(tps.shape).to(tps.dtype), err,
                        None, None, accept, aux)
    return ev, configs, outs["log_psi"]
