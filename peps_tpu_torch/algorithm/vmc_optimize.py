"""VMC optimization executor (port of
``peps_tpu/algorithm/vmc_optimize.py``): initial configurations ->
validity rescue -> state normalization -> warm-up sweeps ->
:func:`iterative_optimize` over :func:`mc_energy_grad`.

Randomness comes from one ``torch.Generator`` on the state's device:
configurations, the rescue donors, every sweep's uniforms and the uniforms
of the energy-only probes (step selector, Armijo line search). The parity
tests replace the last two with the reference's replayed uniforms
(``sweep_uniforms``, ``probe_uniforms``) and pass the reference's initial
configurations. Bosonic models, fermionic models in the Jordan-Wigner
representation (the bosonic sweep, e.g. Suwa-Todo with a conservation
mask) and graded fermionic states (a ``GradedFermionModel``: the graded
rescue, normalization and env-shared sweep).

On the torus (``bc=PERIODIC``, bosonic models; fermionic ones are refused,
as the reference refuses them) the warm-up sweeps recompute the whole
contraction per proposal, as the reference's do on every backend; the
sample sweeps and the energy-only probes follow ``MCParams.trial_sweep``
(default: the full recompute). Each sweep's uniforms are one
tensor [nc, 2 Ly Lx]. As in the reference, the validity rescue and the
state normalization read the open-boundary amplitude
(:func:`~peps_tpu_torch.montecarlo.engine.amplitudes`) on the torus too: a
known fault of the reference, kept so that the trajectories are its own.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from peps_tpu_torch.algorithm.energy import model_kind, model_tensors
from peps_tpu_torch.algorithm.mc_evaluator import (MCParams, _sweep_fn,
                                                   mc_energy_grad,
                                                   mc_energy_only,
                                                   require_bosonic_for_pbc)
from peps_tpu_torch.lattice import BoundaryCondition
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.engine import (ensure_validity,
                                              init_configs_occupancy,
                                              init_configs_uniform,
                                              normalize_state_order1)
from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
from peps_tpu_torch.montecarlo.sweep_pbc import draw_uniforms_pbc
from peps_tpu_torch.optimizer.optimizer import (MinSRParams, OptimizerParams,
                                                SRParams, iterative_optimize)


@dataclasses.dataclass(frozen=True)
class VMCParams:
    chi: int
    trunc: TruncParams
    mc: MCParams
    optimizer: OptimizerParams
    rule: UpdateRule = UpdateRule("exchange")
    occupancy: tuple | None = None   # ((state, count), ...) or None = uniform
    bc: BoundaryCondition = BoundaryCondition.OPEN


class VMCResult(NamedTuple):
    state: torch.Tensor
    lowest_state: torch.Tensor
    energies: list
    lowest_energy: float
    records: list
    final_configs: torch.Tensor
    spike_events: list = []     # (step, signal, action, value, threshold)


def vmc_optimize(tps: torch.Tensor, model, params: VMCParams,
                 generator: torch.Generator | None = None,
                 configs: torch.Tensor | None = None,
                 sweep_uniforms: Callable[[], tuple] | None = None,
                 callback=None,
                 probe_uniforms: Callable[[], tuple] | None = None
                 ) -> VMCResult:
    """Optimize a real or complex OBC TPS for a bosonic model, a JW
    fermionic model or a graded fermionic state (``GradedFermionModel``),
    or a real torus TPS for a bosonic model (``params.bc``), on tps.device
    (the kernels take float32, float64, complex64 and complex128).

    generator: a ``torch.Generator`` on tps.device (default: seeded 0).
    configs: optional initial configurations [nc, Ly, Lx] (default: drawn
    from params.occupancy). sweep_uniforms: optional callable returning each
    sweep's uniforms in order, the warm-up's first ((u_h, u_v); on the
    torus [nc, 2 Ly Lx]; default: drawn from generator).
    probe_uniforms: the same for the sweeps of the energy-only probes
    (default: drawn from generator; the reference keys probe n with
    fold_in(sampler key, n) instead). A probe samples from the current
    configurations and leaves them as they were."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    dev = tps.device
    if getattr(model, "phys_dim", d) != d:
        raise ValueError(f"model physical dimension {model.phys_dim} != TPS "
                         f"physical dimension {d} (tps shape {tps.shape})")
    mt = model_tensors(model, tps.dtype, dev, "vmc_optimize")
    require_bosonic_for_pbc(mt, params.bc)
    periodic = params.bc == BoundaryCondition.PERIODIC
    graded = model_kind(mt) == "graded"
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    nc = params.mc.nchains if configs is None else configs.shape[0]

    def draw():
        if periodic:
            return draw_uniforms_pbc(generator, nc, ly, lx, rdt, dev)
        return draw_uniforms(generator, nc, ly, lx, rdt, dev)

    sweep_uniforms = sweep_uniforms or draw
    probe_uniforms = probe_uniforms or draw

    if configs is None:
        if params.occupancy is not None:
            configs = init_configs_occupancy(generator, params.mc.nchains, ly,
                                             lx, dict(params.occupancy), dev)
        else:
            configs = init_configs_uniform(generator, params.mc.nchains, ly,
                                           lx, d, dev)
    configs = configs.to(dev).long()
    if graded:
        from peps_tpu_torch.fermion.vmc import (
            ensure_validity_fermion, normalize_state_order1_fermion)
        configs, _ = ensure_validity_fermion(tps, configs, generator,
                                             mt.space, params.chi,
                                             params.trunc)
        tps = normalize_state_order1_fermion(tps, configs, mt.space,
                                             params.chi, params.trunc)
    else:
        configs, _ = ensure_validity(tps, configs, generator, params.chi,
                                     params.trunc)
        tps = normalize_state_order1(tps, configs, params.chi, params.trunc)
    sweep, _ = _sweep_fn(tps, mt, params.chi, params.trunc, params.rule,
                         params.bc, trial_sweep=False)
    for _ in range(params.mc.num_warmup_sweeps):
        configs, _, _ = sweep(configs, sweep_uniforms(), None)

    sampler = {"configs": configs}
    needs_sr = isinstance(params.optimizer.algorithm,
                          (SRParams, MinSRParams))

    def evaluate(state, step):
        ev, cfgs, _ = mc_energy_grad(
            state, sampler["configs"], mt, params.chi, params.trunc,
            params.mc, sweep_uniforms,
            with_sr_buffers=needs_sr, rule=params.rule, bc=params.bc)
        sampler["configs"] = cfgs
        return ev

    def evaluate_energy_only(state):
        e, _ = mc_energy_only(state, sampler["configs"], mt, params.chi,
                              params.trunc, params.rule,
                              params.mc.num_samples, probe_uniforms,
                              params.mc.sweeps_between_samples,
                              eval_chunk=params.mc.eval_chunk, bc=params.bc,
                              trial_sweep=params.mc.trial_sweep)
        return e

    result = iterative_optimize(tps, evaluate, params.optimizer,
                                evaluate_energy_only=evaluate_energy_only,
                                callback=callback)
    return VMCResult(result.state, result.lowest_state, result.energies,
                     result.lowest_energy, result.records,
                     sampler["configs"], result.spike_events)
