"""The torus sampler through the port's entry points against the JAX
package, in float64: mc_energy_grad(bc=PERIODIC), two SR iterations of
vmc_optimize and one measure(), each driven by the uniforms the
reference's key stream gives.

Samplers: the port's full recompute (MCParams.trial_sweep=False, the
default) is held to the reference's scanned collect (its MCParams()
default off the TPU); the port's frozen trial sweep (trial_sweep=True) to
the reference with host_sweep=True, where its default is the frozen trial
sweep (the example's path). A 2x4 torus, D=2, chi=8 (truncating), 3 chains.

Tolerances: energies 1e-10 relative; gradients and the SR buffers 1e-9
relative (the holes come from autograd through SVDs in both packages);
after two SR iterations the state within 1e-8 relative (the CG solve
amplifies input differences by the condition number of S + shift);
configurations, accept rates and measured statistics exactly or within
1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import mc_evaluator as j_mce
from peps_tpu.algorithm import measure as j_measure
from peps_tpu.algorithm import vmc_optimize as j_vmc
from peps_tpu.algorithm.energy import ModelTensors as JModelTensors
from peps_tpu.lattice import BoundaryCondition as JBC
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo.engine import init_configs_occupancy
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.optimizer import optimizer as j_opt
from peps_tpu.optimizer.cg import CGParams as JCG
from peps_tpu_torch.algorithm import measure
from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
from peps_tpu_torch.lattice import BoundaryCondition
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from peps_tpu_torch.optimizer import optimizer as t_opt
from peps_tpu_torch.optimizer.cg import CGParams
from tests.test_torch_pbc import rel
from tests.test_torch_pbc_sweep import jax_pbc_uniforms

LY, LX, D, CHI, NC = 2, 4, 2, 8, 3
PBC, JPBC = BoundaryCondition.PERIODIC, JBC.PERIODIC


def inputs(seed):
    rng = np.random.default_rng(seed)
    tps = rng.normal(size=(LY, LX, 2, D, D, D, D)) * 0.5
    cfg = np.stack([rng.permutation([0, 1] * (LY * LX // 2)).reshape(LY, LX)
                    for _ in range(NC)])
    return tps, cfg


def collect_uniforms(key, n_sweeps):
    """The uniforms of n_sweeps sweeps of the reference's sample loop: per
    sweep split(key, nc + 1), the chains from [1:], the key from [0]."""
    out = []
    for _ in range(n_sweeps):
        keys = jax.random.split(key, NC + 1)
        key = keys[0]
        out.append(jax_pbc_uniforms(keys[1:], LY, LX))
    return out


@pytest.mark.parametrize("trial", [False, True])
@pytest.mark.parametrize("with_sr", [True, False])
def test_mc_energy_grad_pbc_matches_reference(trial, with_sr):
    tps, cfg = inputs(5)
    key = jax.random.PRNGKey(6)
    n_samples = 2
    jparams = j_mce.MCParams(num_samples=n_samples, nchains=NC,
                             host_sweep=True if trial else None)
    want, wcfg, _, wlog = j_mce.mc_energy_grad(
        jnp.asarray(tps), jnp.asarray(cfg), key,
        JModelTensors.from_model(j_spin.heisenberg(), jnp.float64), CHI,
        JTrunc(CHI, 1, 0.0), JRule("exchange"), jparams,
        with_sr_buffers=with_sr, bc=JPBC)
    it = iter(collect_uniforms(key, n_samples))
    got, gcfg, glog = mc_energy_grad(
        torch.as_tensor(tps), torch.as_tensor(cfg),
        ModelTensors.from_model(spin.heisenberg(), torch.float64, "cpu"),
        CHI, TruncParams(CHI, 1, 0.0),
        MCParams(num_samples=n_samples, nchains=NC, trial_sweep=trial),
        lambda: next(it), with_sr_buffers=with_sr, bc=PBC)
    assert np.array_equal(gcfg.numpy(), np.asarray(wcfg))
    assert abs(float(got.energy) - float(want.energy)) \
        < 1e-10 * abs(float(want.energy))
    assert rel(got.gradient, want.gradient) < 1e-9
    assert float(got.accept_rate) == pytest.approx(float(want.accept_rate),
                                                   abs=1e-12)
    assert 0 < float(got.accept_rate) < 1
    assert rel(glog, wlog) < 1e-10
    if with_sr:
        assert rel(got.o_samples, want.o_samples) < 1e-9
        assert rel(got.e_samples, want.e_samples) < 1e-9
    else:
        assert got.o_samples is None and want.o_samples is None


def _vmc_case(trial):
    """Two SR iterations from the same configurations: the warm-up by full
    recompute (both packages), the samples by the frozen trial sweep
    (trial) or the full recompute."""
    tps, _ = inputs(7)
    seed = jax.random.PRNGKey(8)
    occ = ((0, 4), (1, 4))
    n_warm, n_samples, iters = 1, 2, 2
    jparams = j_vmc.VMCParams(
        CHI, JTrunc(CHI, 1, 0.0),
        j_mce.MCParams(num_samples=n_samples, num_warmup_sweeps=n_warm,
                       nchains=NC, host_sweep=True if trial else None),
        j_opt.OptimizerParams(iters, j_opt.SRParams(JCG(20, 1e-10),
                                                    diag_shift=1e-2),
                              lr=0.05),
        occupancy=occ, bc=JPBC)
    ref = j_vmc.vmc_optimize(jnp.asarray(tps), j_spin.heisenberg(), jparams,
                             seed)

    key, k_init, _ = jax.random.split(seed, 3)
    cfg0 = np.array(init_configs_occupancy(k_init, NC, LY, LX, dict(occ)))
    uni = []
    for _ in range(n_warm):
        key, k_s = jax.random.split(key)
        uni.append(jax_pbc_uniforms(jax.random.split(k_s, NC), LY, LX))
    uni += collect_uniforms(key, n_samples * iters)
    it = iter(uni)
    tparams = VMCParams(
        CHI, TruncParams(CHI, 1, 0.0),
        MCParams(num_samples=n_samples, num_warmup_sweeps=n_warm, nchains=NC,
                 trial_sweep=trial),
        t_opt.OptimizerParams(iters, t_opt.SRParams(CGParams(20, 1e-10),
                                                    diag_shift=1e-2),
                              lr=0.05),
        occupancy=occ, bc=PBC)
    out = vmc_optimize(torch.as_tensor(tps), spin.heisenberg(), tparams,
                       configs=torch.as_tensor(cfg0),
                       sweep_uniforms=lambda: next(it))
    assert next(it, None) is None
    assert np.array_equal(out.final_configs.numpy(),
                          np.asarray(ref.final_configs))
    for e, w in zip(out.energies, ref.energies):
        assert abs(e - w) < 1e-10 * abs(w)
    assert rel(out.state, ref.state) < 1e-8
    for rec, jrec in zip(out.records, ref.records):
        assert rec.sr_iters == jrec.sr_iters
        assert abs(rec.accept_rate - jrec.accept_rate) < 1e-12


def test_vmc_optimize_pbc_matches_reference():
    _vmc_case(trial=True)


def test_vmc_optimize_pbc_full_recompute_matches_reference():
    _vmc_case(trial=False)


def _measure_case(trial):
    """measure() on the torus with the frozen trial sweep (trial) or the
    full recompute: the registry keeps the observables without
    environments; every statistic, the acceptance and log|psi| of every
    sample."""
    tps, cfg = inputs(9)
    key = jax.random.PRNGKey(10)
    n_warm, n_samples = 1, 3
    ref = j_measure.measure(
        jnp.asarray(tps), j_spin.heisenberg(),
        j_measure.MeasurementParams(num_samples=n_samples,
                                    num_warmup_sweeps=n_warm, nchains=NC,
                                    host_sweep=True if trial else None),
        CHI, JTrunc(CHI, 1, 0.0), JRule("exchange"), jnp.asarray(cfg), key,
        bc=JPBC)
    key, ks = jax.random.split(key)
    uni = collect_uniforms(ks, n_warm) + collect_uniforms(key, n_samples)
    it = iter(uni)
    out = measure.measure(
        torch.as_tensor(tps), spin.heisenberg(),
        measure.MeasurementParams(num_samples=n_samples,
                                  num_warmup_sweeps=n_warm, nchains=NC,
                                  trial_sweep=trial),
        CHI, TruncParams(CHI, 1, 0.0), UpdateRule("exchange"),
        torch.as_tensor(cfg), sweep_uniforms=lambda: next(it), bc=PBC)
    assert next(it, None) is None
    assert set(out.stats) == set(ref.stats) == {"energy", "sz", "szsz"}
    for k, (m, e) in out.stats.items():
        jm, je = ref.stats[k]
        assert np.abs(m - np.asarray(jm)).max() \
            <= 1e-10 * max(1.0, np.abs(np.asarray(jm)).max()), k
        assert np.abs(e - np.asarray(je)).max() \
            <= 1e-10 * max(1.0, np.abs(np.asarray(je)).max()), k
    assert out.accept_rate == pytest.approx(ref.accept_rate, abs=1e-12)
    assert rel(out.psi_samples, ref.psi_samples) < 1e-10


def test_measure_pbc_matches_reference():
    _measure_case(trial=True)


def test_measure_pbc_full_recompute_matches_reference():
    _measure_case(trial=False)
