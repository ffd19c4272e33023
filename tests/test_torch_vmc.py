"""One iteration of the whole slice (vmc_optimize) against the JAX
package, in float64, for SR, SGD, MinSR, Adam and SR with the step
selector: same initial configurations, the reference's replayed sweep
uniforms (and, for the step selector's energy-only probes, its replayed
probe uniforms), the reference's sketch blocks. Energy, gradient-derived
update and the final configurations must agree.

Tolerance: energies 1e-10 relative; the updated TPS 1e-8 relative, because
the CG solve of (S + shift) x = g amplifies the 1e-14 differences of its
inputs by up to the condition number of S + shift (shift 1e-2 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import vmc_optimize as j_vmc
from peps_tpu.algorithm.mc_evaluator import MCParams as JMC
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo.engine import init_configs_occupancy
from peps_tpu.optimizer import optimizer as j_opt
from peps_tpu.optimizer.cg import CGParams as JCG
from peps_tpu_torch.algorithm.mc_evaluator import MCParams
from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.optimizer.cg import CGParams
from peps_tpu_torch.optimizer import optimizer as t_opt
from peps_tpu_torch.optimizer.optimizer import OptimizerParams
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_sweep import jax_sweep_uniforms, random_tps


def jax_vmc_uniforms(key, nc, ly, lx, n_warm, n_sweeps, probes=0,
                     probe_sweeps=0):
    """Every sweep's uniforms in the order the reference's vmc_optimize
    draws them: warm-up sweeps from split(split(key)[1], nc), then the
    evaluator's sweeps from split(key, nc + 1)[1:]. With probes, also the
    uniforms of that many energy-only probes after the evaluator's sweeps:
    probe n starts from fold_in(sampler key, n) and splits it like the
    evaluator. Returns (sweep iterator, probe iterator)."""
    key, _, _ = jax.random.split(key, 3)
    out = []
    for _ in range(n_warm):
        key, k_s = jax.random.split(key)
        out.append(jax_sweep_uniforms(jax.random.split(k_s, nc), ly, lx))
    for _ in range(n_sweeps):
        keys = jax.random.split(key, nc + 1)
        key = keys[0]
        out.append(jax_sweep_uniforms(keys[1:], ly, lx))
    probe = []
    for n in range(1, probes + 1):
        k = jax.random.fold_in(key, n)
        for _ in range(probe_sweeps):
            keys = jax.random.split(k, nc + 1)
            k = keys[0]
            probe.append(jax_sweep_uniforms(keys[1:], ly, lx))
    return iter(out), iter(probe)


ALGOS = {
    "sr": (lambda m, cg: m.SRParams(cg(20, 1e-10), diag_shift=1e-2), {}),
    "sgd": (lambda m, cg: m.SGDParams(), {}),
    "minsr": (lambda m, cg: m.MinSRParams(pseudo_inverse_cutoff=1e-8), {}),
    "adam": (lambda m, cg: m.AdamParams(), {}),
    "sr_step_selector": (
        lambda m, cg: m.SRParams(cg(20, 1e-10), diag_shift=1e-2),
        {"step_selector": "default"}),
}


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_vmc_optimize_one_iteration_matches_reference(algo, monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    ly, lx, D, chi, nc = 2, 3, 2, 4, 4
    n_samples, n_warm = 2, 1
    rng = np.random.default_rng(31)
    tps = random_tps(rng, ly, lx, 2, D)
    occ = ((0, 3), (1, 3))
    seed = jax.random.PRNGKey(4)

    make, extra = ALGOS[algo]
    j_kw, t_kw = {}, {}
    if extra.get("step_selector"):
        j_kw["step_selector"] = j_opt.StepSelectorParams()
        t_kw["step_selector"] = t_opt.StepSelectorParams()
    n_probes = len(j_opt.StepSelectorParams().candidates) if j_kw else 0
    j_params = j_vmc.VMCParams(
        chi, JTrunc(chi, 1, 1e-12, scheme="sketch"),
        JMC(num_samples=n_samples, num_warmup_sweeps=n_warm, nchains=nc),
        j_opt.OptimizerParams(1, make(j_opt, JCG), lr=0.05, **j_kw),
        occupancy=occ)
    ref = j_vmc.vmc_optimize(jnp.asarray(tps), j_spin.heisenberg(), j_params,
                             seed)

    _, k_init, _ = jax.random.split(seed, 3)
    cfg0 = np.array(init_configs_occupancy(k_init, nc, ly, lx, dict(occ)))
    uniforms, probes = jax_vmc_uniforms(seed, nc, ly, lx, n_warm, n_samples,
                                        n_probes, n_samples)
    t_params = VMCParams(
        chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
        MCParams(num_samples=n_samples, num_warmup_sweeps=n_warm, nchains=nc),
        OptimizerParams(1, make(t_opt, CGParams), lr=0.05, **t_kw),
        occupancy=occ)
    out = vmc_optimize(torch.as_tensor(tps), spin.heisenberg(), t_params,
                       configs=torch.as_tensor(cfg0),
                       sweep_uniforms=lambda: next(uniforms),
                       probe_uniforms=lambda: next(probes))

    assert abs(out.energies[0] - ref.energies[0]) < 1e-10 * abs(ref.energies[0])
    assert np.array_equal(out.final_configs.numpy(),
                          np.asarray(ref.final_configs))
    assert rel(out.state, ref.state) < 1e-8
    rec, jrec = out.records[0], ref.records[0]
    assert abs(rec.grad_norm - jrec.grad_norm) < 1e-8 * jrec.grad_norm
    assert rec.sr_iters == jrec.sr_iters
    assert abs(rec.accept_rate - jrec.accept_rate) < 1e-6
    assert rec.lr == pytest.approx(jrec.lr, rel=1e-12)
    assert next(probes, None) is None     # every probe uniform was used


def test_optimizer_rejects_unknown_algorithm():
    """An object that is none of the six algorithms raises ValueError at
    dispatch, as in the reference."""
    state = torch.zeros(3, dtype=torch.float64)

    def evaluate(s, step):
        return t_opt.Evaluation(torch.zeros((), dtype=torch.float64),
                                torch.ones(3, dtype=torch.float64))

    for algo in (j_opt.AdamParams(), "adam", None):
        with pytest.raises(ValueError, match="unknown algorithm"):
            t_opt.iterative_optimize(state, evaluate,
                                     OptimizerParams(1, algo))


def test_cg_matches_reference_and_stops_on_device():
    from peps_tpu.optimizer.cg import cg_solve as j_cg
    from peps_tpu_torch.optimizer.cg import cg_solve
    rng = np.random.default_rng(0)
    a = rng.standard_normal((12, 30))
    b = rng.standard_normal(30)

    def jmv(v):
        return a.T @ (a @ v) + 0.1 * v

    ta = torch.as_tensor(a)
    ref = j_cg(lambda v: jnp.asarray(a).T @ (jnp.asarray(a) @ v) + 0.1 * v,
               jnp.asarray(b), None, JCG(50, 1e-9))
    out = cg_solve(lambda v: ta.T @ (ta @ v) + 0.1 * v, torch.as_tensor(b),
                   None, CGParams(50, 1e-9))
    assert int(out.iterations) == int(ref.iterations)
    assert rel(out.x, ref.x) < 1e-10
    assert np.linalg.norm(jmv(out.x.numpy()) - b) < 1e-8 * np.linalg.norm(b)
