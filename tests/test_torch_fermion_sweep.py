"""The graded samplers (peps_tpu_torch.fermion.sweep, .vmc) against the
JAX package on replayed keys, float64, sketch with the reference's blocks:
the env-shared sweep with and without a Jastrow dress, its full-recompute
oracle, and the full-recompute mc_sweep_fermion give the reference's
configurations and accept counts chain by chain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.fermion import sweep as j_sweep
from peps_tpu.fermion import vmc as j_vmc
from peps_tpu.fermion.peps import FermionSpace as JSpace
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo.jastrow import JastrowDress as JDress
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.fermion import sweep, vmc
from peps_tpu_torch.fermion.peps import FermionSpace
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.jastrow import JastrowDress
from test_torch_bmps import jax_sketch_blocks, t
from torch_fermion_util import (full_sweep_uniforms, graded_sweep_uniforms,
                                hole_configs, random_graded_tps)

SPACE, JSPACE = FermionSpace((0, 1, 1), 2, 2), JSpace((0, 1, 1), 2, 2)
COUNTS = {0: 3, 1: 3, 2: 3}


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


@pytest.mark.parametrize("dressed", [False, True])
def test_shared_sweep_matches_reference(dressed, jax_blocks):
    ly, lx, chi, nc = 3, 3, 4, 4
    rng = np.random.default_rng(2 + dressed)
    tps = random_graded_tps(rng, ly, lx, SPACE)
    cfgs = hole_configs(rng, nc, ly, lx, COUNTS)
    v = rng.standard_normal((9, 9)) * 0.3
    v = v + v.T
    np.fill_diagonal(v, 0.0)
    nv = np.array([1.0, 0.0, 0.0])
    jd = JDress(jnp.asarray(v), jnp.asarray(nv)) if dressed else None
    td = JastrowDress(t(v), t(nv)) if dressed else None
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    keys = jax.random.split(jax.random.PRNGKey(5), nc)
    cj, _, stj = jax.jit(jax.vmap(lambda c, k: j_sweep.mc_sweep_fermion_shared(
        jnp.asarray(tps), JSPACE, c, k, chi, jt, jd)))(jnp.asarray(cfgs), keys)
    u = graded_sweep_uniforms(keys, ly, lx)
    ct, st = sweep.mc_sweep_fermion_shared(t(tps), SPACE, t(cfgs), chi, trunc,
                                           uniforms=u, dress=td)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.array_equal(st.accepted.numpy(), np.asarray(stj.accepted))
    assert np.array_equal(st.trials.numpy(), np.asarray(stj.trials))
    assert int(st.accepted.sum()) > 0
    co, so = sweep.mc_sweep_fermion_oracle(t(tps), SPACE, t(cfgs), chi,
                                           trunc, u, dress=td)
    assert np.array_equal(co.numpy(), ct.numpy())
    assert np.array_equal(so.accepted.numpy(), st.accepted.numpy())
    # exchanges keep every occupation number
    for s in range(3):
        assert np.array_equal((ct.numpy() == s).sum((1, 2)),
                              (cfgs == s).sum((1, 2)))


def test_full_recompute_sweep_matches_reference(jax_blocks):
    ly, lx, chi, nc = 2, 3, 4, 3
    rng = np.random.default_rng(8)
    tps = random_graded_tps(rng, ly, lx, SPACE)
    cfgs = hole_configs(rng, nc, ly, lx, {0: 2, 1: 2, 2: 2})
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    keys = jax.random.split(jax.random.PRNGKey(9), nc)
    cj, lj, stj = jax.jit(jax.vmap(lambda c, k: j_vmc.mc_sweep_fermion(
        jnp.asarray(tps), JSPACE, c, k, chi, jt)))(jnp.asarray(cfgs), keys)
    n_bonds = len(vmc.mc_bonds(ly, lx))
    ct, lt, st = vmc.mc_sweep_fermion(
        t(tps), SPACE, t(cfgs), chi, TruncParams(chi, 1, 1e-12,
                                                 scheme="sketch"),
        uniforms=full_sweep_uniforms(keys, n_bonds))
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert np.array_equal(st.accepted.numpy(), np.asarray(stj.accepted))
    assert np.array_equal(st.trials.numpy(), np.asarray(stj.trials))
    assert np.allclose(lt.numpy(), np.asarray(lj), rtol=1e-10, atol=0)


def test_graded_mc_energy_grad_matches_reference(jax_blocks):
    """The evaluator's graded branch: the env-shared sweep between samples
    (the reference's per-chain keys replayed), the graded local energy and
    holes, the holes through K2's plain version with psi_loc = 1: the same
    energy, gradient, SR buffers and configurations."""
    from peps_tpu.algorithm import mc_evaluator as j_eval
    from peps_tpu.models import fermion as j_fermion
    from peps_tpu.montecarlo.sweep import UpdateRule as JRule
    from peps_tpu_torch.algorithm import mc_evaluator
    from peps_tpu_torch.models import fermion

    ly, lx, chi, nc = 2, 3, 4, 3
    rng = np.random.default_rng(12)
    tps = random_graded_tps(rng, ly, lx, SPACE)
    cfgs = hole_configs(rng, nc, ly, lx, {0: 2, 1: 2, 2: 2})
    jgm = j_vmc.GradedFermionModel.from_model(j_fermion.tj_model(), JSPACE,
                                              jnp.float64)
    key = jax.random.PRNGKey(3)
    ev_j, cfg_j, _, _ = j_eval.mc_energy_grad(
        jnp.asarray(tps), jnp.asarray(cfgs), key, jgm, chi,
        JTrunc(chi, 1, 1e-12, scheme="sketch"), JRule(),
        j_eval.MCParams(num_samples=2, nchains=nc), with_sr_buffers=True)
    uniforms, k = [], key
    for _ in range(2):
        keys = jax.random.split(k, nc + 1)
        k = keys[0]
        uniforms.append(graded_sweep_uniforms(keys[1:], ly, lx))
    it = iter(uniforms)
    gm = vmc.GradedFermionModel.from_model(fermion.tj_model(), SPACE,
                                           torch.float64, "cpu")
    ev, cfg, _ = mc_evaluator.mc_energy_grad(
        t(tps), t(cfgs), gm, chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
        mc_evaluator.MCParams(num_samples=2, nchains=nc), lambda: next(it),
        with_sr_buffers=True)
    assert np.array_equal(cfg.numpy(), np.asarray(cfg_j))
    assert abs(float(ev.energy) - float(ev_j.energy)) \
        < 1e-10 * abs(float(ev_j.energy))
    for f in ("gradient", "o_samples", "e_samples"):
        a, b = getattr(ev, f).numpy(), np.asarray(getattr(ev_j, f))
        assert np.linalg.norm(a - b) < 1e-10 * np.linalg.norm(b), f
