"""Fermionic models in the Jordan-Wigner representation
(peps_tpu_torch.algorithm.energy_fermion) against the JAX package: the
string signs, E_loc and the O tensor of spinless fermions, t-J (both with
t2 on the diagonals) and Hubbard (a site term) on 3x3 states, float64 and
complex128 within 1e-10 relative, sketch with the reference's blocks at a
truncating chi; and one mc_energy_grad of Hubbard with the Suwa-Todo rule
and the conservation mask on the reference's replayed sweep uniforms:
the same energy, gradient, SR buffers and configurations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy_fermion as j_ef
from peps_tpu.algorithm import mc_evaluator as j_eval
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import fermion as j_fermion
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu_torch.algorithm import energy_fermion as ef
from peps_tpu_torch.algorithm import mc_evaluator
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import fermion
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from test_torch_bmps import jax_sketch_blocks, rel, t
from test_torch_sweep import jax_sweep_uniforms, random_tps

RTOL = 1e-10
MODELS = {"spinless_t2": lambda m: m.spinless_fermion(1.0, 0.5, 0.2, t2=0.6),
          "tj_t2": lambda m: m.tj_model(3.0, 1.0, t2=0.7, mu=0.1),
          "hubbard": lambda m: m.hubbard(1.0, 4.0, mu=0.5)}


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("cplx", [False, True])
def test_jw_energy_holes_and_signs_match_reference(name, cplx, jax_blocks):
    jm, m = MODELS[name](j_fermion), MODELS[name](fermion)
    d, ly, lx, chi = m.phys_dim, 3, 3, 3
    rng = np.random.default_rng(len(name) + cplx)
    tps = random_tps(rng, ly, lx, d, 2)
    if cplx:
        tps = tps + 1j * random_tps(rng, ly, lx, d, 2)
    cfgs = rng.integers(0, d, size=(3, ly, lx)).astype(np.int32)
    jdt = jnp.complex128 if cplx else jnp.float64
    jft = j_ef.FermionTensors.from_model(jm, jdt)
    ft = ef.FermionTensors.from_model(m, t(tps).dtype, "cpu")
    signs = ef._string_signs(t(cfgs).long(), ft)
    for b in range(3):
        jsigns = j_ef._string_signs(jnp.asarray(cfgs[b]), jft, jnp.float64)
        for key, val in jsigns.items():
            assert np.array_equal(signs[key][b].numpy(), np.asarray(val)), key
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    ref = jax.jit(jax.vmap(lambda c: j_ef.local_energy_and_holes_fermion(
        jnp.asarray(tps), c, jft, chi, jt)))(jnp.asarray(cfgs))
    out = ef.local_energy_and_holes_fermion(
        t(tps), t(cfgs), ft, chi, TruncParams(chi, 1, 1e-12, scheme="sketch"))
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < RTOL, f


def test_jw_mc_energy_grad_matches_reference(jax_blocks):
    ly, lx, D, chi, nc = 2, 3, 2, 4, 4
    jm, m = j_fermion.hubbard(1.0, 4.0), fermion.hubbard(1.0, 4.0)
    rng = np.random.default_rng(17)
    tps = random_tps(rng, ly, lx, 4, D)
    base = np.array([0, 1, 2, 3, 1, 2])
    cfgs = np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(nc)]).astype(np.int32)
    mask = j_fermion.hubbard_conserve_mask()
    key = jax.random.PRNGKey(6)
    params = j_eval.MCParams(num_samples=2, nchains=nc)
    jft = j_ef.FermionTensors.from_model(jm, jnp.float64)
    ev_j, cfg_j, _, _ = j_eval.mc_energy_grad(
        jnp.asarray(tps), jnp.asarray(cfgs), key, jft, chi,
        JTrunc(chi, 1, 1e-12, scheme="sketch"), JRule("suwa_todo", mask),
        params, with_sr_buffers=True)
    uniforms = []
    k = key
    for _ in range(2):
        keys = jax.random.split(k, nc + 1)
        k = keys[0]
        uniforms.append(jax_sweep_uniforms(keys[1:], ly, lx))
    it = iter(uniforms)
    ft = ef.FermionTensors.from_model(m, torch.float64, "cpu")
    ev, cfg, _ = mc_evaluator.mc_energy_grad(
        t(tps), t(cfgs), ft, chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
        mc_evaluator.MCParams(num_samples=2, nchains=nc), lambda: next(it),
        with_sr_buffers=True, rule=UpdateRule("suwa_todo", mask))
    assert np.array_equal(cfg.numpy(), np.asarray(cfg_j))
    assert abs(float(ev.energy) - float(ev_j.energy)) \
        < RTOL * abs(float(ev_j.energy))
    assert rel(ev.gradient, ev_j.gradient) < RTOL
    assert rel(ev.o_samples, ev_j.o_samples) < RTOL
    # Suwa-Todo with the mask keeps every chain's N_up and N_dn
    n_up, n_dn = np.asarray(m.n_up), np.asarray(m.n_dn)
    assert np.array_equal(n_up[cfg.numpy()].sum((1, 2)),
                          n_up[cfgs].sum((1, 2)))
    assert np.array_equal(n_dn[cfg.numpy()].sum((1, 2)),
                          n_dn[cfgs].sum((1, 2)))
