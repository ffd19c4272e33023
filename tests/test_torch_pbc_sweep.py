"""Parity of the port's torus sweeps (peps_tpu_torch.montecarlo.sweep_pbc)
with the JAX package's, in float64, and the frozen trial sweep's
stationarity.

The port's sweeps are driven by the uniforms the reference draws, rebuilt
by replaying its key splits: per chain key, one ``split`` per bond
decision in the sweep's bond order, then ``uniform`` of the split-off key
(the exchange test and the Suwa-Todo pick take the same uniform).
Configurations and per-chain accept and trial counts must then be equal;
the returned caches' log|psi| within 1e-9 of the reference's. The torus
sampler's amplitude helpers (engine.amplitudes and the state
normalization) are held to the reference's open-boundary reading of a
torus state within 1e-10.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo import engine as j_engine
from peps_tpu.montecarlo import sweep_pbc as js
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo import engine
from peps_tpu_torch.montecarlo import sweep_pbc as ts
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from peps_tpu_torch.tps import exact_contract_pbc


@functools.cache
def _uniforms_fn(n_bonds):
    def one(key):
        def body(k, _):
            k, k_pick = jax.random.split(k)
            return k, jax.random.uniform(k_pick, (), jnp.float64)
        return jax.lax.scan(body, key, None, length=n_bonds)[1]
    return jax.jit(jax.vmap(one))


def jax_pbc_uniforms(chain_keys, ly, lx):
    """[nc, 2 Ly Lx]: the uniforms the reference's torus sweeps draw from
    each chain key (sweep_pbc.py:68,76 and :357,367), in bond order."""
    return torch.tensor(np.array(_uniforms_fn(2 * ly * lx)(chain_keys)))


def sz0_mask(d=2):
    """The (current pair -> new pair) table that keeps the pair's sum."""
    m = np.zeros((d * d, d * d), np.int32)
    for c1, c2, n1, n2 in itertools.product(range(d), repeat=4):
        m[c1 * d + c2, n1 * d + n2] = int(c1 + c2 == n1 + n2)
    return tuple(map(tuple, m.tolist()))


RULES = {"exchange": None, "suwa_todo": sz0_mask()}


def sweep_inputs(n=4, D=2, nc=3, seed=1):
    rng = np.random.default_rng(seed)
    tps = rng.normal(size=(n, n, 2, D, D, D, D)) * 0.5
    cfg = np.stack([rng.permutation([0, 1] * (n * n // 2)).reshape(n, n)
                    for _ in range(nc)])
    keys = jax.random.split(jax.random.PRNGKey(seed), nc)
    return tps, cfg, keys, jax_pbc_uniforms(keys, n, n)


@pytest.mark.parametrize("mode,chi", [("exchange", 16), ("exchange", 4),
                                      ("suwa_todo", 4)])
def test_mc_sweep_pbc_matches_reference(mode, chi):
    """The full-recompute sweep (exchange; Suwa-Todo with a conservation
    mask) at a non-truncating and a truncating chi."""
    tps, cfg, keys, u = sweep_inputs()
    rule = (mode, RULES[mode])
    want, _, st = jax.vmap(js.mc_sweep_pbc,
                           in_axes=(None, 0, 0, None, None, None))(
        jnp.asarray(tps), jnp.asarray(cfg), keys, chi, JTrunc(chi, 1, 0.0),
        JRule(*rule))
    got, gst = ts.mc_sweep_pbc(torch.as_tensor(tps), torch.as_tensor(cfg),
                               chi, TruncParams(chi, 1, 0.0),
                               UpdateRule(*rule), u)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gst.accepted.numpy(), np.asarray(st.accepted))
    assert np.array_equal(gst.trials.numpy(), np.asarray(st.trials))
    assert int(gst.accepted.sum()) > 0
    assert np.array_equal(got.sum((1, 2)).numpy(), cfg.sum((1, 2)))


@pytest.mark.parametrize("mode,exact,chi", [
    (m, e, c) for m in RULES for e in (False, True) for c in (16, 4)])
def test_mc_sweep_pbc_trial_matches_reference(mode, exact, chi):
    """The trial/commit sweep, both rules, frozen and exact, at chi 16
    (does not truncate a 4x4 D=2 torus) and 4: configurations and counts
    equal, the committed caches' log|psi| within 1e-9."""
    tps, cfg, keys, u = sweep_inputs(seed=2)
    rule = (mode, RULES[mode])
    want, _, acc, tri, caches = js.mc_sweep_pbc_trial(
        jnp.asarray(tps), jnp.asarray(cfg), keys, chi, JTrunc(chi, 1, 0.0),
        JRule(*rule), exact=exact, return_caches=True)
    got, st, cache = ts.mc_sweep_pbc_trial(
        torch.as_tensor(tps), torch.as_tensor(cfg), chi,
        TruncParams(chi, 1, 0.0), UpdateRule(*rule), u, exact=exact,
        return_caches=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(st.accepted.numpy(), np.asarray(acc))
    assert np.array_equal(st.trials.numpy(), np.asarray(tri))
    assert np.abs(cache.log_abs.numpy() - np.asarray(caches.log_abs)).max() \
        < 1e-9


def test_trial_sweep_equals_full_sweep_without_truncation():
    """At a chi that does not truncate, the frozen trial sweep and the full
    recompute follow the same trajectories from the same uniforms; a
    second trial sweep from the first's returned caches equals one that
    rebuilds them."""
    tps, cfg, _, _ = sweep_inputs(seed=3)
    gen = torch.Generator().manual_seed(3)
    u = [ts.draw_uniforms_pbc(gen, 3, 4, 4, torch.float64, "cpu")
         for _ in range(2)]
    t, trunc, rule = torch.as_tensor(tps), TruncParams(16, 1, 0.0), \
        UpdateRule()
    full, fst = ts.mc_sweep_pbc(t, torch.as_tensor(cfg), 16, trunc, rule,
                                u[0])
    trial, tst, caches = ts.mc_sweep_pbc_trial(
        t, torch.as_tensor(cfg), 16, trunc, rule, u[0], return_caches=True)
    assert torch.equal(full, trial)
    assert torch.equal(fst.accepted, tst.accepted)
    again, _ = ts.mc_sweep_pbc_trial(t, trial, 16, trunc, rule, u[1],
                                     caches=caches)
    fresh, _ = ts.mc_sweep_pbc_trial(t, trial, 16, trunc, rule, u[1])
    assert torch.equal(again, fresh)
    with pytest.raises(ValueError, match="uniforms"):
        ts.mc_sweep_pbc(t, torch.as_tensor(cfg), 16, trunc, rule, u[0][:, 1:])


def test_frozen_trial_sweep_stationary():
    """One frozen trial sweep of 2048 chains drawn from the exact |psi|^2
    of a 2x4 torus (D=2, chi=16, which does not truncate) over its 70
    Sz = 0 configurations leaves that distribution in place: the
    chi-square statistic of the histogram after the sweep (bins of
    expected count below 5 merged) stays below 69 + 6 sqrt(2 * 69) ~ 139,
    and the sweep moves most chains."""
    ly, lx, nc = 2, 4, 2048
    rng = np.random.default_rng(70)
    tps = rng.normal(size=(ly, lx, 2, 2, 2, 2, 2)) * 0.5
    configs = np.array([c for c in itertools.product((0, 1), repeat=8)
                        if sum(c) == 4]).reshape(-1, ly, lx)
    psi = np.array([exact_contract_pbc(tps[np.arange(ly)[:, None],
                                           np.arange(lx)[None, :], c])
                    for c in configs])
    p = psi ** 2 / np.sum(psi ** 2)
    start = configs[rng.choice(len(configs), size=nc, p=p)]
    gen = torch.Generator().manual_seed(71)
    u = ts.draw_uniforms_pbc(gen, nc, ly, lx, torch.float64, "cpu")
    out, st = ts.mc_sweep_pbc_trial(torch.as_tensor(tps),
                                    torch.as_tensor(start), 16,
                                    TruncParams(16, 1, 0.0), UpdateRule(), u)
    moved = (out.numpy() != start).any((1, 2)).mean()
    assert moved > 0.5
    index = {tuple(c.reshape(-1)): i for i, c in enumerate(configs)}
    counts = np.bincount([index[tuple(c.reshape(-1))] for c in out.numpy()],
                         minlength=len(configs))
    expect = p * nc
    small = expect < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expect[~small], expect[small].sum())
    chi2 = float(np.sum((obs - exp) ** 2 / exp))
    assert chi2 < 69 + 6 * np.sqrt(2 * 69), chi2


@pytest.mark.parametrize("scheme", ["svd", "sketch"])
def test_torus_state_amplitudes_follow_reference(scheme, monkeypatch):
    """The amplitude that the sampler's validity rescue and state
    normalization read is the reference's on a torus state: its
    open-boundary reading, boundary legs of dimension D included (a fault
    of the reference kept for its trajectories), within 1e-10."""
    from peps_tpu_torch.contraction import bmps as tb
    from tests.test_torch_bmps import jax_sketch_blocks
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    rng = np.random.default_rng(9)
    tps = rng.normal(size=(4, 4, 2, 3, 3, 3, 3)) * 0.5
    neel = np.indices((4, 4)).sum(0) % 2
    cfg = np.stack([neel, 1 - neel, np.roll(neel, 1, 0)])
    trunc, jtrunc = TruncParams(8, 1, 0.0, scheme=scheme), \
        JTrunc(8, 1, 0.0, scheme=scheme)
    t, c = torch.as_tensor(tps), torch.as_tensor(cfg)
    mant, logw = engine.amplitudes(t, c, 8, trunc)
    jm, jl = j_engine.amplitudes(jnp.asarray(tps), jnp.asarray(cfg), 8,
                                 jtrunc)
    got = torch.log(mant.abs()) + logw
    want = np.log(np.abs(np.asarray(jm))) + np.asarray(jl)
    assert np.abs(got.numpy() - want).max() < 1e-10
    assert np.array_equal(np.sign(mant.numpy()), np.sign(np.asarray(jm)))
    norm = engine.normalize_state_order1(t, c, 8, trunc)
    jnorm = j_engine.normalize_state_order1(jnp.asarray(tps),
                                            jnp.asarray(cfg), 8, jtrunc)
    assert np.abs(norm.numpy() - np.asarray(jnorm)).max() \
        < 1e-10 * np.abs(np.asarray(jnorm)).max()
