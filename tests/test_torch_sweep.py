"""Parity of the port's MC sweep (peps_tpu_torch.montecarlo) with the JAX
package, in float64.

The port's sweep is driven by the uniforms the reference draws, rebuilt by
replaying its key splits: per chain key, per row ``split``, per bond
``split`` then ``uniform``, the vertical frame continuing from the
horizontal frame's key. Configurations must then agree exactly, and so
must the acceptance counts. The sketch compression uses the reference's
Gaussian blocks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo import engine as j_engine
from peps_tpu.montecarlo import statistics as j_stats
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.montecarlo.sweep import mc_sweep as j_mc_sweep
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.lattice import boundary_mask, transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo import engine, statistics
from peps_tpu_torch.montecarlo.sweep import UpdateRule, mc_sweep
from test_torch_bmps import jax_sketch_blocks


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


@functools.cache
def _uniforms_fn(ly, lx):
    def one(key):
        frames = []
        for rows, bonds in ((ly, lx - 1), (lx, ly - 1)):
            us = []
            for _ in range(rows):
                key, k_row = jax.random.split(key)
                row = []
                for _ in range(bonds):
                    k_row, k_pick = jax.random.split(k_row)
                    row.append(jax.random.uniform(k_pick, (), jnp.float64))
                us.append(jnp.stack(row))
            frames.append(jnp.stack(us))
        return tuple(frames)
    return jax.jit(jax.vmap(one))


def jax_sweep_uniforms(chain_keys, ly, lx):
    """(u_h [nc, Ly, Lx-1], u_v [nc, Lx, Ly-1]) that the reference's
    mc_sweep draws from each chain key (montecarlo/sweep.py:119,142,173);
    the same uniform drives the exchange and the Suwa-Todo rule."""
    u_h, u_v = _uniforms_fn(ly, lx)(chain_keys)
    return torch.as_tensor(np.array(u_h)), torch.as_tensor(np.array(u_v))


def random_tps(rng, ly, lx, d, D):
    return rng.standard_normal((ly, lx, d) + (D,) * 4) \
        * boundary_mask(ly, lx, d, D)


def neel_like_configs(rng, nc, ly, lx):
    base = np.array([0, 1] * (ly * lx // 2) + [0] * (ly * lx % 2))
    return np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(nc)]).astype(np.int32)


@pytest.mark.parametrize("ly,lx", [(2, 3), (3, 3)])
def test_mc_sweep_replayed_uniforms(ly, lx, jax_blocks):
    rng = np.random.default_rng(ly * 10 + lx)
    D, chi, nc = 2, 4, 6
    tps = random_tps(rng, ly, lx, 2, D)
    cfgs = neel_like_configs(rng, nc, ly, lx)
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    sweep = jax.jit(jax.vmap(j_mc_sweep, in_axes=(None, None, 0, 0, None,
                                                  None, None)),
                    static_argnums=(4, 5, 6))
    from peps_tpu.lattice import transpose_tps as j_transpose
    jtps = jnp.asarray(tps)
    tt = torch.as_tensor(tps)
    cfg_j, cfg_t = jnp.asarray(cfgs), torch.as_tensor(cfgs)
    key = jax.random.PRNGKey(3)
    for _ in range(2):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, nc)
        cfg_j, _, st_j = sweep(jtps, j_transpose(jtps), cfg_j, keys, chi, jt,
                               JRule("exchange"))
        cfg_t, st_t = mc_sweep(tt, transpose_tps(tt), cfg_t, chi,
                               TruncParams(chi, 1, 1e-12, scheme="sketch"),
                               uniforms=jax_sweep_uniforms(keys, ly, lx))
        assert np.array_equal(cfg_t.numpy(), np.asarray(cfg_j))
        assert int(st_t.accepted) == int(np.sum(st_j.accepted))
        assert int(st_t.trials) == int(np.sum(st_j.trials))
    assert int(np.sum(st_j.accepted)) > 0


def test_mc_sweep_with_bottom_stack_equals_fresh(jax_blocks):
    """Passing the evaluator's bottom stack gives the same sweep."""
    rng = np.random.default_rng(8)
    ly, lx, D, chi, nc = 3, 3, 2, 4, 4
    tt = torch.as_tensor(random_tps(rng, ly, lx, 2, D))
    cfgs = torch.as_tensor(neel_like_configs(rng, nc, ly, lx))
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    from peps_tpu_torch.tps import project
    bots = tb.all_env_stacks(project(tt, cfgs), chi, trunc).bots
    uni = (torch.rand(nc, ly, lx - 1, dtype=torch.float64),
           torch.rand(nc, lx, ly - 1, dtype=torch.float64))
    a, _ = mc_sweep(tt, transpose_tps(tt), cfgs, chi, trunc, uniforms=uni)
    b, _ = mc_sweep(tt, transpose_tps(tt), cfgs, chi, trunc, uniforms=uni,
                    bots=bots)
    assert torch.equal(a, b)


def test_suwa_todo_rule_raises():
    """Suwa-Todo is ported (its parity tests are in test_torch_suwa_todo);
    a rule the reference does not have still raises."""
    assert UpdateRule("suwa_todo").mode == "suwa_todo"
    with pytest.raises(ValueError, match="suwa_todo"):
        UpdateRule("heat_bath")


def test_engine_amplitudes_validity_and_normalization(jax_blocks):
    rng = np.random.default_rng(9)
    ly, lx, D, chi, nc = 2, 3, 2, 4, 5
    tps = random_tps(rng, ly, lx, 2, D)
    cfgs = neel_like_configs(rng, nc, ly, lx)
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    pt = TruncParams(chi, 1, 1e-12, scheme="sketch")
    tt, ct = torch.as_tensor(tps), torch.as_tensor(cfgs)
    jm, jl = jax.jit(j_engine.amplitudes, static_argnums=(2, 3))(
        jnp.asarray(tps), jnp.asarray(cfgs), chi, jt)
    m, lw = engine.amplitudes(tt, ct, chi, pt)
    np.testing.assert_allclose(m.numpy() * np.exp(lw.numpy()),
                               np.asarray(jm) * np.exp(np.asarray(jl)),
                               rtol=1e-10)
    ref = jax.jit(j_engine.normalize_state_order1, static_argnums=(2, 3))(
        jnp.asarray(tps), jnp.asarray(cfgs), chi, jt)
    out = engine.normalize_state_order1(tt, ct, chi, pt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-14)
    # a zero-amplitude chain (all spins up kills every site with a zero
    # up-slice) is replaced by a healthy one
    tz = tt.clone()
    tz[0, 0, 0] = 0.0
    bad = ct.clone()
    bad[0, 0, 0] = 0
    fixed, n_bad = engine.ensure_validity(tz, bad, torch.Generator(), chi, pt)
    mf, _ = engine.amplitudes(tz, fixed, chi, pt)
    assert int(n_bad) == int((bad[:, 0, 0] == 0).sum())
    assert bool((mf != 0).all())


def test_init_configs_occupancy_counts():
    g = torch.Generator().manual_seed(1)
    cfg = engine.init_configs_occupancy(g, 7, 3, 4, {0: 5, 1: 7}, "cpu")
    assert cfg.shape == (7, 3, 4)
    assert ((cfg == 1).sum(dim=(1, 2)) == 7).all()
    with pytest.raises(ValueError):
        engine.init_configs_occupancy(g, 2, 3, 4, {0: 5}, "cpu")


@pytest.mark.parametrize("shape", [(16,), (9, 4), (10, 3)])
def test_mean_and_binned_error(shape):
    x = np.random.default_rng(2).standard_normal(shape)
    m, e = statistics.mean_and_binned_error(torch.as_tensor(x))
    jm, je = j_stats.mean_and_binned_error(jnp.asarray(x))
    assert abs(float(m) - float(jm)) < 1e-12
    assert abs(float(e) - float(je)) < 1e-12
