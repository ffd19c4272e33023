"""Parity of the port's 3-site permutation sweep and Jastrow-dressed sweep
(peps_tpu_torch.montecarlo.sweep) with the JAX package, in float64.

Both sweeps are driven by the uniforms the reference draws, rebuilt by
replaying its key splits (``jax_3site_uniforms`` here, the bond sweep's in
``test_torch_sweep.jax_sweep_uniforms``). Configurations and acceptance
counts must then agree exactly. The sketch compression uses the
reference's Gaussian blocks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.lattice import transpose_tps as j_transpose
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo import jastrow as j_jastrow
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.montecarlo.sweep import mc_sweep as j_mc_sweep
from peps_tpu.montecarlo.sweep import mc_sweep_3site as j_mc_sweep_3site
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo import jastrow
from peps_tpu_torch.montecarlo.sweep import (UpdateRule, draw_uniforms,
                                             mc_sweep, mc_sweep_3site)
from test_torch_bmps import jax_sketch_blocks
from test_torch_sweep import jax_sweep_uniforms, random_tps


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


@functools.cache
def _uniforms3_fn(ly, lx):
    def one(key):
        frames = []
        for rows, cols in ((ly, lx), (lx, ly)):
            us = []
            for _ in range(rows if cols >= 3 else 0):
                key, k_row = jax.random.split(key)
                row = []
                for _ in range(cols - 2):
                    k_row, k_pick = jax.random.split(k_row)
                    row.append(jax.random.uniform(k_pick, (), jnp.float64))
                us.append(jnp.stack(row))
            frames.append(jnp.stack(us) if us
                          else jnp.zeros((rows, max(cols - 2, 0))))
        return tuple(frames)
    return jax.jit(jax.vmap(one))


def jax_3site_uniforms(chain_keys, ly, lx):
    """(u_h [nc, Ly, Lx-2], u_v [nc, Lx, Ly-2]) that the reference's
    mc_sweep_3site draws from each chain key (montecarlo/sweep.py:288,
    :258 and suwa_todo_pick): per row one split, per window one split
    whose key draws the pick's uniform; a frame narrower than 3 draws
    nothing."""
    u_h, u_v = _uniforms3_fn(ly, lx)(chain_keys)
    return torch.as_tensor(np.array(u_h)), torch.as_tensor(np.array(u_v))


def mixed_configs(rng, nc, ly, lx, d=3):
    """Configurations over d local states with mixed counts, so the
    windows hold triples with and without repeats."""
    return rng.integers(0, d, (nc, ly, lx)).astype(np.int32)


@pytest.mark.parametrize("ly,lx", [(3, 3), (2, 4)])
def test_mc_sweep_3site_replayed_uniforms(ly, lx, jax_blocks):
    rng = np.random.default_rng(ly * 10 + lx)
    D, chi, nc, d = 2, 4, 6, 3
    tps = random_tps(rng, ly, lx, d, D)
    cfgs = mixed_configs(rng, nc, ly, lx, d)
    sweep = jax.jit(jax.vmap(j_mc_sweep_3site,
                             in_axes=(None, None, 0, 0, None, None)),
                    static_argnums=(4, 5))
    jtps = jnp.asarray(tps)
    tt = torch.as_tensor(tps)
    cfg_j, cfg_t = jnp.asarray(cfgs), torch.as_tensor(cfgs)
    key = jax.random.PRNGKey(5)
    accepted = 0
    for _ in range(2):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, nc)
        cfg_j, _, st_j = sweep(jtps, j_transpose(jtps), cfg_j, keys, chi,
                               JTrunc(chi, 1, 1e-12, scheme="sketch"))
        cfg_t, st_t = mc_sweep_3site(
            tt, transpose_tps(tt), cfg_t, chi,
            TruncParams(chi, 1, 1e-12, scheme="sketch"),
            uniforms=jax_3site_uniforms(keys, ly, lx))
        assert np.array_equal(cfg_t.numpy(), np.asarray(cfg_j))
        assert int(st_t.accepted) == int(np.sum(st_j.accepted))
        assert int(st_t.trials) == int(np.sum(st_j.trials))
        accepted += int(st_t.accepted)
    assert accepted > 0
    for v in range(d):      # a permutation keeps every chain's counts
        assert np.array_equal((cfg_t.numpy() == v).sum((1, 2)),
                              (cfgs == v).sum((1, 2)))


def test_mc_sweep_3site_draws_its_uniforms():
    """Without uniforms the sweep draws one per window from the generator
    (draw_uniforms with window 3) and gives the same configurations."""
    rng = np.random.default_rng(1)
    ly, lx, nc = 3, 4, 3
    tt = torch.as_tensor(random_tps(rng, ly, lx, 2, 2))
    cfgs = torch.as_tensor(mixed_configs(rng, nc, ly, lx, 2))
    trunc = TruncParams(4, 1, 1e-12)
    u = draw_uniforms(torch.Generator().manual_seed(3), nc, ly, lx,
                      torch.float64, "cpu", window=3)
    assert u[0].shape == (nc, ly, lx - 2) and u[1].shape == (nc, lx, ly - 2)
    a, _ = mc_sweep_3site(tt, transpose_tps(tt), cfgs, 4, trunc, uniforms=u)
    b, _ = mc_sweep_3site(tt, transpose_tps(tt), cfgs, 4, trunc,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["exchange", "suwa_todo"])
def test_dressed_mc_sweep_replayed_uniforms(mode, jax_blocks):
    rng = np.random.default_rng(7)
    ly, lx, D, chi, nc = 3, 3, 2, 4, 6
    tps = random_tps(rng, ly, lx, 2, D)
    cfgs = rng.integers(0, 2, (nc, ly, lx)).astype(np.int32)
    v = rng.standard_normal((ly * lx, ly * lx)) * 0.5
    v = v + v.T
    np.fill_diagonal(v, 0.0)
    nvals = np.array([0.0, 1.0])
    jd = j_jastrow.JastrowDress(jnp.asarray(v), jnp.asarray(nvals))
    dress = jastrow.JastrowDress(torch.as_tensor(v), torch.as_tensor(nvals))
    sweep = jax.jit(jax.vmap(
        lambda c, k: j_mc_sweep(jnp.asarray(tps), j_transpose(jnp.asarray(tps)),
                                c, k, chi, JTrunc(chi, 1, 1e-12,
                                                  scheme="sketch"),
                                JRule(mode), dress=jd)))
    tt = torch.as_tensor(tps)
    cfg_j, cfg_t = jnp.asarray(cfgs), torch.as_tensor(cfgs)
    key = jax.random.PRNGKey(9)
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    undressed = []
    for _ in range(2):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, nc)
        uni = jax_sweep_uniforms(keys, ly, lx)
        undressed.append(mc_sweep(tt, transpose_tps(tt), cfg_t, chi, trunc,
                                  uniforms=uni, rule=UpdateRule(mode))[0])
        cfg_j, _, st_j = sweep(cfg_j, keys)
        cfg_t, st_t = mc_sweep(tt, transpose_tps(tt), cfg_t, chi, trunc,
                               uniforms=uni, rule=UpdateRule(mode),
                               dress=dress)
        assert np.array_equal(cfg_t.numpy(), np.asarray(cfg_j))
        assert int(st_t.accepted) == int(np.sum(st_j.accepted))
        undressed[-1] = not torch.equal(undressed[-1], cfg_t)
    assert int(np.sum(st_j.accepted)) > 0
    assert any(undressed)       # the dress moved some chain
