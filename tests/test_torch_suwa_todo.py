"""The Suwa-Todo rule of the port's sweep (peps_tpu_torch.montecarlo.
suwa_todo and the suwa_todo branch of sweep._sweep_rows) against the JAX
package, and the stationarity of both update rules against exact |psi|^2.

Parity: the pick is driven by the uniform that the reference draws from the
same key, so states must agree exactly; the sweep by the reference's
replayed per-bond uniforms, so configurations and counts must agree
exactly. Stationarity (the reference's tests/test_mc_sweep.py, which its
suite marks slow): many chains and few sweeps from a fixed seed, so it runs
in seconds; the empirical histogram must match exact |psi|^2 within 0.02,
the reference's bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.lattice import transpose_tps as j_transpose
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo.suwa_todo import suwa_todo_pick as j_pick
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.montecarlo.sweep import mc_sweep as j_mc_sweep
from peps_tpu_torch.algorithm.exact_sum import all_configs, sector_configs
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo import engine
from peps_tpu_torch.montecarlo.suwa_todo import suwa_todo_pick
from peps_tpu_torch.montecarlo.sweep import UpdateRule, mc_sweep
from peps_tpu_torch.tps import exact_amplitude
from test_torch_bmps import jax_sketch_blocks
from test_torch_sweep import jax_sweep_uniforms, random_tps

# total-Sz conservation on a spin-1/2 bond: pair index c1 * 2 + c2
SZ_MASK = tuple(tuple(int((a // 2 + a % 2) == (b // 2 + b % 2))
                      for b in range(4)) for a in range(4))


@pytest.mark.parametrize("masked", [False, True])
def test_suwa_todo_pick_matches_reference(masked):
    rng = np.random.default_rng(4 + masked)
    n, k = 400, 4
    w = rng.random((n, k)) ** 3
    w[::7, 2] = 0.0                       # zero weights
    w[::11] = w[::11, :1]                 # ties: argmax takes the first
    cur = rng.integers(0, k, n)
    if masked:
        w = w * np.array(SZ_MASK)[cur]
    w[np.arange(n), cur] = np.maximum(w[np.arange(n), cur], 0.05)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    ref = jax.jit(jax.vmap(j_pick))(jnp.asarray(w), jnp.asarray(cur), keys)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float64))(keys)
    out = suwa_todo_pick(torch.as_tensor(w), torch.as_tensor(cur),
                         torch.as_tensor(np.asarray(u)))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert (out != torch.as_tensor(cur)).any()
    if masked:                            # the mask is respected
        assert np.all(np.array(SZ_MASK)[cur, out.numpy()] == 1)


def test_suwa_todo_sweep_replayed_uniforms(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    rng = np.random.default_rng(17)
    ly, lx, D, chi, nc = 2, 3, 2, 4, 5
    tps = random_tps(rng, ly, lx, 2, D)
    cfgs = rng.integers(0, 2, (nc, ly, lx)).astype(np.int32)
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    pt = TruncParams(chi, 1, 1e-12, scheme="sketch")
    sweep = jax.jit(jax.vmap(j_mc_sweep, in_axes=(None, None, 0, 0, None,
                                                  None, None)),
                    static_argnums=(4, 5, 6))
    jtps, tt = jnp.asarray(tps), torch.as_tensor(tps)
    cfg_j, cfg_t = jnp.asarray(cfgs), torch.as_tensor(cfgs)
    key = jax.random.PRNGKey(8)
    for _ in range(2):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, nc)
        cfg_j, _, st_j = sweep(jtps, j_transpose(jtps), cfg_j, keys, chi, jt,
                               JRule("suwa_todo"))
        cfg_t, st_t = mc_sweep(tt, transpose_tps(tt), cfg_t, chi, pt,
                               uniforms=jax_sweep_uniforms(keys, ly, lx),
                               rule=UpdateRule("suwa_todo"))
        assert np.array_equal(cfg_t.numpy(), np.asarray(cfg_j))
        assert int(st_t.accepted) == int(np.sum(st_j.accepted))
        assert int(st_t.trials) == int(np.sum(st_j.trials))
    assert int(np.sum(st_j.accepted)) > 0
    # with the Sz mask the same sweep moves spins but keeps each chain's Sz
    cfg_m, st_m = mc_sweep(tt, transpose_tps(tt), torch.as_tensor(cfgs), chi,
                           pt, generator=torch.Generator().manual_seed(0),
                           rule=UpdateRule("suwa_todo", SZ_MASK))
    assert int(st_m.accepted) > 0
    assert np.array_equal(cfg_m.sum((1, 2)).numpy(), cfgs.sum((1, 2)))


def _histogram(tps, rule, cfg0, seed, n_warm, n_sweeps, all_cfg):
    """Visits of each configuration over n_sweeps sweeps of every chain,
    after n_warm, as a probability vector."""
    tt = torch.as_tensor(tps)
    tp = TruncParams(4, 1, 0.0)       # exact: one row of D = 2 needs chi 2
    gen = torch.Generator().manual_seed(seed)
    lookup = {tuple(c.ravel()): i for i, c in enumerate(all_cfg)}
    counts = np.zeros(len(all_cfg))
    cfg = cfg0
    for i in range(n_warm + n_sweeps):
        cfg, _ = mc_sweep(tt, transpose_tps(tt), cfg, 4, tp, generator=gen,
                          rule=rule)
        if i >= n_warm:
            for c in cfg.numpy():
                counts[lookup[tuple(c.ravel())]] += 1
    return counts / counts.sum()


@pytest.mark.parametrize("mode", ["exchange", "suwa_todo"])
def test_stationary_distribution(mode):
    """2x2, D=2: exchange in the two-up sector, Suwa-Todo over all 16
    configurations; 512 chains x 24 sweeps after 8 warm-up sweeps."""
    rng = np.random.default_rng(1 if mode == "exchange" else 5)
    tps = random_tps(rng, 2, 2, 2, 2)
    gen = torch.Generator().manual_seed(1)
    if mode == "exchange":
        cfgs = sector_configs(2, 2, {0: 2, 1: 2})
        cfg0 = engine.init_configs_occupancy(gen, 512, 2, 2, {0: 2, 1: 2},
                                             "cpu")
    else:
        cfgs = all_configs(2, 2, 2)
        cfg0 = engine.init_configs_uniform(gen, 512, 2, 2, 2, "cpu")
    probs = np.array([abs(exact_amplitude(tps, c)) ** 2 for c in cfgs])
    probs /= probs.sum()
    emp = _histogram(tps, UpdateRule(mode), cfg0, 2, 8, 24, cfgs)
    assert np.max(np.abs(emp - probs)) < 0.02, (emp, probs)
