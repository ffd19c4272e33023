"""Parity of the port's trial/commit cache of the torus contractor
(peps_tpu_torch.contraction.pbc_trial) with the JAX package's, and with
the full recompute, in float64.

Inputs come from numpy with a seed; the port batches two chains, the
reference takes one configuration a call. The fast scheme gets the
reference's test matrices. Tolerances: the cache (stages, projectors,
log-norms, mantissa, log weight) within 1e-10 absolute of the reference's
(the two run the same operations; they differ by round-off); trial
amplitudes (mantissa and dln) within 1e-9 of the reference's, and exact
or non-truncating trials within 1e-9 in log|psi| of the full recompute
(tests/test_pbc_trial.py's limit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.contraction import pbc_trial as jt
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.tps import project as j_project
from peps_tpu_torch.contraction import pbc_trial as tt
from peps_tpu_torch.contraction.pbc import contract_pbc
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project
from tests.test_torch_pbc import jax_test_matrix

NC = 2


def setup(n, D, chi, scheme="svd", seed=0):
    rng = np.random.default_rng(seed + 100 * n + D)
    tps = rng.normal(size=(n, n, 2, D, D, D, D)) * 0.5
    cfg = rng.integers(0, 2, size=(NC, n, n))
    kw = {"scheme": scheme, "rsvd_power": 1}
    return tps, cfg, TruncParams(chi, 1, 0.0, **kw), JTrunc(chi, 1, 0.0,
                                                            **kw)


def full_log_abs(tps, cfg, chi, trunc):
    mant, logw = contract_pbc(project(torch.as_tensor(tps),
                                      torch.as_tensor(cfg)), chi, trunc,
                              test_matrix=jax_test_matrix)
    return torch.log(mant.abs()) + logw


def port_cache(tps, cfg, chi, trunc):
    return tt.build_cache(project(torch.as_tensor(tps), torch.as_tensor(cfg)),
                          chi, trunc, test_matrix=jax_test_matrix)


def ref_cache(tps, cfg, chi, jtrunc):
    return jt.build_cache(j_project(jnp.asarray(tps), jnp.asarray(cfg)), chi,
                          jtrunc)


def test_plans_match_reference():
    for ly, lx in ((4, 4), (6, 6), (2, 4), (8, 8), (12, 12)):
        plan = tt.stage_plan(ly, lx)
        assert plan == jt.stage_plan(ly, lx)
        for w in ((1, 2), (2, 1), (1, 1)):
            for exact in (True, False):
                assert tt.window_plan(plan, *w, exact) \
                    == jt.window_plan(plan, *w, exact)


@pytest.mark.parametrize("n,D,chi,scheme", [
    (4, 2, 16, "svd"), (4, 3, 6, "svd"), (6, 2, 8, "svd"), (4, 3, 6, "fast")])
def test_build_cache_matches_reference(n, D, chi, scheme):
    """Every stage grid, projector grid and log-norm grid, the mantissa and
    the log weight of each chain against the reference's cache of that
    chain; log|psi| against contract_pbc."""
    tps, cfg, trunc, jtrunc = setup(n, D, chi, scheme)
    cache = port_cache(tps, cfg, chi, trunc)
    assert (cache.log_abs - full_log_abs(tps, cfg, chi, trunc)).abs().max() \
        < 1e-10
    for i in range(NC):
        ref = ref_cache(tps, cfg[i], chi, jtrunc)
        for got, want, shape in zip(cache.stages, ref.stages, ref.shapes):
            assert np.abs(got[i].numpy()
                          - np.asarray(want).reshape(shape)).max() < 1e-10
        for got, want, shapes in zip(cache.projs, ref.projs, ref.pshapes):
            assert (got is None) == (want is None)
            for g, w, sh in zip(got or (), want or (), shapes or ()):
                assert np.abs(g[i].numpy()
                              - np.asarray(w).reshape(sh)).max() < 1e-10
        for got, want in zip(cache.lnorms, ref.lnorms):
            assert np.abs(got[i].numpy() - np.asarray(want)).max() < 1e-10
        assert abs(float(cache.mant[i]) - float(ref.mant)) < 1e-10
        assert abs(float(cache.logw[i]) - float(ref.logw)) < 1e-10


def anchors(n):
    """Corners and wrap-around rows and columns (the reference test's)."""
    return [(0, 0), (1, n - 1), (n - 1, n // 2), (n - 1, n - 1)]


def flip_block(tps, cfg, y, x, horizontal):
    n = cfg.shape[-1]
    (wr, wc), (dy, dx) = ((1, 2), (0, 1)) if horizontal else ((2, 1), (1, 0))
    y2, x2 = (y + dy) % n, (x + dx) % n
    c = torch.as_tensor(cfg)
    blk = tt.replace_sites(torch.as_tensor(tps), c, [(0, 0), (dy, dx)],
                           [1 - c[:, y, x], 1 - c[:, y2, x2]], y, x, wr, wc)
    cfg2 = cfg.copy()
    cfg2[:, y, x] = 1 - cfg[:, y, x]
    cfg2[:, y2, x2] = 1 - cfg[:, y2, x2]
    jblk = jt.replace_sites(jnp.asarray(tps), jnp.asarray(cfg[0]),
                            [(0, 0), (dy, dx)],
                            [1 - int(cfg[0, y, x]), 1 - int(cfg[0, y2, x2])],
                            y, x, wr, wc)
    return blk, jblk, cfg2


@pytest.mark.parametrize("n,D,chi,scheme,exact,full", [
    (4, 2, 16, "svd", True, True),      # non-truncating, fresh projectors
    (4, 2, 16, "svd", False, True),     # non-truncating: frozen map exact
    (4, 3, 6, "svd", True, True),       # truncating chi, fresh projectors
    (4, 3, 6, "svd", False, False),     # truncating chi, frozen map
    (4, 3, 6, "fast", True, True),      # the fast scheme's test matrix
    (6, 2, 8, "svd", True, True),       # 3 * 2 sides: the triple stage
])
def test_trial_matches_reference_and_full_recompute(n, D, chi, scheme,
                                                    exact, full):
    """Two-site flips on horizontal and vertical windows at wrap-around
    anchors: (mant, dln) of chain 0 against the reference's trial; where
    the trial is exact (fresh projectors, or a frozen map that does not
    truncate) log|psi| of both chains against the full recompute."""
    tps, cfg, trunc, jtrunc = setup(n, D, chi, scheme)
    cache = port_cache(tps, cfg, chi, trunc)
    ref = ref_cache(tps, cfg[0], chi, jtrunc)
    for horizontal in (True, False):
        for y, x in anchors(n):
            blk, jblk, cfg2 = flip_block(tps, cfg, y, x, horizontal)
            trial = tt.begin_trial(cache, blk, y, x, chi=chi, trunc=trunc,
                                   exact=exact, test_matrix=jax_test_matrix)
            jtrial = jt.begin_trial(ref, jblk, y, x, chi=chi, trunc=jtrunc,
                                    exact=exact)
            assert abs(float(trial.mant[0]) - float(jtrial.mant)) < 1e-9
            assert abs(float(trial.dln[0]) - float(jtrial.dln)) < 1e-9
            if full:
                la = tt.trial_log_abs(cache, trial)
                assert (la - full_log_abs(tps, cfg2, chi, trunc)).abs() \
                    .max() < 1e-9, (horizontal, y, x)


def clone_cache(c):
    return tt.PBCCache([s.clone() for s in c.stages],
                       [None if p is None else tuple(q.clone() for q in p)
                        for p in c.projs],
                       [l.clone() for l in c.lnorms], c.mant.clone(),
                       c.logw.clone())


def caches_equal(a, b, chain):
    pairs = list(zip(a.stages, b.stages)) + list(zip(a.lnorms, b.lnorms))
    pairs += [(p, q) for pa, pb in zip(a.projs, b.projs) if pa is not None
              for p, q in zip(pa, pb)]
    pairs += [(a.mant, b.mant), (a.logw, b.logw)]
    return all(torch.equal(p[chain], q[chain]) for p, q in pairs)


@pytest.mark.parametrize("exact", [False, True])
def test_commit_and_reject_semantics(exact):
    """A per-chain commit: the accepting chain's cache then evaluates the
    trial state, the rejecting chain's is bit-identical to before; a chain
    of commits tracks the full recompute (non-truncating chi)."""
    n, chi = 4, 16
    tps, cfg, trunc, _ = setup(n, 2, chi, seed=3)
    cache = port_cache(tps, cfg, chi, trunc)
    before = clone_cache(cache)
    blk, _, cfg2 = flip_block(tps, cfg, 0, 0, True)
    trial = tt.begin_trial(cache, blk, 0, 0, chi=chi, trunc=trunc,
                           exact=exact)
    la_trial = tt.trial_log_abs(cache, trial)
    tt.commit_trial(cache, trial, accept=torch.tensor([True, False]))
    assert caches_equal(cache, before, 1)
    assert not caches_equal(cache, before, 0)
    assert abs(float(cache.log_abs[0] - la_trial[0])) < 1e-12
    tt.commit_trial(cache, trial, accept=torch.tensor([False, False]))
    assert abs(float(cache.log_abs[0] - la_trial[0])) < 1e-12

    cur = cfg2.copy()
    cur[1] = cfg[1]
    for y, x, horizontal in ((3, 3, False), (2, 1, True), (0, 3, True)):
        blk, _, nxt = flip_block(tps, cur, y, x, horizontal)
        trial = tt.begin_trial(cache, blk, y, x, chi=chi, trunc=trunc,
                               exact=exact)
        tt.commit_trial(cache, trial)
        cur = nxt
        assert (cache.log_abs - full_log_abs(tps, cur, chi, trunc)).abs() \
            .max() < 1e-9


def test_evaluate_replacement_read_only():
    """The trial amplitude of a one-site replacement, with the cache left
    as it was."""
    tps, cfg, trunc, _ = setup(4, 2, 16, seed=5)
    cache = port_cache(tps, cfg, 16, trunc)
    before = clone_cache(cache)
    c = torch.as_tensor(cfg)
    blk = tt.replace_sites(torch.as_tensor(tps), c, [(0, 0)],
                           [1 - c[:, 2, 2]], 2, 2, 1, 1)
    mant, logw = tt.evaluate_replacement(cache, blk, 2, 2, chi=16,
                                         trunc=trunc)
    cfg2 = cfg.copy()
    cfg2[:, 2, 2] = 1 - cfg[:, 2, 2]
    got = torch.log(mant.abs()) + logw
    assert (got - full_log_abs(tps, cfg2, 16, trunc)).abs().max() < 1e-9
    assert all(caches_equal(cache, before, i) for i in range(NC))


def test_replace_sites_candidates_and_select():
    """A block with a candidate axis (the Suwa-Todo rule's d^2 pairs):
    each candidate's trial equals the single trial of that pair, and
    select_trial picks per chain."""
    tps, cfg, trunc, _ = setup(4, 2, 16, seed=7)
    cache = port_cache(tps, cfg, 16, trunc)
    t, c = torch.as_tensor(tps), torch.as_tensor(cfg)
    p = torch.tensor([0, 0, 1, 1]).expand(NC, -1)
    q = torch.tensor([0, 1, 0, 1]).expand(NC, -1)
    blk = tt.replace_sites(t, c, [(0, 0), (1, 0)], [p, q], 3, 1, 2, 1)
    assert blk.shape[:4] == (NC, 4, 2, 1)
    trials = tt.begin_trial(cache, blk, 3, 1, chi=16, trunc=trunc)
    for k in range(4):
        one = tt.replace_sites(t, c, [(0, 0), (1, 0)], [p[:, k], q[:, k]], 3,
                               1, 2, 1)
        single = tt.begin_trial(cache, one, 3, 1, chi=16, trunc=trunc)
        assert torch.allclose(trials.mant[:, k], single.mant, rtol=0,
                              atol=1e-12)
    pick = tt.select_trial(trials, torch.tensor([2, 1]))
    assert torch.equal(pick.mant, trials.mant[[0, 1], [2, 1]])
    assert torch.equal(pick.blocks[1][0], trials.blocks[1][0][[0, 1], [2, 1]])
