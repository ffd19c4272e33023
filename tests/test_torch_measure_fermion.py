"""Parity of the port's fermion measurement (peps_tpu_torch.algorithm.
measure_fermion, the fermion registry, the fermionic branches of measure(),
exact_sum_pair_corr_graded, the weighted statistics) with the JAX package,
in float64 and complex128 on the CPU.

Tolerances: the operator signs exactly; 1e-10 relative for the walker
tables, the shared resources, the exact sums and the replayed measure()
statistics (the sketch runs on the reference's blocks, the sweeps on the
uniforms its key stream gives); 1e-12 for host statistics; the exact sum
against the second-quantized oracle within the reference test's 1e-7. The
Jordan-Wigner column walker is held at 4x3 (a line of three sites has no
bond pair at distance > 1, so every 3x3 table is zero by geometry), the
graded walkers at 2x4, 3x4 and 4x3.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import exact_measure as j_exm
from peps_tpu.algorithm import measure as j_measure
from peps_tpu.algorithm import measure_fermion as jmf
from peps_tpu.algorithm import registry as j_registry
from peps_tpu.algorithm.energy_fermion import FermionTensors as JFT
from peps_tpu.fermion import vmc as j_vmc
from peps_tpu.fermion.peps import FermionSpace as JSpace
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import fermion as j_fermion
from peps_tpu.montecarlo import statistics as j_stats
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu_torch.algorithm import measure, measure_fermion as mf
from peps_tpu_torch.algorithm import registry
from peps_tpu_torch.algorithm.energy_fermion import FermionTensors
from peps_tpu_torch.algorithm.exact_measure import (
    _pair_corr_support, exact_sum_pair_corr_graded)
from peps_tpu_torch.algorithm.exact_sum import sector_configs
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.fermion.exact import exact_coefficients, snake_order
from peps_tpu_torch.fermion.peps import (FermionSpace, fermion_simple_update,
                                         product_fermion_peps,
                                         space_for_model, to_tps_fermion)
from peps_tpu_torch.fermion.vmc import GradedFermionModel, log_abs_psi_fermion
from peps_tpu_torch.kernels.bmps_overlap import bmps_overlap
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import fermion
from peps_tpu_torch.montecarlo import statistics
from peps_tpu_torch.montecarlo.jastrow import holes_adjacent
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from peps_tpu_torch.peps import SimpleUpdateParams
from fermion_ed_oracle import _apply_ops, _config_to_occ
from test_torch_bmps import jax_sketch_blocks, rel, t
from test_torch_sweep import jax_sweep_uniforms
from torch_fermion_util import (graded_sweep_uniforms, hole_configs,
                                random_graded_tps)

RTOL = 1e-10
SPACE, JSPACE = FermionSpace((0, 1, 1), 1, 1), JSpace((0, 1, 1), 1, 1)
N_UP, N_DN = np.array([0, 1, 0]), np.array([0, 0, 1])


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def sketch(chi):
    return (JTrunc(chi, 1, 1e-12, scheme="sketch"),
            TruncParams(chi, 1, 1e-12, scheme="sketch"))


def _counts(ly, lx, holes=4):
    n = ly * lx - holes
    return {0: holes, 1: n - n // 2, 2: n // 2}


def _graded_case(ly, lx, cplx, nc=4, seed=0):
    rng = np.random.default_rng(seed + 10 * ly + lx + 100 * cplx)
    return (random_graded_tps(rng, ly, lx, SPACE, cplx),
            hole_configs(rng, nc, ly, lx, _counts(ly, lx)))


# ------------------------------------------------------------------ signs

def test_pair_op_sign_matches_reference():
    """Every order of four distinct sites and every spin pair, on random
    occupations that make the operators apply about half of the time: the
    batched count equals the reference's sequential one exactly."""
    rng = np.random.default_rng(5)
    m = 12
    rows = []
    for perm in itertools.permutations(range(4)):
        for sa, sb in itertools.product((0, 1), repeat=2):
            for _ in range(3):
                sites = rng.choice(m // 2, 4, replace=False)[list(perm)]
                occ = rng.integers(0, 2, m)
                if rng.random() < 0.5:        # make every operator apply
                    i, j, k, l = sites
                    occ[[2 * l + 1 - sb, 2 * k + sb]] = 1
                    occ[[2 * i + sa, 2 * j + 1 - sa]] = 0
                rows.append((occ, *sites, sa, sb))
    occ = np.stack([r[0] for r in rows])
    cols = [np.array([r[q] for r in rows]) for q in range(1, 7)]
    ref = np.asarray(jax.jit(jax.vmap(jmf._pair_op_sign))(
        jnp.asarray(occ), *map(jnp.asarray, cols)))
    out = mf._pair_op_sign(t(occ), *map(t, cols))
    assert np.array_equal(out.numpy(), ref.astype(np.int64))
    assert (ref == 1).sum() > 20 and (ref == -1).sum() > 20 \
        and (ref == 0).sum() > 20


# ------------------------------------------------------------- statistics

@pytest.mark.parametrize("shape", [(16, 3, 5), (9, 1, 4), (10, 4, 1)])
def test_weighted_statistics_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    lw = 0.7 * rng.standard_normal(shape[:2])
    m, e = statistics.weighted_mean_and_binned_error_batch(t(x), t(lw))
    jm, je = j_stats.weighted_mean_and_binned_error_batch(jnp.asarray(x),
                                                          jnp.asarray(lw))
    assert np.abs(m.numpy() - np.asarray(jm)).max() < 1e-12
    assert np.abs(e.numpy() - np.asarray(je)).max() < 1e-12


# ------------------------------------------------------- Jordan-Wigner

@pytest.mark.parametrize("ly,lx", [(2, 4), (4, 3)])
def test_jw_walkers_match_reference(ly, lx, jax_blocks):
    rng = np.random.default_rng(ly + 7 * lx)
    chi = 6
    tps = rng.standard_normal((ly, lx, 3, 2, 2, 2, 2))
    cfgs = hole_configs(rng, 6, ly, lx, _counts(ly, lx))
    jt, pt = sketch(chi)
    for name in ("row", "col"):
        jf = getattr(jmf, f"tj_singlet_pair_corr_{name}")
        ref = jax.jit(jax.vmap(lambda c: jf(jnp.asarray(tps), c, chi, jt)))(
            jnp.asarray(cfgs))
        out = getattr(mf, f"tj_singlet_pair_corr_{name}")(t(tps), t(cfgs),
                                                           chi, pt)
        assert out.shape == ref.shape
        assert rel(out, ref) < RTOL, name
        if (name == "row") == (lx > 3):
            assert np.abs(np.asarray(ref)).max() > 1e-3, name


# ------------------------------------------------------------- graded

def test_graded_env_shared_matches_reference(jax_blocks):
    tps, cfgs = _graded_case(3, 4, False)
    chi = 4
    jt, pt = sketch(chi)
    ref = jax.jit(jax.vmap(lambda c: jmf.graded_env_shared(
        jnp.asarray(tps), c, JSPACE, chi, jt)))(jnp.asarray(cfgs))
    out = mf.graded_env_shared(t(tps), t(cfgs), SPACE, chi, pt)
    assert rel(out.net, ref.net) < RTOL
    assert rel(out.net_flip, np.asarray(ref.net) * np.asarray(ref.flip)) \
        < RTOL
    assert rel(out.cands, ref.cands) < RTOL
    # the stacks by what they represent (a sketch core of a rank-deficient
    # bond agrees only to ~1e-5): psi from every cut, tops[y] closed
    # against bots[y] (K5's plain version against the reference's scan)
    st, jst = out.stacks, ref.stacks
    mant, logw = bmps_overlap(st.tops, st.bots)
    jm, jl = jax.vmap(jax.vmap(jmf._bmps_overlap))(jst.tops, jst.bots)
    psi = mant * torch.exp(logw + st.log_tops + st.log_bots)
    jpsi = np.asarray(jm) * np.exp(np.asarray(jl) + np.asarray(jst.log_tops)
                                   + np.asarray(jst.log_bots))
    assert rel(psi, jpsi) < RTOL
    assert rel(psi, psi[:, :1].expand_as(psi)) < 1e-8   # every cut: one psi


@pytest.mark.parametrize("ly,lx,cplx", [(2, 4, False), (3, 4, False),
                                        (3, 4, True), (4, 3, False),
                                        (4, 3, True)])
def test_graded_walkers_match_reference(ly, lx, cplx, jax_blocks):
    """rowshared, colshared and the full-recompute oracle in both frames,
    batched over configurations, against the reference's per-config
    functions."""
    tps, cfgs = _graded_case(ly, lx, cplx, nc=3)
    chi = 4
    jt, pt = sketch(chi)
    jtps = jnp.asarray(tps)
    for name in ("rowshared", "colshared"):
        jf = getattr(jmf, f"tj_singlet_pair_corr_graded_{name}")
        ref = jax.jit(jax.vmap(lambda c: jf(jtps, c, JSPACE, chi, jt)))(
            jnp.asarray(cfgs))
        out = getattr(mf, f"tj_singlet_pair_corr_graded_{name}")(
            t(tps), t(cfgs), SPACE, chi, pt)
        assert out.shape == ref.shape and out.dtype == t(ref).dtype
        assert rel(out, ref) < RTOL, name
        if (name == "rowshared") == (lx > 3):
            assert np.abs(np.asarray(ref)).max() > 1e-3, name
    frame = "row" if lx > 3 else "col"
    view = cfgs if frame == "row" else np.swapaxes(cfgs, 1, 2)
    c = cfgs[np.nonzero(_pair_corr_support(view))[0][:1]]
    ref = jmf.tj_singlet_pair_corr_graded(jtps, jnp.asarray(c[0]), JSPACE,
                                          chi, jt, frame)
    out = mf.tj_singlet_pair_corr_graded(t(tps), t(c), SPACE, chi, pt, frame)
    assert rel(out[0], ref) < RTOL
    assert np.abs(np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("ly,lx,cplx", [(3, 4, False), (4, 3, True)])
def test_shared_walkers_equal_full_recompute(ly, lx, cplx):
    """Inside the port: the env-shared walkers against the full-recompute
    oracle entry for entry under the svd scheme at a chi where nothing
    truncates (the reference's tests hold the two at 1e-8 and 1e-6), and a
    GradedEnvShared bundle handed in gives bit-identical tables
    to the walkers building their own (one bundle serves both frames)."""
    tps, _ = _graded_case(ly, lx, cplx, nc=1, seed=3)
    # the reference tests' configurations, each with a supported entry
    if ly == 3:
        occ0 = np.array([[1, 2, 0, 0], [2, 1, 1, 2], [0, 0, 2, 1]])
        cfgs = np.stack([occ0, occ0[::-1], np.roll(occ0, 1, axis=1)])
    else:
        cfgs = np.array([[[1, 2, 0], [2, 1, 0], [0, 1, 2], [0, 2, 1]],
                         [[1, 0, 2], [2, 0, 1], [0, 1, 2], [0, 2, 1]],
                         [[2, 1, 0], [1, 2, 0], [0, 1, 2], [0, 2, 1]]])
    chi = 16
    pt = TruncParams(chi, 1, 0.0)
    tt, tc = t(tps), t(cfgs)
    bundle = mf.graded_env_shared(tt, tc, SPACE, chi, pt)
    checked = 0
    for name, frame in (("rowshared", "row"), ("colshared", "col")):
        fn = getattr(mf, f"tj_singlet_pair_corr_graded_{name}")
        own = fn(tt, tc, SPACE, chi, pt)
        assert torch.equal(own, fn(tt, tc, SPACE, chi, pt, bundle))
        ref = mf.tj_singlet_pair_corr_graded(tt, tc, SPACE, chi, pt, frame)
        np.testing.assert_allclose(own.numpy(), ref.numpy(), rtol=1e-8,
                                   atol=1e-10)
        checked += int((ref.abs() > 1e-12).sum())
    assert checked > 0


# ----------------------------------------------------------- registry

def test_fermion_registry_values_match_reference():
    """Every observable of the t-J and Hubbard registries: keys, metas and
    the cheap observables' values per configuration."""
    rng = np.random.default_rng(8)
    ly, lx = 2, 3
    params = measure.MeasurementParams(measure_pair_corr=True)
    for jm, pm, d in ((j_fermion.tj_model(3.0, 1.0), fermion.tj_model(3.0,
                                                                     1.0), 3),
                      (j_fermion.hubbard(1.0, 4.0), fermion.hubbard(1.0,
                                                                    4.0), 4)):
        jreg = j_registry.fermion_registry(JFT.from_model(jm, jnp.float64),
                                           params)
        reg = registry.fermion_registry(
            FermionTensors.from_model(pm, torch.float64, "cpu"), params)
        assert [o.key for o in reg] == [o.key for o in jreg]
        cfgs = rng.integers(0, d, (5, ly, lx))
        ctx = registry.MeasureContext(None, None, t(cfgs),
                                      torch.zeros(5, dtype=torch.float64),
                                      4, None)
        for ob, job in zip(reg, jreg):
            assert (ob.description, ob.index_labels, ob.needs_envs) == \
                (job.description, job.index_labels, job.needs_envs)
            assert (ob.coords is None) == (job.coords is None)
            if ob.coords is not None:
                assert np.array_equal(ob.coords(ly, lx), job.coords(ly, lx))
            if ob.needs_envs:
                continue
            jctx = j_registry.MeasureContext(None, None, None,
                                             jnp.zeros(()), 4, None)
            ref = np.stack([np.asarray(job.compute(jctx._replace(
                config=jnp.asarray(c)))) for c in cfgs])
            assert np.array_equal(ob.compute(ctx).numpy(), ref), ob.key


# -------------------------------------------------------------- exact sum

def su_state(model, ly, lx, D, occ0, sched):
    """A graded simple-update state of the port (float64, CPU), scaled to
    unit largest entry, and its space."""
    space = space_for_model(model, D)
    peps = product_fermion_peps(ly, lx, space, occ0, device="cpu")
    for steps, tau in sched:
        peps = fermion_simple_update(
            peps, model, space,
            SimpleUpdateParams(steps, tau, TruncParams(D, 1, 1e-12))).peps
    tps = to_tps_fermion(peps)
    return tps / tps.abs().max(), space


def _ed_pair_table(tps, space, configs, ly, lx):
    """<Delta^dag_a Delta_b> of every row-bond pair at distance 2 from the
    exact snake-order coefficients and explicit mode algebra (the
    reference test's oracle, test_pair_corr.py:325)."""
    c = exact_coefficients(tps, space.phys_parity, space.bond_parity)
    seq = snake_order(ly, lx)
    snake_pos = np.zeros((ly, lx), int)
    for p, (y, x) in enumerate(seq):
        snake_pos[y, x] = p
    digits = [tuple(int(cfg[y, x]) for (y, x) in seq) for cfg in configs]
    v = np.array([c[dgt] for dgt in digits])
    index_of = {dgt: n for n, dgt in enumerate(digits)}
    norm = float(v @ v)

    def mode(y, x, sp):
        return 2 * snake_pos[y, x] + sp

    out = {}
    for y in range(ly):
        for i, k in ((0, 2), (2, 0)):
            (y1, x1), (y2, x2), (y3, x3), (y4, x4) = \
                (y, i), (y, i + 1), (y, k), (y, k + 1)
            acc = 0.0
            for n, cfg in enumerate(configs):
                occ = _config_to_occ(np.asarray(cfg), N_UP, N_DN, False,
                                     order="snake")
                for sa, ca in ((0, 1.0), (1, -1.0)):
                    for sb, cb in ((0, 1.0), (1, -1.0)):
                        r = _apply_ops(occ, [("cdag", mode(y2, x2, 1 - sa)),
                                             ("cdag", mode(y1, x1, sa)),
                                             ("c", mode(y3, x3, sb)),
                                             ("c", mode(y4, x4, 1 - sb))])
                        if r is None:
                            continue
                        sgn, occ_p = r
                        states = [{(0, 0): 0, (1, 0): 1, (0, 1): 2}.get(
                            (int(occ_p[2 * q]), int(occ_p[2 * q + 1])))
                            for q in range(ly * lx)]
                        row = index_of.get(tuple(states))
                        if None in states or row is None:
                            continue
                        acc += 0.5 * ca * cb * sgn * v[row] * v[n]
            out[(y, i, k)] = acc / norm
    return out


@pytest.fixture(scope="module")
def ladder():
    """The reference test's 2x4 ladder (3 up, 3 down, 2 holes), D = 4, 40
    simple-update steps at tau 0.15, and its sector."""
    model = fermion.tj_model(3.0, 1.0)
    occ0 = np.array([[1, 2, 1, 0], [2, 1, 2, 0]])
    tps, space = su_state(model, 2, 4, 4, occ0, ((40, 0.15),))
    return tps, space, sector_configs(2, 4, {0: 2, 1: 3, 2: 3})


def test_exact_sum_pair_corr_graded_matches_reference_and_ed(ladder,
                                                             jax_blocks):
    tps, space, configs = ladder
    chi = 16
    jt, pt = sketch(chi)
    jspace = JSpace(space.phys_parity, space.d_even, space.d_odd)
    got, z = exact_sum_pair_corr_graded(tps, configs, space, chi, pt)
    ref, jz = j_exm.exact_sum_pair_corr_graded(
        jnp.asarray(tps.numpy()), jnp.asarray(configs), jspace, chi, jt)
    assert abs(z / float(jz) - 1) < RTOL
    for frame in ("row", "col"):
        assert got[frame].shape == ref[frame].shape
        assert rel(got[frame], ref[frame]) < RTOL, frame
    for view in (configs, np.swapaxes(configs, 1, 2)):
        assert np.array_equal(_pair_corr_support(view),
                              j_exm._pair_corr_support(view))
    ed = _ed_pair_table(tps.numpy(), space, configs, 2, 4)
    checked = 0
    for (y, i, k), want in ed.items():
        assert abs(got["row"][y, i, k] - want) < 1e-7 * max(1.0, abs(want))
        checked += abs(want) > 1e-10
    assert checked >= 2


# --------------------------------------------------------- measure()

def measure_uniforms(key, nc, ly, lx, n_warm, n_sweeps, draw):
    """Each sweep's uniforms in the order the reference's measure() draws
    them: the warm-up from split(key)[1], re-split per sweep into nc + 1
    chain keys, then the samples from split(key)[0] the same way; draw
    turns the chain keys into the sweep's uniforms."""
    key, ks = jax.random.split(key)
    out = []
    for k, n in ((ks, n_warm), (key, n_sweeps)):
        for _ in range(n):
            kc = jax.random.split(k, nc + 1)
            k = kc[0]
            out.append(draw(kc[1:], ly, lx))
    return out


def _compare_results(out, ref, keys):
    assert set(out.stats) == set(ref.stats) == set(keys)
    for key, (m, e) in out.stats.items():
        jm, je = ref.stats[key]
        assert np.shape(m) == np.shape(jm), key
        for a, b in ((m, jm), (e, je)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert np.all(np.abs(a - b) <= np.maximum(RTOL * np.abs(b),
                                                      1e-12)), key
        meta, jmeta = out.metas[key], ref.metas[key]
        assert (meta.description, meta.shape, meta.index_labels) == \
            (jmeta.description, jmeta.shape, jmeta.index_labels), key
    assert out.accept_rate == ref.accept_rate
    assert rel(out.psi_samples, ref.psi_samples) < RTOL


FERMION_KEYS = {"energy", "n_up", "n_dn", "density", "nn", "sz", "szsz",
                "hole_density", "pair_corr_row", "pair_corr_col"}


def test_graded_measure_matches_reference(jax_blocks):
    """A whole graded t-J measure() with measure_pair_corr, replayed key by
    key against the reference's: every statistic (energies, densities,
    both env-shared pair walkers), acceptance and log|psi|, with energy
    and walker passes in chain batches (eval_chunk 3, env_chunk 2)."""
    ly, lx, chi, nc = 4, 3, 4, 4
    tps, cfgs = _graded_case(ly, lx, False, nc=nc, seed=9)
    key = jax.random.PRNGKey(3)
    jt, pt = sketch(chi)
    kw = dict(num_samples=4, num_warmup_sweeps=1, nchains=nc, chunk_size=2,
              measure_pair_corr=True)
    jgm = j_vmc.GradedFermionModel.from_model(j_fermion.tj_model(3.0, 1.0),
                                              JSPACE, jnp.float64)
    ref = j_measure.measure(jnp.asarray(tps), jgm,
                            j_measure.MeasurementParams(**kw), chi, jt,
                            JRule("exchange"), jnp.asarray(cfgs), key)
    it = iter(measure_uniforms(key, nc, ly, lx, 1, 4, graded_sweep_uniforms))
    gm = GradedFermionModel.from_model(fermion.tj_model(3.0, 1.0), SPACE,
                                       torch.float64, "cpu")
    out = measure.measure(t(tps), gm, measure.MeasurementParams(
        **kw, eval_chunk=3, env_chunk=2), chi, pt, UpdateRule("exchange"),
        t(cfgs), sweep_uniforms=lambda: next(it))
    _compare_results(out, ref, FERMION_KEYS)
    assert np.abs(ref.stats["pair_corr_col"][0]).max() > 1e-4


def test_jw_measure_matches_reference(jax_blocks):
    """A Jordan-Wigner t-J measure() with the pair correlators (both
    frames, on the energy pass's stacks), replayed against the
    reference's."""
    ly, lx, chi, nc = 2, 4, 4, 4
    rng = np.random.default_rng(12)
    tps = rng.standard_normal((ly, lx, 3, 2, 2, 2, 2))
    cfgs = hole_configs(rng, nc, ly, lx, _counts(ly, lx))
    key = jax.random.PRNGKey(4)
    jt, pt = sketch(chi)
    kw = dict(num_samples=4, num_warmup_sweeps=1, nchains=nc, chunk_size=2,
              measure_pair_corr=True)
    ref = j_measure.measure(jnp.asarray(tps), j_fermion.tj_model(3.0, 1.0),
                            j_measure.MeasurementParams(**kw), chi, jt,
                            JRule("exchange"), jnp.asarray(cfgs), key)
    it = iter(measure_uniforms(key, nc, ly, lx, 1, 4, jax_sweep_uniforms))
    out = measure.measure(t(tps), fermion.tj_model(3.0, 1.0),
                          measure.MeasurementParams(**kw), chi, pt,
                          UpdateRule("exchange"), t(cfgs),
                          sweep_uniforms=lambda: next(it))
    _compare_results(out, ref, FERMION_KEYS)
    assert np.abs(ref.stats["pair_corr_row"][0]).max() > 1e-4


# --------------------------------------------- the conditioned estimator

def test_conditioned_pair_corr_matches_exact_sum():
    """The support-conditioned <Delta^dag Delta> (the reference's
    test_pair_corr.py:437 and examples/flagship_pc_cond.py): chains under
    the hard hole-attraction dress stay in A (holes Chebyshev-adjacent);
    P(A) exact times E[table | A] matches the exact sector sum on the 2x4
    ladder, and the counting run's P(A) the exact one."""
    model = fermion.tj_model(3.0, 1.0)
    ly, lx, chi = 2, 4, 16
    occ0 = np.array([[1, 2, 1, 0], [2, 1, 2, 0]])
    tps, space = su_state(model, ly, lx, 3, occ0, ((80, 0.2), (80, 0.05)))
    pt = TruncParams(chi, 1, 0.0, scheme="sketch")
    cfg_all = sector_configs(ly, lx, {0: 2, 1: 3, 2: 3})
    exact, _ = exact_sum_pair_corr_graded(tps, cfg_all, space, chi, pt,
                                          frames=("row",))
    la, mant = log_abs_psi_fermion(tps, t(cfg_all), space, chi, pt)
    alive = mant != 0
    w = torch.where(alive, torch.exp(2 * (la - la[alive].max())), 0.0)
    in_a = holes_adjacent(t(cfg_all), mf.HOLE_VALUES) > 0.5
    pa_exact = float(w[in_a].sum() / w.sum())

    nch, warm, ns = 8, 30, 150
    occ_a = np.array([[1, 2, 1, 2], [2, 1, 0, 0]])
    _, tabs, inds = mf.conditioned_pair_tables(
        tps, space, t(np.stack([occ_a] * nch)), chi, pt, warm, ns,
        torch.Generator().manual_seed(11), frames=("row",), env_chunk=None)
    assert bool((inds > 0.5).all())          # no chain ever unbinds
    tab = tabs["row"]
    m, e = statistics.mean_and_binned_error_batch(tab.reshape(ns, nch, -1))
    m = m.reshape(ly, lx - 1, lx - 1).numpy() * pa_exact
    e = e.reshape(ly, lx - 1, lx - 1).numpy() * pa_exact
    ex = exact["row"]
    assert abs(m[0, 0, 2] - ex[0, 0, 2]) < 5 * e[0, 0, 2] \
        + 0.1 * abs(ex[0, 0, 2]), (m[0, 0, 2], e[0, 0, 2], ex[0, 0, 2])
    assert e[0, 0, 2] < 0.5 * abs(ex[0, 0, 2])

    _, ind = mf.count_adjacent(tps, space, t(np.stack([occ0] * nch)), chi,
                               pt, warm + ns,
                               torch.Generator().manual_seed(13))
    pa_m, pa_e = statistics.mean_and_binned_error_batch(
        ind[warm:, :, None].double())
    assert abs(float(pa_m[0]) - pa_exact) < 5 * float(pa_e[0]) + 0.05, \
        (float(pa_m[0]), float(pa_e[0]), pa_exact)
