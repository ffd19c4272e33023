"""Parity of the port's ratio tables, Jastrow dress and psi-consistency
monitor (peps_tpu_torch.algorithm.energy, .montecarlo.jastrow) with the
JAX package, in float64.

Inputs are made with numpy from a seed; the sketch compression gets the
reference's Gaussian blocks. The tables run at chi = 3 on 3x3 D=3, where
the compression truncates, so a table taken on another route than the
reference's would miss by the truncation error. Tolerance: 1e-10 relative
(both sides are exact contractions of the same tensors). psi is compared
as log|psi| and the sign of its mantissa: how psi splits between the
mantissa and the stack's log weight follows per-core norms that round-off
moves at a truncating chi (the reference's jit and eager runs differ there
by 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy as j_energy
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo import jastrow as j_jastrow
from peps_tpu_torch.algorithm import energy
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.montecarlo import jastrow
from test_torch_bmps import jax_sketch_blocks, rel, t
from test_torch_sweep import neel_like_configs, random_tps

RTOL = 1e-10
FIELDS = ("ratio1", "ratio_h", "ratio_v", "ratio_d", "ratio_ad", "o_tensor",
          "psi_loc", "log_abs_psi")


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def _models(name):
    if name == "j1j2_xxz":
        return j_spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4), \
            spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4)
    return j_spin.triangle_j1j2_nnn(1.0, 0.3), spin.triangle_j1j2_nnn(1.0, 0.3)


def _setup(nc=3):
    rng = np.random.default_rng(11)
    ly, lx, chi = 3, 3, 3
    return (chi, random_tps(rng, ly, lx, 2, 3),
            neel_like_configs(rng, nc, ly, lx))


def _dress(seed, n, scale=0.3):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, n)) * scale
    v = v + v.T
    np.fill_diagonal(v, 0.0)
    return v, np.array([0.25, 1.0])


@pytest.mark.parametrize("need", [("h", "v", "d", "ad"), ("h", "d")])
def test_compute_ratio_tables_matches_reference(need, jax_blocks):
    chi, tps, cfgs = _setup()
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    ref = jax.jit(jax.vmap(lambda c: j_energy.compute_ratio_tables(
        jnp.asarray(tps), c, chi, jt, need)))(jnp.asarray(cfgs))
    out = energy.compute_ratio_tables(
        t(tps), t(cfgs), chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
        need)
    for f in FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.shape == b.shape, f
            assert rel(a, b) < RTOL, f
    assert np.array_equal(np.sign(out.psi_mant.numpy()),
                          np.sign(np.asarray(ref.psi_mant)))


@pytest.mark.parametrize("name", ["j1j2_xxz", "triangle_j1j2_nnn"])
def test_dressed_energy_matches_reference(name, jax_blocks):
    chi, tps, cfgs = _setup()
    v, nvals = _dress(5, 9)
    jm = j_energy.ModelTensors.from_model(_models(name)[0], jnp.float64)
    jd = j_jastrow.JastrowDress(jnp.asarray(v), jnp.asarray(nvals))
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    ref = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes_dressed(
        jnp.asarray(tps), c, jm, jd, chi, jt)))(jnp.asarray(cfgs))
    dress = jastrow.JastrowDress(t(v), t(nvals))
    pt = TruncParams(chi, 1, 1e-12, scheme="sketch")
    out = energy.local_energy_and_holes_dressed(
        t(tps), t(cfgs), _models(name)[1], dress, chi, pt)
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < RTOL, f
    # a zero v changes nothing, and the tables' energy is the evaluator's
    zero = jastrow.JastrowDress(torch.zeros(9, 9, dtype=torch.float64),
                                t(nvals))
    e0 = energy.local_energy_and_holes_dressed(
        t(tps), t(cfgs), _models(name)[1], zero, chi, pt, with_holes=False)
    plain = energy.local_energy_and_holes_dressed(
        t(tps), t(cfgs), _models(name)[1], None, chi, pt, with_holes=False)
    assert torch.equal(e0.e_loc, plain.e_loc)
    mt = energy.ModelTensors.from_model(_models(name)[1], torch.float64,
                                        "cpu")
    ev = energy.local_energy_and_holes(t(tps), t(cfgs), mt, chi, pt,
                                       with_holes=False)
    assert rel(plain.e_loc, ev.e_loc) < RTOL


def test_dressed_energy_refuses_longer_range_terms():
    chi, tps, cfgs = _setup(1)
    v, nvals = _dress(1, 9)
    with pytest.raises(ValueError, match="h_s5a"):
        energy.local_energy_and_holes_dressed(
            t(tps), t(cfgs), spin.triangle_j1j2_heisenberg(1.0, 0.5),
            jastrow.JastrowDress(t(v), t(nvals)), chi, TruncParams(chi))


def test_psi_consistency_check_matches_reference(jax_blocks):
    chi, tps, cfgs = _setup()
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    ref_rel, ref_logs = jax.jit(jax.vmap(
        lambda c: j_energy.psi_consistency_check(jnp.asarray(tps), c, chi,
                                                 jt)))(jnp.asarray(cfgs))
    out_rel, out_logs = energy.psi_consistency_check(
        t(tps), t(cfgs), chi, TruncParams(chi, 1, 1e-12, scheme="sketch"))
    assert rel(out_logs, ref_logs) < RTOL
    np.testing.assert_allclose(out_rel.numpy(), np.asarray(ref_rel),
                               atol=1e-10)
    assert float(out_rel.max()) > 1e-8       # chi = 3 truncates: rows differ


def test_jastrow_functions_match_reference():
    ly, lx = 3, 4
    v, nvals = _dress(2, ly * lx)
    cfgs = np.random.default_rng(3).integers(0, 2, (4, ly, lx))
    jd = j_jastrow.JastrowDress(jnp.asarray(v), jnp.asarray(nvals))
    dress = jastrow.JastrowDress(t(v), t(nvals))
    idx1, idx2 = np.array([0, 5, 7]), np.array([1, 9, 11])
    one = jastrow.one_site_log_ratios(dress, t(cfgs), ly, lx)
    two = jastrow.two_site_log_ratios(dress, t(cfgs), t(idx1), t(idx2))
    logf = dress.log_factor(t(cfgs))
    for n, c in enumerate(cfgs):
        jc = jnp.asarray(c)
        assert rel(one[n], j_jastrow.one_site_log_ratios(jd, jc, ly, lx)) \
            < 1e-12
        assert rel(two[n], j_jastrow.two_site_log_ratios(
            jd, jc, jnp.asarray(idx1), jnp.asarray(idx2))) < 1e-12
        assert abs(float(logf[n]) - float(jd.log_factor(jc))) < 1e-12
        assert rel(dress.field(t(c)), jd.field(jc)) < 1e-12
    for diagonal in (False, True):
        hd = jastrow.hole_attraction_dress([1.0, 0.0, 0.0], ly, lx, 2.5,
                                           diagonal, device="cpu")
        jhd = j_jastrow.hole_attraction_dress([1.0, 0.0, 0.0], ly, lx, 2.5,
                                              diagonal)
        assert rel(hd.v, jhd.v) == 0.0 and rel(hd.nvals, jhd.nvals) == 0.0
        tj = np.random.default_rng(4).integers(0, 3, (6, ly, lx))
        got = jastrow.holes_adjacent(t(tj), [1.0, 0.0, 0.0], diagonal)
        want = [float(j_jastrow.holes_adjacent(jnp.asarray(c),
                                               jnp.asarray([1.0, 0.0, 0.0]),
                                               diagonal)) for c in tj]
        assert got.tolist() == want
