"""Parity of the port's measurement slice (peps_tpu_torch.algorithm.measure,
registry, exact_measure, exact_sum and the statistics) with the JAX
package, in float64 on the CPU.

The sketch compression runs on the reference's Gaussian blocks; the port's
sweeps are driven by the uniforms that the reference's key stream gives
(tests/test_torch_sweep.py:jax_sweep_uniforms). Tolerances: 1e-10 relative
for every contraction result, 1e-12 for host statistics on the same
samples, 1e-8 absolute against the dense-operator ED (as the reference's
own test holds itself).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import exact_measure as j_exm
from peps_tpu.algorithm import exact_sum as j_exs
from peps_tpu.algorithm import measure as j_measure
from peps_tpu.algorithm import registry as j_registry
from peps_tpu.algorithm.energy import ModelTensors as JModelTensors
from peps_tpu.contraction import bmps as j_bmps
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo import statistics as j_stats
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.tps import project as j_project
from peps_tpu.tps import random_tps as j_random_tps
from peps_tpu_torch.algorithm import exact_sum, measure, registry
from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.algorithm.exact_measure import exact_sum_measure
from peps_tpu_torch.algorithm.mc_evaluator import mc_energy_only
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.montecarlo import statistics
from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms, \
    mc_sweep
from peps_tpu_torch.tps import project
from ed_oracle import _embed_one_site, _embed_two_site, wavefunction_from_tps
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_sweep import jax_sweep_uniforms, neel_like_configs, random_tps

RTOL = 1e-10
SP = np.array([[0.0, 1.0], [0.0, 0.0]])


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def sketch(chi):
    return (JTrunc(chi, 1, 1e-12, scheme="sketch"),
            TruncParams(chi, 1, 1e-12, scheme="sketch"))


# ---------------------------------------------------------------- walker

def _j_walker(chi, jt):
    def one(tps, c):
        tn = j_project(tps, c)
        st = j_bmps.all_env_stacks(tn, chi, jt)
        return j_measure._row_offdiag_corr(tps, tn, c, jnp.asarray(SP),
                                           jnp.asarray(SP.T), chi, jt, st)
    return jax.jit(jax.vmap(one, in_axes=(None, 0)))


@pytest.mark.parametrize("ly,lx,D,chi", [(2, 3, 2, 4), (3, 3, 3, 9)])
def test_row_offdiag_corr_matches_reference(ly, lx, D, chi, jax_blocks):
    """Both frames, through shared stacks: the normal frame of tps and the
    transposed frame of its diagonal reflection."""
    rng = np.random.default_rng(10 * ly + D)
    tps = random_tps(rng, ly, lx, 2, D)
    cfgs = neel_like_configs(rng, 3, ly, lx)
    jt, pt = sketch(chi)
    fn = _j_walker(chi, jt)
    tt = torch.as_tensor(tps)
    sp = torch.as_tensor(SP)
    for frame_tps, frame_cfg in ((tt, torch.as_tensor(cfgs).long()),
                                 (transpose_tps(tt),
                                  torch.as_tensor(cfgs).long().transpose(1, 2))):
        ref = fn(jnp.asarray(frame_tps.numpy()), jnp.asarray(frame_cfg.numpy()))
        tn = project(frame_tps, frame_cfg)
        stacks = tb.all_env_stacks(tn, chi, pt)
        out = measure._row_offdiag_corr(frame_tps, tn, frame_cfg, sp, sp.T,
                                        chi, pt, stacks)
        assert out.shape == ref.shape
        assert rel(out, ref) < RTOL
        assert np.abs(np.asarray(ref)).max() > 1e-3      # not a zero table


# ------------------------------------------------------------ statistics

@pytest.mark.parametrize("shape", [(16, 3, 5), (9, 1, 4), (10, 4, 1)])
def test_binned_statistics_and_autocorrelation(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    x = np.cumsum(x, axis=0) * 0.3 + x          # correlated along sweeps
    m, e = statistics.mean_and_binned_error_batch(torch.as_tensor(x))
    jm, je = j_stats.mean_and_binned_error_batch(jnp.asarray(x))
    assert np.abs(m.numpy() - np.asarray(jm)).max() < 1e-12
    assert np.abs(e.numpy() - np.asarray(je)).max() < 1e-12
    flat = x.reshape(shape[0], -1)
    tau = statistics.integrated_autocorrelation_time(flat)
    assert abs(tau - j_stats.integrated_autocorrelation_time(flat)) < 1e-12
    assert np.abs(statistics.autocorrelation(flat, 3)
                  - j_stats.autocorrelation(flat, 3)).max() < 1e-12


# ------------------------------------------------------------ exact sums

LY, LX, ED_CHI = 2, 3, 4


@pytest.fixture(scope="module")
def ed_state():
    """The reference test's state (test_measure.py) and its exact values:
    the JAX package's exact_sum_measure and the dense-operator ED. To keep
    the reference's compile short: the sketch at chi = 4 (the reference's
    test takes the svd scheme at 12; two rows of D = 3 contract exactly
    from chi = 3 on), and the model's horizontal bonds only (its energy is
    compared with the reference's; sz and S+S- do not depend on it)."""
    tps = np.asarray(j_random_tps(jax.random.PRNGKey(2), LY, LX, 2, 3,
                                  dtype=jnp.float64, scale=0.8))
    configs = j_exs.all_configs(LY, LX, 2)
    ref = j_exm.exact_sum_measure(
        jnp.asarray(tps), jnp.asarray(configs),
        j_spin.SquareLatticeModel(2, j_spin.heisenberg_bond(1.0)), ED_CHI,
        sketch(ED_CHI)[0])
    psi = wavefunction_from_tps(tps)
    z = np.vdot(psi, psi)
    n = LY * LX
    sz_op = np.array([[0.5, 0], [0, -0.5]])
    sz = np.array([np.real(np.vdot(psi, _embed_one_site(sz_op, i, n, 2) @ psi)
                           / z) for i in range(n)]).reshape(LY, LX)
    spsm = np.zeros((LY, LX, LX))
    for y in range(LY):
        for x1 in range(LX):
            for x2 in range(x1 + 1, LX):
                op = _embed_two_site(np.einsum("ac,bd->abcd", SP, SP.T),
                                     y * LX + x1, y * LX + x2, n, 2)
                spsm[y, x1, x2] = np.real(np.vdot(psi, op @ psi) / z)
    return tps, configs, ref, sz, spsm


def test_exact_sum_measure_matches_reference_and_ed(ed_state, jax_blocks):
    tps, configs, ref, sz, spsm = ed_state
    out = exact_sum_measure(
        torch.as_tensor(tps), configs,
        spin.SquareLatticeModel(2, spin.heisenberg_bond(1.0)), ED_CHI,
        sketch(ED_CHI)[1])
    assert set(out.values) == set(ref.values)
    for key, val in out.values.items():
        assert rel(val, ref.values[key]) < RTOL, key
    assert np.abs(out.values["sz"] - sz).max() < 1e-8
    mask = np.triu(np.ones((LX, LX)), 1)[None]
    assert np.abs((out.values["spsm_row"] - spsm) * mask).max() < 1e-8
    assert abs(float(out.weight_sum) - float(ref.weight_sum)) \
        < RTOL * float(ref.weight_sum)


def test_configuration_enumerators():
    assert np.array_equal(exact_sum.all_configs(2, 2, 3),
                          j_exs.all_configs(2, 2, 3))
    for occ in ({0: 3, 1: 3}, {0: 2, 1: 1, 2: 1}):
        ly, lx = (2, 3) if sum(occ.values()) == 6 else (2, 2)
        ref = np.asarray(j_exs.sector_configs(ly, lx, occ))
        out = exact_sum.sector_configs(ly, lx, occ)
        assert np.array_equal(out, ref[np.lexsort(ref.reshape(len(ref), -1)
                                                  .T[::-1])])
    padded, mask = exact_sum.pad_configs(np.zeros((5, 2, 2), np.int32), 4)
    ref_p, ref_m = j_exs.pad_configs(np.zeros((5, 2, 2), np.int32), 4)
    assert padded.shape == ref_p.shape and np.array_equal(mask, ref_m)
    with pytest.raises(ValueError):
        exact_sum.sector_configs(2, 2, {0: 3})


@pytest.fixture(scope="module")
def grad_case():
    rng = np.random.default_rng(41)
    tps = random_tps(rng, 2, 3, 2, 2)
    configs = j_exs.sector_configs(2, 3, {0: 3, 1: 3})
    jm = JModelTensors.from_model(j_spin.heisenberg(), jnp.float64)
    chi = 4
    jt = JTrunc(chi, 1, 1e-12)
    mask = np.arange(len(configs)) % 7 != 3       # a few padding rows
    eg = j_exs.exact_sum_energy_gradient(jnp.asarray(tps), jnp.asarray(configs),
                                         jm, chi, jt, mask=jnp.asarray(mask))
    ev = j_exs.exact_sum_evaluation(jnp.asarray(tps), jnp.asarray(configs), jm,
                                    chi, jt, with_sr_buffers=True)
    return tps, configs, chi, mask, eg, ev


def test_exact_sum_energy_gradient_and_evaluation(grad_case):
    tps, configs, chi, mask, eg, ev = grad_case
    tt = torch.as_tensor(tps)
    pt = TruncParams(chi, 1, 1e-12)
    out = exact_sum.exact_sum_energy_gradient(
        tt, configs, spin.heisenberg(), chi, pt, batch_size=6, mask=mask)
    assert abs(float(out.energy) - float(eg.energy)) < RTOL * abs(float(eg.energy))
    assert rel(out.gradient, eg.gradient) < RTOL
    assert abs(float(out.weight_sum) / float(eg.weight_sum) - 1) < RTOL
    evo = exact_sum.exact_sum_evaluation(tt, configs, spin.heisenberg(), chi,
                                         pt, with_sr_buffers=True)
    assert abs(float(evo.energy) - float(ev.energy)) < RTOL * abs(float(ev.energy))
    for name in ("gradient", "o_samples", "e_samples"):
        assert rel(getattr(evo, name), getattr(ev, name)) < RTOL, name
    # the torus exact sum runs now: the OBC-masked state, contracted as a
    # torus (its wrap bonds carry index 0 only), has the OBC amplitudes
    from peps_tpu_torch.lattice import BoundaryCondition
    tor = exact_sum.exact_sum_energy_gradient(
        tt, configs, spin.heisenberg(), 16, TruncParams(16, 1, 0.0),
        with_grad=False, bc=BoundaryCondition.PERIODIC, mask=mask)
    assert abs(float(tor.weight_sum) / float(eg.weight_sum) - 1) < 1e-8
    with pytest.raises(NotImplementedError, match="the port takes bosonic"):
        exact_sum.exact_sum_energy_gradient(tt, configs[:2], object(), chi, pt)


# ------------------------------------------------- measure(), whole slice

M_LY, M_LX, M_D, M_CHI, M_NC = 2, 3, 2, 4, 4
# two chunks of 3 samples (one compile of the reference's sample scan),
# two sweeps between samples
M_WARM, M_SAMPLES, M_CHUNK, M_BETWEEN = 2, 6, 3, 2


def measure_uniforms(key, nc, ly, lx, n_warm, n_sweeps):
    """Each sweep's uniforms in the order the reference's measure() draws
    them (measure.py:383-398, 486-506): the warm-up from split(key)[1],
    re-split per sweep into nc + 1, then the samples from split(key)[0]
    the same way."""
    key, ks = jax.random.split(key)
    out = []
    for k, n in ((ks, n_warm), (key, n_sweeps)):
        for _ in range(n):
            kc = jax.random.split(k, nc + 1)
            k = kc[0]
            out.append(jax_sweep_uniforms(kc[1:], ly, lx))
    return out


@pytest.fixture(scope="module")
def measured():
    """One JAX measure() and what the port needs to replay it."""
    rng = np.random.default_rng(7)
    tps = random_tps(rng, M_LY, M_LX, 2, M_D)
    cfgs = neel_like_configs(rng, M_NC, M_LY, M_LX)
    key = jax.random.PRNGKey(11)
    jt, _ = sketch(M_CHI)
    params = j_measure.MeasurementParams(
        num_samples=M_SAMPLES, num_warmup_sweeps=M_WARM, nchains=M_NC,
        chunk_size=M_CHUNK, measure_offdiag_corr=True,
        sweeps_between_samples=M_BETWEEN)
    ref = j_measure.measure(jnp.asarray(tps), j_spin.heisenberg(), params,
                            M_CHI, jt, JRule("exchange"), jnp.asarray(cfgs),
                            key)
    uni = measure_uniforms(key, M_NC, M_LY, M_LX, M_WARM,
                           M_SAMPLES * M_BETWEEN)
    return tps, cfgs, uni, ref


def _port_measure(measured, dump_dir=None, **params):
    tps, cfgs, uni, _ = measured
    it = iter(uni)
    params = measure.MeasurementParams(**{
        "num_samples": M_SAMPLES, "num_warmup_sweeps": M_WARM,
        "nchains": M_NC, "chunk_size": M_CHUNK, "measure_offdiag_corr": True,
        "sweeps_between_samples": M_BETWEEN, **params})
    return measure.measure(torch.as_tensor(tps), spin.heisenberg(), params,
                           M_CHI, sketch(M_CHI)[1], UpdateRule("exchange"),
                           torch.as_tensor(cfgs), sweep_uniforms=lambda: next(it),
                           dump_dir=dump_dir)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.all(np.abs(a - b) <= np.maximum(RTOL * np.abs(b), 1e-12))


def _csv_values(path):
    """Numbers of a stats CSV; the reference's numpy-2 repr writes
    'np.float64(x)' where the port writes 'x'."""
    rows = open(path).read().splitlines()[1:]
    return np.array([[float(v) for v in re.findall(
        r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf|nan)",
        row.split(",", 1)[1].replace("np.float64", ""))] for row in rows])


def test_measure_matches_reference(measured, jax_blocks, tmp_path):
    ref = measured[3]
    out = _port_measure(measured, dump_dir=str(tmp_path / "port"))
    assert set(out.stats) == set(ref.stats) == {
        "energy", "sz", "szsz", "spsm_row", "spsm_col"}
    for key, (m, e) in out.stats.items():
        jm, je = ref.stats[key]
        assert np.shape(m) == np.shape(jm), key
        assert _close(m, jm) and _close(e, je), key
    assert np.abs(ref.stats["spsm_row"][0]).max() > 1e-3
    assert np.abs(ref.stats["spsm_col"][0]).max() > 1e-3
    assert out.accept_rate == ref.accept_rate
    assert rel(out.psi_samples, ref.psi_samples) < RTOL
    assert abs(out.energy_autocorr_time - ref.energy_autocorr_time) \
        < RTOL * abs(ref.energy_autocorr_time)
    assert out.sampling_wall_s > 0
    assert set(out.metas) == set(ref.metas)
    for key, meta in out.metas.items():
        jmeta = ref.metas[key]
        assert (meta.key, meta.description, meta.shape, meta.index_labels) \
            == (jmeta.key, jmeta.description, jmeta.shape, jmeta.index_labels)
        assert (meta.coords is None) == (jmeta.coords is None)
        if meta.coords is not None:
            assert np.array_equal(meta.coords, jmeta.coords)
    j_measure.dump_stats(ref, str(tmp_path / "ref"))
    for sub in ("stats", "samples"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "ref" / sub))
        for name in names:
            a, b = tmp_path / "port" / sub / name, tmp_path / "ref" / sub / name
            if name.endswith("_coords.txt"):
                assert a.read_text() == b.read_text()
                continue
            va = _csv_values(a) if sub == "stats" else np.loadtxt(a, delimiter=",")
            vb = _csv_values(b) if sub == "stats" else np.loadtxt(b, delimiter=",")
            assert va.shape == vb.shape and _close(va, vb), name


@pytest.mark.parametrize("chunks,rtol", [
    ({"chunk_size": 0}, 0.0),
    ({"eval_chunk": 3, "env_chunk": 1}, RTOL)])
def test_measure_chunking_changes_nothing(measured, jax_blocks, chunks, rtol):
    """One sample chunk gives the statistics of the sample chunks of 3
    bit for bit; energy and walker passes in chain batches of 3 and 1 give
    them to round-off (other batch sizes sum in another order)."""
    a = _port_measure(measured)
    b = _port_measure(measured, **chunks)
    for key, (m, e) in a.stats.items():
        for x, y in ((m, b.stats[key][0]), (e, b.stats[key][1])):
            assert np.all(np.abs(x - y) <= rtol * np.abs(y)), key
    assert a.accept_rate == b.accept_rate


def test_measure_stops_after_the_chunk_on_a_signal():
    """handle_signals: SIGTERM during the first chunk stops the loop after
    it (statistics of that chunk only), and the old handlers come back.
    The handler is called directly, so a missing one fails the test instead
    of ending the process."""
    import signal
    rng = np.random.default_rng(2)
    tps = torch.as_tensor(random_tps(rng, 2, 2, 2, 2))
    gen = torch.Generator().manual_seed(0)
    before = signal.getsignal(signal.SIGTERM)

    def uniforms():
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler) and handler is not before
        handler(signal.SIGTERM, None)
        return draw_uniforms(gen, 2, 2, 2, torch.float64, "cpu")

    res = measure.measure(
        tps, spin.heisenberg(), measure.MeasurementParams(
            num_samples=6, num_warmup_sweeps=0, chunk_size=2,
            handle_signals=True), 4, sketch(4)[1], UpdateRule(),
        torch.as_tensor(neel_like_configs(rng, 2, 2, 2)),
        sweep_uniforms=uniforms)
    assert res.psi_samples.shape == (2, 2)
    assert signal.getsignal(signal.SIGTERM) is before


def test_measure_rejects_what_the_port_lacks():
    """Fermionic models are refused on the torus (with and without the
    pair correlators; the torus contractor is boson-only, as the
    reference's) and so is an object that is no model."""
    tps = torch.zeros(2, 2, 2, 1, 1, 1, 1, dtype=torch.float64)
    cfg = torch.zeros(1, 2, 2, dtype=torch.int64)
    tp = TruncParams(2)
    from peps_tpu_torch.lattice import BoundaryCondition
    from peps_tpu_torch.models.fermion import spinless_fermion
    for params in (measure.MeasurementParams(),
                   measure.MeasurementParams(measure_pair_corr=True)):
        with pytest.raises(ValueError, match="boson-only"):
            measure.measure(tps, spinless_fermion(1.0, 0.5), params, 2, tp,
                            UpdateRule(), cfg, bc=BoundaryCondition.PERIODIC)
    with pytest.raises(NotImplementedError, match="the port takes bosonic"):
        measure.measure(tps, object(), measure.MeasurementParams(), 2, tp,
                        UpdateRule(), cfg)


def test_mc_energy_only_two_sweeps_between_samples(measured, jax_blocks):
    """The reference's measure() energy is the binned mean and error of
    E_loc over its samples, two sweeps apart: mc_energy_only, started from
    the configurations after the same warm-up, must give both."""
    tps, cfgs, uni, ref = measured
    tt = torch.as_tensor(tps)
    pt = sketch(M_CHI)[1]
    cfg = torch.as_tensor(cfgs)
    for u in uni[:M_WARM]:
        cfg, _ = mc_sweep(tt, transpose_tps(tt), cfg, M_CHI, pt, uniforms=u)
    it = iter(uni[M_WARM:])
    mt = ModelTensors.from_model(spin.heisenberg(), torch.float64, "cpu")
    e, err = mc_energy_only(tt, cfg, mt, M_CHI, pt, UpdateRule("exchange"),
                            M_SAMPLES, lambda: next(it),
                            sweeps_between=M_BETWEEN)
    je, jerr = ref.stats["energy"]
    assert abs(float(e) - je) < RTOL * abs(je)
    assert abs(float(err) - jerr) < RTOL * abs(jerr)
    with pytest.raises(StopIteration):
        next(it)                      # every replayed sweep was taken


# ----------------------------------------------------------- host helpers

def test_host_helpers_match_reference():
    rng = np.random.default_rng(3)
    ly, lx = 3, 4
    szsz = rng.standard_normal((ly * lx, ly * lx))
    sz = rng.standard_normal((ly, lx))
    assert np.abs(measure.structure_factor(szsz, sz, ly, lx)
                  - j_measure.structure_factor(szsz, sz, ly, lx)).max() < 1e-12
    c = np.triu(rng.standard_normal((ly, lx, lx)), 1)
    assert np.abs(registry.structure_factor_spsm_row(c, lx)
                  - j_registry.structure_factor_spsm_row(c, lx)).max() < 1e-12
    e = rng.standard_normal((16, 6))
    assert abs(measure.replica_gap(e) - j_measure.replica_gap(e)) < 1e-12
    cfg = rng.integers(0, 2, (5, 4, ly, lx))
    assert np.array_equal(measure.particle_number_distribution(cfg, 1),
                          j_measure.particle_number_distribution(cfg, 1))
    for fn in ("site_coords", "pair_coords", "row_segment_coords"):
        assert np.array_equal(getattr(registry, fn)(ly, lx),
                              getattr(j_registry, fn)(ly, lx))
