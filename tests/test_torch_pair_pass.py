"""Parity of the port's long-range energy terms (the two-row pair pass, the
third-neighbour traces, kernel K3's plain version) with the JAX package, in
float64.

Inputs are made with numpy from a seed and handed to both packages; the
sketch compression gets the reference's Gaussian blocks. Tolerance: 1e-10
relative, since both sides are exact contractions of the same tensors. The
local-energy cases run at chi = 3 on 3x3 D=3, where the compression
truncates, so a term taken on another route than the reference's (the
transposed frame instead of the two-row sandwiches, or the reverse) would
miss by the truncation error, far above 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy as j_energy
from peps_tpu.algorithm import vmc_optimize as j_vmc
from peps_tpu.algorithm.mc_evaluator import MCParams as JMC
from peps_tpu.contraction import bmps as jb
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo.engine import init_configs_occupancy
from peps_tpu.optimizer import optimizer as j_opt
from peps_tpu.optimizer.cg import CGParams as JCG
from peps_tpu_torch.algorithm import energy
from peps_tpu_torch.algorithm.exact_sum import (all_configs,
                                                exact_sum_energy_gradient)
from peps_tpu_torch.algorithm.mc_evaluator import MCParams
from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.kernels.pair_transfer import (pair_transfer_plain,
                                                  pair_transfer_right)
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.optimizer.cg import CGParams
from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
from test_torch_bmps import jax_sketch_blocks, random_tn, rel, t
from test_torch_sweep import neel_like_configs, random_tps
from test_torch_vmc import jax_vmc_uniforms

RTOL = 1e-10


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def _asym_bond():
    """A hermitian two-site coupling that is not swap-symmetric (the
    reference's test_longrange_traces.py): catches index-order mistakes."""
    m = np.random.default_rng(0).normal(size=(4, 4))
    return (m + m.T).reshape(2, 2, 2, 2)


def _model(name, pkg):
    """The same model from the JAX package (pkg = j_spin) or the port."""
    hb = pkg.heisenberg_bond
    if name == "j1j2_xxz":
        return pkg.j1j2_xxz(1.0, 0.8, 0.5, 0.4)
    if name == "triangle_j1j2":
        return pkg.triangle_j1j2_heisenberg(1.0, 0.5)
    if name == "triangle_nnn":
        return pkg.triangle_j1j2_nnn(1.0, 0.3)
    if name in ("s5a", "s5b"):
        return pkg.SquareLatticeModel(2, h_h=hb(1.0),
                                      **{f"h_{name}": _asym_bond()})
    if name == "v_and_s5b":      # h_v on the transposed frame beside h_s5b
        return pkg.SquareLatticeModel(2, h_h=hb(1.0), h_v=hb(0.7),
                                      h_s5b=_asym_bond())
    if name == "tnn":
        return pkg.SquareLatticeModel(2, h_h=hb(1.0), h_v=hb(1.0),
                                      h_tnn_h=hb(0.7), h_tnn_v=0.4 * hb(0.7))
    raise KeyError(name)


@pytest.mark.parametrize("chi,D,c", [(4, 2, 4), (5, 2, 3)])
def test_pair_transfer_plain_matches_reference(chi, D, c):
    """K3's plain version, both forms, against the reference's one-row
    transfer on the column-fused site."""
    rng = np.random.default_rng(chi * 10 + c)
    env = rng.standard_normal((chi, D, D, c))
    top = rng.standard_normal((chi, D, chi))
    row1 = rng.standard_normal((D,) * 4)
    row2 = rng.standard_normal((D,) * 4)
    bot = rng.standard_normal((c, D, c))
    fused = np.asarray(j_energy._fuse_pair_columns(row1[None], row2[None]))[0]
    ref = jb._col_transfer_left(env.reshape(chi, D * D, c), top, fused, bot)
    out = pair_transfer_plain(t(env), t(top), t(row1), t(row2), t(bot))
    assert rel(out.reshape(chi, D * D, c), ref) < RTOL
    renv = rng.standard_normal((chi, D, D, c))
    ref_r = jb._col_transfer_right(renv.reshape(chi, D * D, c), top, fused,
                                   bot)
    out_r = pair_transfer_right(t(renv), t(top), t(row1), t(row2), t(bot),
                                transfer=pair_transfer_plain)
    assert rel(out_r.reshape(chi, D * D, c), ref_r) < RTOL


def test_pair_row_envs_with_logs():
    rng = np.random.default_rng(3)
    lx, chi, D = 4, 5, 2
    tn = random_tn(rng, 2, lx, D)
    top = rng.standard_normal((lx, chi, D, chi))
    bot = rng.standard_normal((lx, chi, D, chi))
    ref = j_energy._pair_row_envs(top, bot, tn[0], tn[1], jnp.float64,
                                  with_logs=True)
    out = energy._pair_row_envs(t(top), t(bot), t(tn[0]), t(tn[1]),
                                with_logs=True)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert rel(o, r) < RTOL


def test_replace_tnn_site_traces():
    rng = np.random.default_rng(4)
    lx, chi, D, d = 5, 4, 2, 2
    row = random_tn(rng, 1, lx, D)[0]
    cands = rng.standard_normal((lx, d) + (D,) * 4)
    top = rng.standard_normal((lx, chi, D, chi))
    bot = rng.standard_normal((lx, chi, D, chi))
    ref = jb.replace_tnn_site_traces(jb.row_envs(top, bot, row), top, bot,
                                     cands[:lx - 2], row[1:lx - 1], cands[2:])
    envs = tb.row_envs(t(top), t(bot), t(row))
    out = tb.replace_tnn_site_traces(envs, t(top), t(bot), t(cands[:lx - 2]),
                                     t(row[1:lx - 1]), t(cands[2:]))
    assert out.shape == (lx - 2, d, d)
    assert rel(out, ref) < RTOL


def _route_setup():
    rng = np.random.default_rng(11)
    ly, lx, chi = 3, 3, 3
    return (ly, lx, chi, random_tps(rng, ly, lx, 2, 3),
            neel_like_configs(rng, 3, ly, lx))


@pytest.mark.parametrize("name", ["j1j2_xxz", "triangle_j1j2",
                                  "triangle_nnn", "s5a", "s5b", "v_and_s5b",
                                  "tnn"])
def test_local_energy_and_holes_long_range(name, jax_blocks):
    ly, lx, chi, tps, cfgs = _route_setup()
    trunc = JTrunc(chi, 1, 1e-12, scheme="sketch")
    jm = j_energy.ModelTensors.from_model(_model(name, j_spin), jnp.float64)
    ref = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes(
        jnp.asarray(tps), c, jm, chi, trunc)))(jnp.asarray(cfgs))
    mt = energy.ModelTensors.from_model(_model(name, spin), torch.float64,
                                        "cpu")
    out = energy.local_energy_and_holes(
        t(tps), t(cfgs), mt, chi, TruncParams(chi, 1, 1e-12, scheme="sketch"))
    assert rel(out.e_loc, ref.e_loc) < RTOL
    assert rel(out.o_tensor, ref.o_tensor) < RTOL
    assert rel(out.log_abs_psi, ref.log_abs_psi) < RTOL


def test_vertical_bonds_route_differs_at_truncation(jax_blocks):
    """The case above is a route check: at chi = 3 the transposed-frame
    vertical energy and the two-row one differ by far more than 1e-10."""
    _, _, chi, tps, cfgs = _route_setup()
    tps, cfgs = t(tps), t(cfgs).long()
    hv = t(spin.heisenberg_bond())
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    e_t, *_ = energy._local_energy(
        tps, cfgs, energy.ModelTensors(None, hv, None, None, None), chi,
        trunc)
    tn = energy.project(tps, cfgs)
    e_pair = energy._pair_pass(tps, tn, cfgs, hv, None, None,
                               tb.all_env_stacks(tn, chi, trunc))
    assert rel(e_pair, e_t) > 1e-7


def test_vmc_sr_step_j1j2_matches_reference(jax_blocks):
    ly, lx, D, chi, nc = 2, 3, 2, 4, 4
    n_samples, n_warm = 2, 1
    tps = random_tps(np.random.default_rng(31), ly, lx, 2, D)
    occ = ((0, 3), (1, 3))
    seed = jax.random.PRNGKey(4)
    ref = j_vmc.vmc_optimize(
        jnp.asarray(tps), _model("j1j2_xxz", j_spin),
        j_vmc.VMCParams(chi, JTrunc(chi, 1, 1e-12, scheme="sketch"),
                        JMC(num_samples=n_samples, num_warmup_sweeps=n_warm,
                            nchains=nc),
                        j_opt.OptimizerParams(
                            1, j_opt.SRParams(JCG(20, 1e-10), diag_shift=1e-2),
                            lr=0.05),
                        occupancy=occ), seed)
    _, k_init, _ = jax.random.split(seed, 3)
    cfg0 = np.array(init_configs_occupancy(k_init, nc, ly, lx, dict(occ)))
    uniforms, _ = jax_vmc_uniforms(seed, nc, ly, lx, n_warm, n_samples)
    out = vmc_optimize(
        t(tps), _model("j1j2_xxz", spin),
        VMCParams(chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
                  MCParams(num_samples=n_samples, num_warmup_sweeps=n_warm,
                           nchains=nc),
                  OptimizerParams(1, SRParams(CGParams(20, 1e-10),
                                              diag_shift=1e-2), lr=0.05),
                  occupancy=occ),
        configs=t(cfg0), sweep_uniforms=lambda: next(uniforms))
    assert abs(out.energies[0] - ref.energies[0]) < RTOL * abs(ref.energies[0])
    assert np.array_equal(out.final_configs.numpy(),
                          np.asarray(ref.final_configs))
    assert rel(out.state, ref.state) < 1e-8
    assert out.records[0].sr_iters == ref.records[0].sr_iters


def test_exact_sum_triangle_j1j2_matches_ed():
    from ed_oracle import energy_of_tps
    ly, lx, chi = 2, 3, 16
    tps = random_tps(np.random.default_rng(5), ly, lx, 2, 2) * 0.7
    e_ref = energy_of_tps(tps, _model("triangle_j1j2", j_spin))
    res = exact_sum_energy_gradient(t(tps), all_configs(ly, lx, 2),
                                    _model("triangle_j1j2", spin), chi,
                                    TruncParams(chi, 1, 0.0), with_grad=False)
    assert abs(float(res.energy) - e_ref) < 1e-8 * max(abs(e_ref), 1.0)


@pytest.mark.parametrize("name,frames", [("heisenberg", 2), ("j1j2_xxz", 1),
                                         ("triangle_j1j2", 2), ("tnn", 2),
                                         ("s5a", 1)])
def test_measure_builds_the_transposed_frame_only_when_read(name, frames,
                                                            monkeypatch):
    """measure's sample step builds the transposed frame's env stacks only
    where the energy reads them (only_v, h_s5b, h_tnn_v) or a walker does;
    the energies equal the local energy's."""
    from peps_tpu_torch.algorithm.measure import (MeasurementParams,
                                                  _sample_outputs)
    from peps_tpu_torch.lattice import transpose_tps
    rng = np.random.default_rng(2)
    tps = t(random_tps(rng, 3, 3, 2, 2))
    cfgs = t(neel_like_configs(rng, 2, 3, 3)).long()
    model = spin.heisenberg() if name == "heisenberg" else _model(name, spin)
    mt = energy.ModelTensors.from_model(model, torch.float64, "cpu")
    trunc = TruncParams(4, 1, 1e-12, scheme="sketch")
    calls = []
    build = tb.all_env_stacks
    monkeypatch.setattr(tb, "all_env_stacks",
                        lambda *a: calls.append(1) or build(*a))
    outs, _ = _sample_outputs(tps, transpose_tps(tps), cfgs, mt, 4, trunc,
                              [], MeasurementParams(nchains=2))
    assert len(calls) == frames
    e, *_ = energy._local_energy(tps, cfgs, mt, 4, trunc)
    assert rel(outs["energy"], e) < RTOL
