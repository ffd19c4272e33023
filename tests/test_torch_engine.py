"""The Monte Carlo engine, the configuration files and the small lattice and
TPS helpers against the JAX package, in float64.

The port's engine takes the uniforms the reference's engine draws (its key
splits replayed: per sweep split(key, nc + 1), chains from [1:]), so the
configurations must agree exactly, and so must the acceptance rates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import lattice as j_lattice
from peps_tpu import tps as j_tps
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.montecarlo import engine as j_engine
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu_torch import lattice, tps
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo import engine
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from test_torch_bmps import jax_sketch_blocks
from test_torch_eval_chunk import one_thread, replayed_uniforms  # noqa: F401
from test_torch_sweep import neel_like_configs, random_tps

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("rule", ["exchange", "suwa_todo"])
def test_engine_warm_up_and_step_sweep_match_reference(rule, monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    ly, lx, D, chi, nc = 3, 3, 2, 4, 4
    rng = np.random.default_rng(8)
    a = random_tps(rng, ly, lx, 2, D)
    cfgs = neel_like_configs(rng, nc, ly, lx)
    key = jax.random.PRNGKey(5)
    ref = j_engine.MonteCarloEngine(
        jnp.asarray(a), chi, JTrunc(chi, 1, 1e-12, scheme="sketch"),
        JRule(rule), j_engine.ChainState(jnp.asarray(cfgs), key))
    uni = iter(replayed_uniforms(key, nc, ly, lx, 3))
    eng = engine.MonteCarloEngine(
        torch.as_tensor(a), chi, TruncParams(chi, 1, 1e-12, scheme="sketch"),
        UpdateRule(rule), engine.ChainState(torch.as_tensor(cfgs).long()),
        uniform_source=lambda: next(uni))
    assert eng.warm_up(2) == ref.warm_up(2)
    assert np.array_equal(eng.state.configs.numpy(),
                          np.asarray(ref.state.configs))
    st, j_st = eng.step_sweep(), ref.step_sweep()
    assert (int(st.accepted), int(st.trials)) == \
        (int(j_st.accepted), int(j_st.trials))
    assert np.array_equal(eng.state.configs.numpy(),
                          np.asarray(ref.state.configs))


def test_engine_draws_from_its_generator():
    """Without a uniform source the sweeps draw from state.generator: two
    engines seeded alike walk alike."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(random_tps(rng, 2, 3, 2, 2))
    cfgs = torch.as_tensor(neel_like_configs(rng, 3, 2, 3)).long()
    out = []
    for _ in range(2):
        eng = engine.MonteCarloEngine(
            a, 4, TruncParams(4, 1, 1e-12), UpdateRule(),
            engine.ChainState(cfgs, torch.Generator().manual_seed(9)))
        rate = eng.warm_up(3)
        out.append((rate, eng.state.configs))
    assert out[0][0] == out[1][0] and 0.0 <= out[0][0] <= 1.0
    assert torch.equal(out[0][1], out[1][1])


def test_config_files_cross_load(tmp_path):
    cfgs = np.random.default_rng(2).integers(0, 3, (4, 2, 3))
    engine.save_configs(str(tmp_path / "port" / "cfg"),
                        torch.as_tensor(cfgs))
    loaded = j_engine.load_configs(str(tmp_path / "port" / "cfg.npy"))
    assert np.array_equal(np.asarray(loaded), cfgs)
    assert np.load(tmp_path / "port" / "cfg.npy").dtype == np.int32
    j_engine.save_configs(str(tmp_path / "ref.npy"),
                          jnp.asarray(cfgs, jnp.int32))
    back = engine.load_configs(str(tmp_path / "ref"), device="cpu")
    assert back.dtype == torch.int64 and back.device.type == "cpu"
    assert np.array_equal(back.numpy(), cfgs)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_inner_product_and_norm_square(dtype):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3, 2, 2, 2, 2, 2))
    b = rng.standard_normal(a.shape)
    if dtype == "complex128":
        a = a + 1j * rng.standard_normal(a.shape)
        b = b - 2j * rng.standard_normal(a.shape)
    got = tps.inner_product(torch.as_tensor(a), torch.as_tensor(b)).item()
    want = complex(j_tps.inner_product(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) < 1e-12 * abs(want)
    n = tps.norm_square(torch.as_tensor(a))
    assert not n.is_complex()
    assert abs(float(n) - float(j_tps.norm_square(jnp.asarray(a)))) \
        < 1e-12 * float(n)


def test_bonds_and_transpose_lattice():
    for ly, lx in ((2, 3), (4, 2)):
        assert lattice.nn_bonds_h(ly, lx) == j_lattice.nn_bonds_h(ly, lx)
        assert lattice.nn_bonds_v(ly, lx) == j_lattice.nn_bonds_v(ly, lx)
    tn = np.random.default_rng(4).standard_normal((5, 2, 3, 2, 3, 4, 5))
    out = lattice.transpose_lattice(torch.as_tensor(tn))
    assert np.array_equal(out.numpy(),
                          np.asarray(j_lattice.transpose_lattice(
                              jnp.asarray(tn))))
    for fn, jfn in ((lattice.nn_bonds_h, j_lattice.nn_bonds_h),
                    (lattice.nn_bonds_v, j_lattice.nn_bonds_v)):
        for ly, lx in ((2, 3), (3, 3)):
            assert fn(ly, lx, lattice.BoundaryCondition.PERIODIC) == \
                jfn(ly, lx, j_lattice.BoundaryCondition.PERIODIC)
