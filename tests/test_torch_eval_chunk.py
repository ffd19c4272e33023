"""MCParams.eval_chunk: the evaluator's local energies and holes over chain
slices, against the unchunked call and against the JAX package's
mc_energy_grad with the same eval_chunk, in float64.

The port and the reference take the same sweep uniforms (the reference's
key splits replayed: per sample step split(key, nc + 1), chains from
[1:], the next key [0]) and the sketch with the reference's blocks.
Energies, gradients and the SR buffers are gauge-free: 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy as j_energy
from peps_tpu.algorithm.mc_evaluator import MCParams as JMC
from peps_tpu.algorithm.mc_evaluator import mc_energy_grad as j_grad
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.algorithm.mc_evaluator import (MCParams, mc_energy_grad,
                                                   mc_energy_only)
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.montecarlo.sweep import UpdateRule
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_sweep import jax_sweep_uniforms, neel_like_configs, random_tps

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-10
MODELS = {"heisenberg": (spin.heisenberg, j_spin.heisenberg, ()),
          "j1j2": (spin.j1j2_xxz, j_spin.j1j2_xxz, (1.0, 1.0, 0.5, 0.5))}


@pytest.fixture
def one_thread():
    """One intra-op torch thread for the port's CPU parity tests. They run
    many small tensor ops (a few hundred elements each); with a thread per
    core beside other busy test workers the threads wait on each other far
    more than they compute: on an 8-core machine under such load the
    exact-sum SR descent of test_torch_complex.py took 800 s with a thread
    per core and 13 s on one. The JAX side keeps its own thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def replayed_uniforms(key, nc, ly, lx, n_sweeps):
    """The uniforms of the reference evaluator's n_sweeps sweeps from key."""
    out = []
    for _ in range(n_sweeps):
        keys = jax.random.split(key, nc + 1)
        key = keys[0]
        out.append(jax_sweep_uniforms(keys[1:], ly, lx))
    return out


def _setup(name, ly=3, lx=3, nc=5, seed=11):
    rng = np.random.default_rng(seed)
    tps = random_tps(rng, ly, lx, 2, 2)
    cfgs = neel_like_configs(rng, nc, ly, lx)
    make, j_make, args = MODELS[name]
    return tps, cfgs, make(*args), j_make(*args)


def _port(tps, cfgs, model, chunk, uniforms, with_sr=True, n_samples=2):
    it = iter(uniforms)
    mt = ModelTensors.from_model(model, torch.float64, "cpu")
    ev, out_cfgs, log_psi = mc_energy_grad(
        torch.as_tensor(tps), torch.as_tensor(cfgs), mt, 4,
        TruncParams(4, 1, 1e-12, scheme="sketch"),
        MCParams(num_samples=n_samples, nchains=cfgs.shape[0],
                 eval_chunk=chunk),
        lambda: next(it), with_sr_buffers=with_sr)
    return ev, out_cfgs, log_psi


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("with_sr", [True, False])
def test_chunked_equals_unchunked(name, with_sr):
    """Chunks of 2 of 5 chains (the last one ragged) against all at once:
    energy, gradient, SR buffers, log|psi| and the configurations."""
    tps, cfgs, model, _ = _setup(name)
    gen = torch.Generator().manual_seed(3)
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    uni = [draw_uniforms(gen, 5, 3, 3, torch.float64, "cpu")
           for _ in range(2)]
    full = _port(tps, cfgs, model, None, uni, with_sr)
    part = _port(tps, cfgs, model, 2, uni, with_sr)
    assert abs(float(part[0].energy - full[0].energy)) \
        < RTOL * abs(float(full[0].energy))
    assert rel(part[0].gradient, full[0].gradient) < RTOL
    if with_sr:
        assert rel(part[0].o_samples, full[0].o_samples) < RTOL
        assert rel(part[0].e_samples, full[0].e_samples) < RTOL
    assert rel(part[2], full[2]) < RTOL
    assert torch.equal(part[1], full[1])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunked_matches_reference(name):
    """eval_chunk = 2 in both packages, SR buffers, replayed uniforms."""
    tps, cfgs, model, j_model = _setup(name)
    nc, ly, lx = cfgs.shape
    key = jax.random.PRNGKey(21)
    jm = j_energy.ModelTensors.from_model(j_model, jnp.float64)
    ref, j_cfgs, _, j_log_psi = j_grad(
        jnp.asarray(tps), jnp.asarray(cfgs), key, jm, 4,
        JTrunc(4, 1, 1e-12, scheme="sketch"), JRule("exchange"),
        JMC(num_samples=2, nchains=nc, eval_chunk=2), with_sr_buffers=True)
    ev, out_cfgs, log_psi = _port(tps, cfgs, model, 2,
                                  replayed_uniforms(key, nc, ly, lx, 2))
    assert np.array_equal(out_cfgs.numpy(), np.asarray(j_cfgs))
    assert abs(float(ev.energy) - float(ref.energy)) \
        < RTOL * abs(float(ref.energy))
    assert rel(ev.gradient, ref.gradient) < RTOL
    assert rel(ev.o_samples, ref.o_samples) < RTOL
    assert rel(ev.e_samples, ref.e_samples) < RTOL
    assert rel(log_psi, j_log_psi) < RTOL


def test_energy_only_takes_eval_chunk():
    tps, cfgs, model, _ = _setup("j1j2")
    mt = ModelTensors.from_model(model, torch.float64, "cpu")
    gen = torch.Generator().manual_seed(4)
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    uni = [draw_uniforms(gen, 5, 3, 3, torch.float64, "cpu")
           for _ in range(2)]
    out = []
    for chunk in (None, 3):
        it = iter(uni)
        out.append(mc_energy_only(torch.as_tensor(tps), torch.as_tensor(cfgs),
                                  mt, 4, TruncParams(4, 1, 1e-12,
                                                     scheme="sketch"),
                                  UpdateRule(), 2, lambda: next(it),
                                  eval_chunk=chunk))
    assert abs(float(out[1][0] - out[0][0])) < RTOL * abs(float(out[0][0]))
    assert MCParams().eval_chunk is None and JMC().eval_chunk is None
