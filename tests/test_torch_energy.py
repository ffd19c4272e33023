"""Parity of the port's local energy, gradient holes and SR sample matrix
(peps_tpu_torch.algorithm.energy, kernel K2's plain version) with the JAX
package, in float64.

E_loc and O = d ln psi / dA are gauge-free ratios of full contractions, so
both compression schemes are compared at 1e-10 relative (the sketch with
the reference's Gaussian blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy as j_energy
from peps_tpu.algorithm.mc_evaluator import _center_scale as j_center_scale
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu_torch import convert
from peps_tpu_torch.algorithm import energy
from peps_tpu_torch.algorithm.mc_evaluator import _center_scale
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.kernels.centered_o import centered_o, centered_o_plain
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_sweep import neel_like_configs, random_tps

RTOL = 1e-10


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def _setup(ly, lx, nc, seed):
    rng = np.random.default_rng(seed)
    tps = random_tps(rng, ly, lx, 2, 2)
    cfgs = neel_like_configs(rng, nc, ly, lx)
    return tps, cfgs


@pytest.mark.parametrize("scheme,ly,lx", [("sketch", 3, 3), ("svd", 3, 3),
                                          ("sketch", 2, 3)])
def test_local_energy_and_holes(scheme, ly, lx, jax_blocks):
    tps, cfgs = _setup(ly, lx, 3, 17)
    chi = 4
    jm = j_energy.ModelTensors.from_model(j_spin.heisenberg(), jnp.float64)
    ref = jax.jit(jax.vmap(
        lambda c: j_energy.local_energy_and_holes(
            jnp.asarray(tps), c, jm, chi,
            JTrunc(chi, 1, 1e-12, scheme=scheme))))(jnp.asarray(cfgs))
    mt = convert.model_tensors_from_numpy(jm, "cpu", torch.float64)
    out = energy.local_energy_and_holes(
        torch.as_tensor(tps), torch.as_tensor(cfgs), mt, chi,
        TruncParams(chi, 1, 1e-12, scheme=scheme))
    assert rel(out.e_loc, ref.e_loc) < RTOL
    assert rel(out.o_tensor, ref.o_tensor) < RTOL
    assert rel(out.log_abs_psi, ref.log_abs_psi) < RTOL


def _jax_center_scale(holes, psi, cfg, d):
    """The reference's O build (energy.py:112-116) + stack + _center_scale."""
    ns = holes.shape[0]
    safe = jnp.where(psi == 0, 1.0, psi)
    sel = jax.nn.one_hot(cfg, d, dtype=holes.dtype)
    o = (holes / safe[..., None])[:, :, None, :] * sel[..., None]
    return j_center_scale(o.reshape(ns, -1), ns)


@pytest.mark.parametrize("ns,sites,k,d", [(6, 4, 16, 2), (5, 9, 81, 3),
                                          (1, 2, 4, 2)])
def test_centered_o_plain_matches_reference(ns, sites, k, d):
    rng = np.random.default_rng(ns + sites)
    holes = rng.standard_normal((ns, sites, k))
    psi = rng.standard_normal((ns, sites))
    psi[0, 0] = 0.0                      # the psi == 0 guard
    cfg = rng.integers(0, d, (ns, sites))
    ref = _jax_center_scale(jnp.asarray(holes), jnp.asarray(psi),
                            jnp.asarray(cfg), d)
    out = centered_o(torch.as_tensor(holes), torch.as_tensor(psi),
                     torch.as_tensor(cfg), d)
    assert out.shape == (ns, sites * d * k)
    assert rel(out, ref) < RTOL


def test_centered_o_from_the_evaluator_path(jax_blocks):
    """K2's plain version on the evaluator's holes equals the reference's
    _row_pass O tensors stacked and centered."""
    ly, lx, nc, chi = 2, 3, 4, 4
    tps, cfgs = _setup(ly, lx, nc, 5)
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    jm = j_energy.ModelTensors.from_model(j_spin.heisenberg(), jnp.float64)
    o = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes(
        jnp.asarray(tps), c, jm, chi, jt).o_tensor))(jnp.asarray(cfgs))
    ref = j_center_scale(o.reshape(nc, -1), nc)
    mt = energy.ModelTensors.from_model(spin.heisenberg(), torch.float64,
                                        "cpu")
    ct = torch.as_tensor(cfgs).long()
    _, rp, _, _ = energy._local_energy(
        torch.as_tensor(tps), ct, mt, chi,
        TruncParams(chi, 1, 1e-12, scheme="sketch"))
    a = _center_scale(rp.holes.reshape(1, nc, ly, lx, -1), rp.psi_loc[None],
                      ct[None], 2)
    assert rel(a, ref) < RTOL
    assert rel(a, centered_o_plain(rp.holes.reshape(nc, ly * lx, -1),
                                   rp.psi_loc.reshape(nc, -1),
                                   ct.reshape(nc, -1), 2)) == 0.0
