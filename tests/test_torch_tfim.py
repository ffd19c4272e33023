"""The transverse-field Ising model and the one-site energy term against the
JAX package, in float64 (and complex128 for the exact sum).

fold_site_into_bonds and the model tensors are host-side numpy: equal to
1e-15. Local energies and holes are ratios of full contractions, gauge-free:
1e-10 relative (the sketch with the reference's Gaussian blocks). The
folded simple update goes through QR and SVD, whose gauges differ between
the two LAPACK paths, so it is compared on spectra, history and every
normalized amplitude at 1e-8 (SVD round-off carried through the steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import linalg as j_linalg
from peps_tpu import peps as j_peps
from peps_tpu.algorithm import energy as j_energy
from peps_tpu.algorithm.exact_sum import (all_configs,
                                          exact_sum_energy_gradient as j_exact)
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu_torch import convert, linalg, peps
from peps_tpu_torch.algorithm import energy
from peps_tpu_torch.algorithm.exact_sum import exact_sum_energy_gradient
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_peps import _all_amplitudes
from test_torch_sweep import random_tps
from test_torch_eval_chunk import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-10


def test_tfim_model_matches_reference():
    for j, h in ((1.0, 1.0), (0.7, 2.5)):
        a, b = spin.transverse_field_ising(j, h), \
            j_spin.transverse_field_ising(j, h)
        assert a.name == b.name == "tfim" and a.phys_dim == b.phys_dim
        for f in ("h_h", "h_v", "h_site"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.h_d is None and a.h_ad is None
    np.testing.assert_array_equal(spin.ising_zz_bond(0.3),
                                  j_spin.ising_zz_bond(0.3))
    np.testing.assert_array_equal(spin.transverse_field_site(0.3),
                                  j_spin.transverse_field_site(0.3))


@pytest.mark.parametrize("ly,lx", [(2, 3), (3, 4)])
def test_fold_site_into_bonds_matches_reference(ly, lx):
    rng = np.random.default_rng(ly * lx)
    hb = rng.standard_normal((2, 2, 2, 2))
    hv = rng.standard_normal((2, 2, 2, 2))
    hs = rng.standard_normal((2, 2))
    out = peps.fold_site_into_bonds(hb, hv, hs, ly, lx)
    ref = j_peps.fold_site_into_bonds(hb, hv, hs, ly, lx)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15, atol=1e-15)
    # the bond sum of the folded terms on any configuration pair equals the
    # bonds plus one h_site per site: sum of diagonal elements on |0...0>
    e_fold = out[0][..., 0, 0, 0, 0].sum() + out[1][..., 0, 0, 0, 0].sum()
    n_h, n_v = ly * (lx - 1), (ly - 1) * lx
    want = n_h * hb[0, 0, 0, 0] + n_v * hv[0, 0, 0, 0] + ly * lx * hs[0, 0]
    assert abs(e_fold - want) < 1e-12


@pytest.mark.parametrize("scheme", ["sketch", "svd"])
def test_tfim_local_energy_and_holes(scheme, monkeypatch):
    """The one-site term's E_loc and the holes on random configurations
    (Sz not conserved), 3x3, D=2, chi=4."""
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    ly, lx, chi, nc = 3, 3, 4, 4
    rng = np.random.default_rng(23)
    tps = random_tps(rng, ly, lx, 2, 2)
    cfgs = rng.integers(0, 2, (nc, ly, lx)).astype(np.int32)
    jm = j_energy.ModelTensors.from_model(
        j_spin.transverse_field_ising(1.0, 2.0), jnp.float64)
    ref = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes(
        jnp.asarray(tps), c, jm, chi,
        JTrunc(chi, 1, 1e-12, scheme=scheme))))(jnp.asarray(cfgs))
    mt = convert.model_tensors_from_numpy(jm, "cpu", torch.float64)
    out = energy.local_energy_and_holes(
        torch.as_tensor(tps), torch.as_tensor(cfgs), mt, chi,
        TruncParams(chi, 1, 1e-12, scheme=scheme))
    assert rel(out.e_loc, ref.e_loc) < RTOL
    assert rel(out.o_tensor, ref.o_tensor) < RTOL
    assert rel(out.log_abs_psi, ref.log_abs_psi) < RTOL


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_tfim_exact_sum_matches_reference(dtype):
    """tests/test_energy_evaluator.py's tfim case (J = 1, h = 2, 2x3; D=2
    here, D=3 there): the exact-sum energy and gradient of the port
    against the reference's on the same state."""
    ly, lx, D, chi = 2, 3, 2, 16
    rng = np.random.default_rng(5)
    a = random_tps(rng, ly, lx, 2, D) * 0.8
    if dtype == "complex128":
        a = a + 0.8j * random_tps(rng, ly, lx, 2, D)
    model = spin.transverse_field_ising(1.0, 2.0)
    jm = j_energy.ModelTensors.from_model(
        j_spin.transverse_field_ising(1.0, 2.0), jnp.dtype(dtype))
    configs = all_configs(ly, lx, 2)
    ref = j_exact(jnp.asarray(a), jnp.asarray(configs), jm, chi,
                  JTrunc(chi, 1, 0.0))
    mt = energy.ModelTensors.from_model(model, getattr(torch, dtype), "cpu")
    out = exact_sum_energy_gradient(torch.as_tensor(a),
                                    torch.as_tensor(configs), mt, chi,
                                    TruncParams(chi, 1, 0.0))
    assert abs(float(out.energy) - float(ref.energy)) \
        < RTOL * abs(float(ref.energy))
    assert rel(out.gradient, ref.gradient) < RTOL


def test_folded_tfim_simple_update_matches_reference():
    """tests/test_simple_update.py's TFIM workflow, cut to 2x3, D=2: the
    folded per-bond arrays through simple_update from the all-up product
    state, with the energy-stall stop."""
    ly, lx, D = 2, 3, 2
    jmodel = j_spin.transverse_field_ising(1.0, 3.0)
    model = spin.transverse_field_ising(1.0, 3.0)
    jh = j_peps.fold_site_into_bonds(jmodel.h_h, jmodel.h_v, jmodel.h_site,
                                     ly, lx)
    hh, hv = peps.fold_site_into_bonds(model.h_h, model.h_v, model.h_site,
                                       ly, lx)
    occ = np.zeros((ly, lx), int)
    kw = dict(steps=12, tau=0.1, energy_abs_tol=1e-10, min_steps=20)
    ref = j_peps.simple_update(
        j_peps.product_peps(ly, lx, D, jnp.asarray(occ), 2,
                            dtype=jnp.float64), *jh,
        j_peps.SimpleUpdateParams(trunc=j_linalg.TruncParams(D, 1, 1e-12),
                                  **kw))
    out = peps.simple_update(
        peps.product_peps(ly, lx, D, occ, 2, dtype=torch.float64,
                          device="cpu"), hh, hv,
        peps.SimpleUpdateParams(trunc=linalg.TruncParams(D, 1, 1e-12), **kw))
    assert (out.executed_steps, out.converged) == \
        (ref.executed_steps, ref.converged)
    np.testing.assert_allclose(out.energy_history, ref.energy_history,
                               rtol=1e-8)
    assert rel(out.peps.lam_v, ref.peps.lam_v) < 1e-8
    assert rel(out.peps.lam_h, ref.peps.lam_h) < 1e-8
    amp = _all_amplitudes(convert.to_numpy(peps.to_tps(out.peps)))
    jamp = _all_amplitudes(np.asarray(j_peps.to_tps(ref.peps)))
    amp = amp * np.sign(amp @ jamp)     # the state's global sign is a gauge
    assert rel(amp, jamp) < 1e-8
