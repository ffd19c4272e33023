"""Parity of the port's three-site cluster simple update
(peps_tpu_torch.peps_cluster) with the JAX package, in float64.

QR and SVD gauges (signs, degenerate subspaces) differ between the two
LAPACK call paths, so the comparisons are on gauge-free quantities: the
bond spectra lam_*, the per-step history, the cluster tensor contracted
over its two internal bonds, and every normalized amplitude of the
contracted TPS. Inputs are seeded random Gamma/Lambda states (the product
state's degenerate spectra would leave the kept subspace undetermined).
Tolerance 1e-8 relative for the updates (SVD round-off carried through a
step), 1e-12 for the gate tables.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import linalg as j_linalg
from peps_tpu import peps as j_peps
from peps_tpu import peps_cluster as j_cluster
from peps_tpu.models import spin as j_spin
from peps_tpu_torch import convert, linalg, peps, peps_cluster
from peps_tpu_torch.lattice import boundary_mask
from peps_tpu_torch.models import spin
from test_torch_bmps import rel
from test_torch_peps import _all_amplitudes

RTOL = 1e-8


def random_peps(rng, ly, lx, d, D):
    g = rng.standard_normal((ly, lx, d) + (D,) * 4) \
        * boundary_mask(ly, lx, d, D)
    lam_v = np.abs(rng.standard_normal((ly + 1, lx, D))) + 0.1
    lam_h = np.abs(rng.standard_normal((ly, lx + 1, D))) + 0.1
    lam_v[0] = lam_v[ly] = 0.0
    lam_v[0, :, 0] = lam_v[ly, :, 0] = 1.0
    lam_h[:, 0] = lam_h[:, lx] = 0.0
    lam_h[:, 0, 0] = lam_h[:, lx, 0] = 1.0
    return g, lam_v, lam_h


def _cluster_tensor(ga, gb, gc, lab, lbc):
    """The cluster contracted over its internal bonds (A.r = B.l weighted
    by lab, B.d = C.u weighted by lbc): gauge-free."""
    return np.einsum("npuldk,nk,nqtkwf,nw,nswxyz->npuldqtfsxyz",
                     *(np.asarray(a) for a in (ga, lab, gb, lbc, gc)))


def test_apply_cluster_batch_gauge_free():
    rng = np.random.default_rng(0)
    n, d, D = 3, 2, 2
    gs = [rng.standard_normal((n, d) + (D,) * 4) for _ in range(3)]
    lams = [np.abs(rng.standard_normal((n, D))) + 0.2 for _ in range(10)]
    h = rng.standard_normal((n, d ** 3, d ** 3))
    h = (h + h.transpose(0, 2, 1)) * 0.1
    gate = np.stack([np.asarray(j_linalg.expm_taylor(jnp.asarray(-m)))
                     for m in h]).reshape((n,) + (d,) * 6)
    trunc = (j_linalg.TruncParams(D, 1, 1e-12), linalg.TruncParams(D, 1, 1e-12))
    ref = j_cluster._apply_cluster_batch(*(jnp.asarray(a) for a in gs + lams),
                                         jnp.asarray(gate), trunc[0])
    out = peps_cluster._apply_cluster_batch(
        *(torch.as_tensor(a) for a in gs + lams), torch.as_tensor(gate),
        trunc[1])
    for i in (3, 4):                                   # the new spectra
        assert rel(out[i], ref[i]) < RTOL
    assert abs(float(out[5]) - float(ref[5])) < 1e-10
    assert float(ref[5]) > 1e-6                        # it truncated
    assert rel(_cluster_tensor(*out[:5]), _cluster_tensor(*ref[:5])) < RTOL


@pytest.mark.parametrize("sites", [(0, 1), (1, 2), (0, 2)])
def test_pair_to_cluster_gate(sites):
    h = np.random.default_rng(1).standard_normal((2, 2, 2, 2))
    ref = j_cluster._pair_to_cluster_gate(h, sites, 2, np.float64)
    assert rel(peps_cluster._pair_to_cluster_gate(h, sites, 2), ref) < 1e-12


def _models(kind):
    if kind == "nnn":
        return j_spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4), spin.j1j2_xxz(
            1.0, 0.8, 0.5, 0.4)
    return (j_spin.triangle_j1j2_heisenberg(1.0, 0.5),
            spin.triangle_j1j2_heisenberg(1.0, 0.5))


@pytest.mark.parametrize("kind,ly,lx", [("nnn", 2, 3), ("nnn", 3, 3),
                                        ("triangle", 2, 3),
                                        ("triangle", 3, 3)])
def test_cluster_simple_update_matches_reference(kind, ly, lx):
    """One step of simple_update_nnn (J1-J2, both diagonals) or
    simple_update_triangle (triangular J1-J2, with the anti-diagonal pass)
    from a random state: spectra, history, the observer's records and
    every amplitude."""
    D, steps = 2, 1
    g, lam_v, lam_h = random_peps(np.random.default_rng(ly * 10 + lx), ly, lx,
                                  2, D)
    j_model, model = _models(kind)
    j_fn = j_cluster.simple_update_nnn if kind == "nnn" \
        else j_cluster.simple_update_triangle
    fn = peps_cluster.simple_update_nnn if kind == "nnn" \
        else peps_cluster.simple_update_triangle
    seen, j_seen = [], []
    ref = j_fn(j_peps.PEPS(jnp.asarray(g), jnp.asarray(lam_v),
                           jnp.asarray(lam_h)), j_model,
               j_peps.SimpleUpdateParams(steps, 0.1,
                                         j_linalg.TruncParams(D, 1, 1e-12)),
               step_observer=lambda **kw: j_seen.append(kw))
    out = fn(convert.peps_from_numpy(g, lam_v, lam_h, "cpu"), model,
             peps.SimpleUpdateParams(steps, 0.1,
                                     linalg.TruncParams(D, 1, 1e-12)),
             step_observer=lambda **kw: seen.append(kw))
    assert rel(out.peps.lam_v, ref.peps.lam_v) < RTOL
    assert rel(out.peps.lam_h, ref.peps.lam_h) < RTOL
    np.testing.assert_allclose(out.energy_history, ref.energy_history,
                               rtol=RTOL)
    assert len(seen) == steps and seen[0].keys() == j_seen[0].keys()
    assert abs(seen[0]["trunc_err"] - j_seen[0]["trunc_err"]) < 1e-10
    if kind == "nnn":
        assert abs(out.estimated_e0 - ref.estimated_e0) \
            < RTOL * abs(ref.estimated_e0)
        assert abs(out.estimated_en - ref.estimated_en) \
            < RTOL * abs(ref.estimated_en)
    amp = _all_amplitudes(convert.to_numpy(peps.to_tps(out.peps)))
    jamp = _all_amplitudes(np.asarray(j_peps.to_tps(ref.peps)))
    assert rel(amp, jamp) < RTOL


def test_flip_horizontal_matches_reference():
    g, lam_v, lam_h = random_peps(np.random.default_rng(2), 2, 3, 2, 2)
    ref = j_cluster.flip_horizontal(j_peps.PEPS(jnp.asarray(g),
                                                jnp.asarray(lam_v),
                                                jnp.asarray(lam_h)))
    out = peps_cluster.flip_horizontal(convert.peps_from_numpy(g, lam_v, lam_h,
                                                               "cpu"))
    for a, b in zip(out, ref):
        assert rel(a, b) == 0.0
