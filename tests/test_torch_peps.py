"""Parity of the port's linear algebra, TPS container and OBC simple update
(peps_tpu_torch.linalg, .tps, .peps, .convert) with the JAX package, in
float64.

Simple update goes through QR and SVD, whose gauges (signs, degenerate
subspaces) differ between the two LAPACK call paths, so it is compared on
gauge-free quantities: the bond singular values lam_* and the normalized
amplitudes of every configuration, at 1e-8 relative (a few SVD round-offs
amplified through the steps); deterministic pieces at 1e-10.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import linalg as j_linalg
from peps_tpu import peps as j_peps
from peps_tpu import tps as j_tps
from peps_tpu.lattice import transpose_tps as j_transpose
from peps_tpu.models import spin as j_spin
from peps_tpu_torch import convert, linalg, peps, tps
from peps_tpu_torch.lattice import boundary_mask, transpose_tps
from peps_tpu_torch.models import spin
from test_torch_bmps import rel


def test_models_spin_copy_matches_reference():
    np.testing.assert_array_equal(spin.heisenberg(0.7).h_h,
                                  j_spin.heisenberg(0.7).h_h)
    np.testing.assert_array_equal(spin.xxz(0.5, 1.5).h_v,
                                  j_spin.xxz(0.5, 1.5).h_v)


@pytest.mark.parametrize("shape,d_max,terr", [((6, 4), 3, 1e-12),
                                              ((5, 9), 7, 1e-2),
                                              ((8, 8), 2, 1e-12)])
def test_truncated_svd_and_mask(shape, d_max, terr):
    rng = np.random.default_rng(shape[0])
    m = rng.standard_normal(shape)
    p = linalg.TruncParams(d_max, 1, terr)
    u, s, vh, err = linalg.truncated_svd(torch.as_tensor(m), p)
    ju, js, jvh, jerr = j_linalg.truncated_svd(jnp.asarray(m),
                                               j_linalg.TruncParams(d_max, 1,
                                                                    terr))
    assert rel(s, js) < 1e-12
    assert abs(float(err) - float(jerr)) < 1e-12
    # the truncated product is gauge-free
    assert rel((u * s) @ vh, (ju * js) @ jvh) < 1e-10


def test_lq_blq_safe_inverse_expm():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((3, 4, 7))
    m[:, :, 5:] = 0
    for fn in (linalg.lq, linalg.blq):
        l, q = fn(torch.as_tensor(m))
        assert rel(l @ q, m) < 1e-12
    l, q = linalg.lq(torch.as_tensor(m[0]))
    jl, jq = j_linalg.lq(jnp.asarray(m[0]))
    assert rel(l @ q, jl @ jq) < 1e-12
    for fn, jfn in ((linalg.qr_safe, j_linalg.qr_safe),
                    (linalg.qr, j_linalg.qr)):
        q, r = fn(torch.as_tensor(m[1].T))
        jq, jr = jfn(jnp.asarray(m[1].T))
        assert rel(q @ r, m[1].T) < 1e-12 and rel(q @ r, jq @ jr) < 1e-12
    x = np.array([1.0, 1e-12, 0.3, 0.0])
    assert rel(linalg.safe_inverse(torch.as_tensor(x)),
               j_linalg.safe_inverse(jnp.asarray(x))) == 0.0
    h = rng.standard_normal((4, 4)) * 0.1
    assert rel(linalg.expm_taylor(torch.as_tensor(h)),
               j_linalg.expm_taylor(jnp.asarray(h))) < 1e-13


def test_project_transpose_and_io(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3, 2) + (2,) * 4) * boundary_mask(2, 3, 2, 2)
    cfg = rng.integers(0, 2, (4, 2, 3))
    ta = convert.tps_from_numpy(a, "cpu")
    out = tps.project(ta, torch.as_tensor(cfg))
    for n in range(4):
        assert rel(out[n], j_tps.project(jnp.asarray(a),
                                         jnp.asarray(cfg[n]))) == 0.0
    assert rel(transpose_tps(ta), j_transpose(jnp.asarray(a))) == 0.0
    # files interoperate both ways
    meta = j_tps.TPSMeta(2, 3, 2, 2)
    j_tps.save_tps(str(tmp_path / "j"), jnp.asarray(a), meta)
    back, m2 = tps.load_tps(str(tmp_path / "j"), device="cpu")
    assert rel(back, a) == 0.0 and m2.lx == 3
    tps.save_tps(str(tmp_path / "t"), ta, tps.TPSMeta(2, 3, 2, 2))
    back2, _ = j_tps.load_tps(str(tmp_path / "t"))
    assert rel(back2, a) == 0.0
    assert abs(float(tps.exact_amplitude(a, cfg[0]))
               - float(j_tps.exact_amplitude(a, cfg[0]))) < 1e-13


def _all_amplitudes(a):
    ly, lx = a.shape[:2]
    out = []
    for idx in range(2 ** (ly * lx)):
        cfg = np.array([(idx >> k) & 1 for k in range(ly * lx)]).reshape(ly, lx)
        out.append(float(tps.exact_amplitude(a, cfg)))
    v = np.array(out)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("ly,lx,D", [(2, 3, 2), (3, 2, 3)])
def test_simple_update_matches_reference(ly, lx, D):
    """From a seeded random PEPS (not the degenerate product state)."""
    rng = np.random.default_rng(ly * 7 + D)
    d = 2
    g = rng.standard_normal((ly, lx, d) + (D,) * 4) * boundary_mask(ly, lx, d, D)
    lam_v = np.abs(rng.standard_normal((ly + 1, lx, D))) + 0.1
    lam_h = np.abs(rng.standard_normal((ly, lx + 1, D))) + 0.1
    lam_v[0] = lam_v[ly] = 0.0
    lam_v[0, :, 0] = lam_v[ly, :, 0] = 1.0
    lam_h[:, 0] = lam_h[:, lx] = 0.0
    lam_h[:, 0, 0] = lam_h[:, lx, 0] = 1.0
    model = spin.heisenberg()
    steps = 4
    ref = j_peps.simple_update(
        j_peps.PEPS(jnp.asarray(g), jnp.asarray(lam_v), jnp.asarray(lam_h)),
        model.h_h, model.h_v,
        j_peps.SimpleUpdateParams(steps, 0.1, j_linalg.TruncParams(D, 1, 1e-12)))
    out = peps.simple_update(
        convert.peps_from_numpy(g, lam_v, lam_h, "cpu"), model.h_h, model.h_v,
        peps.SimpleUpdateParams(steps, 0.1, linalg.TruncParams(D, 1, 1e-12)))
    assert rel(out.peps.lam_v, ref.peps.lam_v) < 1e-8
    assert rel(out.peps.lam_h, ref.peps.lam_h) < 1e-8
    np.testing.assert_allclose(out.energy_history, ref.energy_history,
                               rtol=1e-8)
    amp = _all_amplitudes(convert.to_numpy(peps.to_tps(out.peps)))
    jamp = _all_amplitudes(np.asarray(j_peps.to_tps(ref.peps)))
    assert rel(amp, jamp) < 1e-8


def test_product_peps_and_to_tps():
    occ = np.indices((2, 3)).sum(0) % 2
    p = peps.product_peps(2, 3, 3, occ, 2, dtype=torch.float64, device="cpu")
    jp = j_peps.product_peps(2, 3, 3, jnp.asarray(occ), 2, dtype=jnp.float64)
    for a, b in zip(p, jp):
        assert rel(a, b) == 0.0
    assert rel(peps.to_tps(p), j_peps.to_tps(jp)) == 0.0


def test_wavefunction_sum_amplitudes():
    """ca|a> + cb|b> amplitude by amplitude, against the reference's TPS
    (1e-12 relative; both are exact constructions)."""
    rng = np.random.default_rng(3)
    ly, lx, d = 2, 3, 2
    a = rng.standard_normal((ly, lx, d) + (2,) * 4) * boundary_mask(ly, lx,
                                                                     d, 2)
    b = rng.standard_normal((ly, lx, d) + (3,) * 4) * boundary_mask(ly, lx,
                                                                     d, 3)
    out = tps.wavefunction_sum(torch.as_tensor(a), torch.as_tensor(b),
                               0.7, -1.3)
    ref = j_tps.wavefunction_sum(jnp.asarray(a), jnp.asarray(b), 0.7, -1.3)
    assert out.shape == (ly, lx, d) + (5,) * 4
    assert rel(out, ref) < 1e-12
    for idx in range(2 ** (ly * lx)):
        cfg = np.array([(idx >> k) & 1 for k in range(ly * lx)]).reshape(ly,
                                                                          lx)
        want = 0.7 * tps.exact_amplitude(a, cfg) \
            - 1.3 * tps.exact_amplitude(b, cfg)
        got = tps.exact_amplitude(out.numpy(), cfg)
        assert abs(got - want) < 1e-12 * max(1.0, abs(want))


def test_expand_bond_dim_and_random_tps():
    """Padding keeps every amplitude; the noise lands on the new slots
    only, off the boundary legs; random_tps masks the padding."""
    gen = torch.Generator().manual_seed(0)
    a = tps.random_tps(gen, 2, 3, 2, 2, dtype=torch.float64, device="cpu")
    mask = boundary_mask(2, 3, 2, 2)
    assert a.shape == (2, 3, 2) + (2,) * 4
    assert bool((a.numpy()[mask == 0] == 0).all())
    assert float(a.abs().sum()) > 0
    padded = tps.expand_bond_dim(a, 4)
    ref = j_tps.expand_bond_dim(jnp.asarray(a.numpy()), 4)
    assert rel(padded, ref) == 0.0
    noisy = tps.expand_bond_dim(a, 4, 0.1, torch.Generator().manual_seed(1))
    diff = (noisy - padded).numpy()
    assert bool((diff[:, :, :, :2, :2, :2, :2] == 0).all())
    assert bool((diff[boundary_mask(2, 3, 2, 4) == 0] == 0).all())
    assert np.abs(diff).max() > 0
    assert rel(_all_amplitudes(padded.numpy()), _all_amplitudes(a.numpy())) \
        < 1e-12
    with pytest.raises(ValueError):
        tps.expand_bond_dim(a, 3, 0.1)
    c = tps.random_tps(torch.Generator().manual_seed(0), 2, 2, 2, 2,
                       dtype=torch.complex128, device="cpu")
    assert c.dtype == torch.complex128 and float(c.imag.abs().sum()) > 0
