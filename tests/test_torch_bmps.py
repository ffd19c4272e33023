"""Parity of the port's boundary-MPS layer (peps_tpu_torch.contraction.bmps
and kernel K1's plain version) with the JAX package, in float64.

Inputs are made with numpy from a seed and handed to both packages. The
sketch compression gets the reference's own Gaussian blocks (rebuilt from
its fixed key), so both compute the same truncated map. Tolerance: 1e-10
relative to the output's norm for every deterministic piece.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.contraction import bmps as jb
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.kernels.col_transfer import (col_transfer_plain,
                                                 col_transfer_right)
from peps_tpu_torch.lattice import boundary_mask
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import exact_amplitude, project

RTOL = 1e-10


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def t(x):
    return torch.as_tensor(np.array(x))


def jax_sketch_blocks(lx, dv, chi, oversample, dtype, device=None):
    """The reference's Gaussian blocks, rebuilt from its fixed key exactly
    as bmps.absorb_row_sketch draws and scales them."""
    rdt = jnp.float64
    losk = chi + oversample
    kz_last, kz_mid, ky_first, ky_mid = jax.random.split(
        jax.random.PRNGKey(20260816), 4)
    z_last = jax.random.normal(kz_last, (dv, chi), rdt) / jnp.sqrt(float(dv))
    z_mid = jax.random.normal(kz_mid, (max(lx - 2, 0), dv * chi, chi), rdt) \
        / jnp.sqrt(float(dv * chi))
    y_first = jax.random.normal(ky_first, (dv, losk), rdt) / jnp.sqrt(float(dv))
    y_mid = jax.random.normal(ky_mid, (max(lx - 2, 0), dv, losk, losk), rdt) \
        / jnp.sqrt(float(dv * losk))
    return tb.SketchBlocks(*(t(b).to(dtype=dtype, device=device)
                             for b in (z_last, z_mid, y_first, y_mid)))


@pytest.fixture
def jax_blocks(monkeypatch):
    """Route the port's sketch through the reference's blocks."""
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def random_tn(rng, ly, lx, D, batch=()):
    """Projected network with the OBC boundary embedding."""
    tn = rng.standard_normal(batch + (ly, lx) + (D,) * 4)
    tn[..., 0, :, 1:, :, :, :] = 0
    tn[..., :, 0, :, 1:, :, :] = 0
    tn[..., ly - 1, :, :, :, 1:, :] = 0
    tn[..., :, lx - 1, :, :, :, 1:] = 0
    return tn


@pytest.mark.parametrize("chi,D,c", [(4, 2, 4), (5, 3, 7), (9, 2, 17)])
def test_col_transfer_plain_matches_reference(chi, D, c):
    rng = np.random.default_rng(chi * 100 + c)
    env = rng.standard_normal((chi, D, c))
    top = rng.standard_normal((chi, D, chi))
    site = rng.standard_normal((D,) * 4)
    bot = rng.standard_normal((c, D, c))
    out = col_transfer_plain(t(env), t(top), t(site), t(bot))
    assert rel(out, jb._col_transfer_left(env, top, site, bot)) < RTOL
    out_r = col_transfer_right(t(env), t(top), t(site), t(bot),
                               transfer=col_transfer_plain)
    assert rel(out_r, jb._col_transfer_right(env, top, site, bot)) < RTOL


@pytest.mark.parametrize("chi,D,oversample", [(4, 2, 8), (6, 3, 2)])
def test_col_transfer_sketch_step_forms(chi, D, oversample):
    """v_step / w_step of absorb_row_sketch as K1 transfers with the
    Gaussian block in the bot slot (the reference's einsums, bmps.py:813-816
    and 840-842)."""
    rng = np.random.default_rng(7)
    losk = chi + oversample
    b_x = rng.standard_normal((chi, D, chi))
    s_x = rng.standard_normal((D,) * 4)
    v3 = rng.standard_normal((chi, D, chi))
    z = rng.standard_normal((D * chi, chi))
    w3 = rng.standard_normal((chi, D, losk))
    y = rng.standard_normal((D, losk, losk))

    x1 = jnp.einsum("ulvr,bri->ulvbi", s_x, v3)
    t1 = jnp.einsum("aub,ulvbi->alvi", b_x, x1)
    v_ref = t1.reshape(chi * D, D * chi) @ z
    zb = t(z).reshape(D, chi, chi).permute(2, 0, 1)
    v_new = col_transfer_right(t(v3), t(b_x), t(s_x), zb,
                               transfer=col_transfer_plain)
    assert rel(v_new.reshape(chi * D, chi), v_ref) < RTOL

    x1 = jnp.einsum("ulvr,alj->uvraj", s_x, w3)
    t1 = jnp.einsum("aub,uvraj->bvrj", b_x, x1)
    w_ref = jnp.einsum("bvrj,vjJ->brJ", t1, y)
    w_new = col_transfer_plain(t(w3), t(b_x), t(s_x), t(y).permute(1, 0, 2))
    assert rel(w_new, w_ref) < RTOL


def test_col_transfer_broadcast_batch():
    """Batch dims broadcast (stride-0 operands) as in the bond step."""
    rng = np.random.default_rng(3)
    env = rng.standard_normal((5, 1, 4, 2, 4))
    top = rng.standard_normal((5, 1, 4, 2, 4))
    cands = rng.standard_normal((3, 2, 2, 2, 2))
    bot = rng.standard_normal((4, 2, 4))
    out = col_transfer_plain(t(env), t(top), t(cands), t(bot))
    assert out.shape == (5, 3, 4, 2, 4)
    for n in range(5):
        for k in range(3):
            ref = jb._col_transfer_left(env[n, 0], top[n, 0], cands[k], bot)
            assert rel(out[n, k], ref) < RTOL


def mps_dense(mps, log_norm=0.0):
    """The state a boundary MPS [Lx, chi, dv, chi] represents (edge bonds
    closed at index 0) as a dense [dv]*Lx array, times exp(log_norm).
    Gauge-free: the sketch's bond pinv leaves round-off-sized components in
    directions that cancel between neighbouring cores, so raw cores of a
    rank-deficient bond agree only to ~1e-5, the represented state to 1e-10."""
    mps = np.asarray(mps)
    v = mps[0][0]                                   # [dv, chi]
    for x in range(1, mps.shape[0]):
        v = np.tensordot(v, mps[x], axes=([-1], [0]))
    return v[..., 0] * np.exp(float(log_norm))


@pytest.mark.parametrize("lx,D,chi_in,chi", [(3, 2, 3, 4), (4, 3, 4, 5),
                                             (2, 2, 2, 3), (4, 3, 4, 3)])
def test_absorb_row_sketch_matches_reference(lx, D, chi_in, chi):
    rng = np.random.default_rng(lx * 10 + chi)
    bm = rng.standard_normal((lx, chi_in, D, chi_in))
    bm[0, 1:] = 0
    bm[-1, :, :, 1:] = 0
    row = random_tn(rng, 3, lx, D)[1]
    trunc = JTrunc(chi, 1, 1e-10, scheme="sketch")
    ref = jax.jit(jb.absorb_row_sketch, static_argnums=(2, 3))(
        jnp.asarray(bm), jnp.asarray(row), chi, trunc)
    blocks = jax_sketch_blocks(lx, D, chi, 8, torch.float64)
    out = tb.absorb_row_sketch(t(bm), t(row), chi,
                               TruncParams(chi, 1, 1e-10, scheme="sketch"),
                               blocks=blocks)
    assert rel(mps_dense(out.bmps, out.log_norm),
               mps_dense(ref.bmps, ref.log_norm)) < RTOL
    if chi <= D:
        # every bond pinv is full rank: the cores themselves are determined
        assert rel(out.bmps, ref.bmps) < RTOL
        assert abs(float(out.log_norm) - float(ref.log_norm)) < RTOL


@pytest.mark.parametrize("scheme", ["sketch", "svd"])
def test_all_env_stacks_and_amplitude(scheme, jax_blocks):
    """Every top and bottom environment (as the state it represents) and
    the amplitude, against the reference and the brute-force contraction."""
    rng = np.random.default_rng(11)
    ly, lx, D, chi = 3, 3, 2, 8
    tn = random_tn(rng, ly, lx, D)
    jt = JTrunc(chi, 1, 1e-12, scheme=scheme)
    pt = TruncParams(chi, 1, 1e-12, scheme=scheme)
    ref = jax.jit(jb.all_env_stacks, static_argnums=(1, 2))(
        jnp.asarray(tn), chi, jt)
    out = tb.all_env_stacks(t(tn), chi, pt)
    for y in range(ly + 1):
        assert rel(mps_dense(out.tops[y], out.log_tops[y]),
                   mps_dense(ref.tops[y], ref.log_tops[y])) < RTOL
        assert rel(mps_dense(out.bots[y], out.log_bots[y]),
                   mps_dense(ref.bots[y], ref.log_bots[y])) < RTOL
    mant, logw = tb.amplitude(t(tn), chi, pt)
    jm, jl = jax.jit(jb.amplitude, static_argnums=(1, 2))(
        jnp.asarray(tn), chi, jt)
    psi, jpsi = float(mant) * np.exp(float(logw)), float(jm) * np.exp(float(jl))
    assert abs(psi - jpsi) < RTOL * abs(jpsi)
    # chi = 8 covers every bond of a 3x3 D=2 network: no truncation
    exact = exact_amplitude_of_tn(tn)
    assert abs(psi - exact) < 1e-9 * abs(exact)


def exact_amplitude_of_tn(tn):
    from peps_tpu_torch.tps import exact_contract
    return float(exact_contract(tn))


def test_amplitude_batched_vs_exact_amplitude():
    """tps.project + bmps.amplitude over a chain batch vs the brute-force
    tps.exact_amplitude of the JAX package and of the port."""
    from peps_tpu.tps import exact_amplitude as j_exact
    rng = np.random.default_rng(5)
    ly, lx, D, chi = 2, 3, 2, 8
    tps = rng.standard_normal((ly, lx, 2) + (D,) * 4) \
        * boundary_mask(ly, lx, 2, D)
    cfgs = rng.integers(0, 2, size=(4, ly, lx))
    mant, logw = tb.amplitude(project(t(tps), t(cfgs)), chi,
                              TruncParams(chi, 1, 1e-12, scheme="svd"))
    psi = mant.numpy() * np.exp(logw.numpy())
    for n in range(4):
        ex = float(j_exact(tps, cfgs[n]))
        assert abs(float(exact_amplitude(tps, cfgs[n])) - ex) < 1e-12 * abs(ex)
        assert abs(psi[n] - ex) < 1e-9 * abs(ex)


def test_row_envs_holes_and_pair_traces():
    rng = np.random.default_rng(21)
    lx, D, chi, d = 4, 2, 3, 2
    top = rng.standard_normal((lx, chi, D, chi))
    bot = rng.standard_normal((lx, chi, D, chi))
    row = random_tn(rng, 3, lx, D)[1]
    cands = rng.standard_normal((lx, d) + (D,) * 4)
    ref = jb.row_envs(jnp.asarray(top), jnp.asarray(bot), jnp.asarray(row))
    out = tb.row_envs(t(top), t(bot), t(row))
    for name in ("lefts", "rights", "log_lefts", "log_rights"):
        assert rel(getattr(out, name), getattr(ref, name)) < RTOL, name
    holes = tb.punch_holes_row(out, t(top), t(bot))
    assert rel(holes, jb.punch_holes_row(ref, jnp.asarray(top),
                                         jnp.asarray(bot))) < RTOL
    nn = tb.replace_nn_site_traces(out, t(top), t(bot), t(cands[:-1]),
                                   t(cands[1:]))
    nn_ref = jb.replace_nn_site_traces(ref, jnp.asarray(top), jnp.asarray(bot),
                                       jnp.asarray(cands[:-1]),
                                       jnp.asarray(cands[1:]))
    assert rel(nn, nn_ref) < RTOL


def test_row_envs_batched_over_chains_and_rows():
    """The port's leading batch dims equal the reference's vmap."""
    rng = np.random.default_rng(4)
    nb, lx, D, chi = 3, 3, 2, 3
    top = rng.standard_normal((nb, lx, chi, D, chi))
    bot = rng.standard_normal((nb, lx, chi, D, chi))
    row = rng.standard_normal((nb, lx) + (D,) * 4)
    out = tb.row_envs(t(top), t(bot), t(row))
    ref = jax.vmap(jb.row_envs)(jnp.asarray(top), jnp.asarray(bot),
                                jnp.asarray(row))
    assert rel(out.lefts, ref.lefts) < RTOL
    assert rel(out.log_rights, ref.log_rights) < RTOL
