"""Parity of the port's remaining boundary-MPS pieces
(peps_tpu_torch.contraction.bmps) with the JAX package, in float64: the
var2, var1 and fast compression schemes, row_trace,
replace_one_site_traces and entanglement_entropy.

The fast scheme gets the reference's test matrices (rebuilt from its fixed
key, ``fold_in(PRNGKey(1234), k)``), so both compute the same map. A
compression is compared through what it represents, which is gauge-free:
the dense state of the compressed MPS times exp(log_norm), and the
amplitudes of random networks contracted with the scheme. Tolerance 1e-10
relative (1e-8 for var1, whose QR-moved centre carries SVD round-off
through the sweeps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.contraction import bmps as jb
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.linalg import TruncParams
from test_torch_bmps import random_tn, rel, t

RTOL = {"var2": 1e-10, "var1": 1e-8, "fast": 1e-10, "fast_power": 1e-10}


def jax_fast_blocks(lx, m, chi, dtype, device=None):
    """The reference's test matrices of compress_fast (bmps.py:585-617)."""
    key = jax.random.PRNGKey(1234)
    omega = jnp.stack([jax.random.normal(jax.random.fold_in(key, k), (m, chi),
                                         jnp.float64)
                       for k in range(lx - 1)])
    return tb.FastBlocks(t(omega).to(dtype=dtype, device=device))


@pytest.fixture
def jax_fast(monkeypatch):
    monkeypatch.setattr(tb, "fast_blocks", jax_fast_blocks)


def _params(name, chi):
    scheme = "fast" if name.startswith("fast") else name
    power = 1 if name == "fast_power" else 0
    return (JTrunc(chi, 1, 1e-12, scheme=scheme, rsvd_power=power),
            TruncParams(chi, 1, 1e-12, scheme=scheme, rsvd_power=power))


def _dense(mps, log_norm):
    """The state of an index-0-closed MPS [Lx, chi, D, chi] over its
    vertical legs, times exp(log_norm)."""
    mps = np.asarray(mps)
    v = mps[0, 0]                                   # [D, chi]
    for x in range(1, mps.shape[0]):
        v = np.einsum("...a,avb->...vb", v, mps[x])
    return v[..., 0] * np.exp(float(log_norm))


def _grown(rng, lx, chi, D):
    """A boundary MPS times a row: the input of every scheme."""
    b = rng.standard_normal((lx, chi, D, chi))
    b[0, 1:] = 0
    b[lx - 1, :, :, 1:] = 0
    return np.asarray(jb.multiply_mpo(jnp.asarray(b),
                                      jnp.asarray(random_tn(rng, 1, lx,
                                                            D)[0])))


@pytest.mark.parametrize("name", ["var2", "var1", "fast", "fast_power"])
def test_compress_scheme_state_matches_reference(name):
    rng = np.random.default_rng(len(name))
    lx, chi, D = 4, 3, 2
    mps = _grown(rng, lx, chi, D)
    jt, pt = _params(name, chi)
    if name.startswith("fast"):
        ref = jb.compress_fast(jnp.asarray(mps), chi, jt,
                               power_iters=jt.rsvd_power)
        out = tb.compress_fast(t(mps), chi, pt, power_iters=pt.rsvd_power,
                               blocks=jax_fast_blocks(lx, chi * D, chi,
                                                      torch.float64))
    else:
        ref = jb.compress_variational(jnp.asarray(mps), chi, jt,
                                      two_site=name == "var2")
        out = tb.compress_variational(t(mps), chi, pt,
                                      two_site=name == "var2")
    assert out.bmps.shape == ref.bmps.shape
    assert rel(_dense(out.bmps, out.log_norm),
               _dense(ref.bmps, ref.log_norm)) < RTOL[name]
    assert abs(float(out.trunc_err) - float(ref.trunc_err)) < 1e-12
    # batched over a leading axis: each MPS gets its own result
    two = np.stack([mps, _grown(rng, lx, chi, D)])
    if name.startswith("fast"):
        out2 = tb.compress_fast(t(two), chi, pt, power_iters=pt.rsvd_power,
                                blocks=jax_fast_blocks(lx, chi * D, chi,
                                                       torch.float64))
    else:
        out2 = tb.compress_variational(t(two), chi, pt,
                                       two_site=name == "var2")
    assert rel(_dense(out2.bmps[0], out2.log_norm[0]),
               _dense(out.bmps, out.log_norm)) < 1e-12


@pytest.mark.parametrize("name", ["var2", "var1", "fast", "fast_power"])
def test_amplitudes_with_scheme_match_reference(name, jax_fast):
    """Amplitudes of 3x4 networks (a batch of two) contracted row by row
    with the scheme, where chi = 3 truncates."""
    rng = np.random.default_rng(7 + len(name))
    ly, lx, D, chi = 3, 4, 2, 3
    tns = random_tn(rng, ly, lx, D, (2,))
    jt, pt = _params(name, chi)
    amp = jax.jit(jax.vmap(lambda x: jb.amplitude(x, chi, jt)))
    jm, jl = amp(jnp.asarray(tns))
    m, lw = tb.amplitude(t(tns), chi, pt)
    assert rel(m.numpy() * np.exp(lw.numpy()),
               np.asarray(jm) * np.exp(np.asarray(jl))) < RTOL[name]


def test_absorb_row_takes_every_reference_scheme():
    """Every scheme the reference's TruncParams accepts runs; with chi
    large enough to be exact they all give the exact amplitude."""
    from peps_tpu_torch.tps import exact_contract
    rng = np.random.default_rng(3)
    tn = random_tn(rng, 2, 3, 2)
    exact = exact_contract(tn)
    for scheme in ("svd", "var2", "var1", "fast", "sketch"):
        m, lw = tb.amplitude(t(tn), 4, TruncParams(4, 1, 0.0, scheme=scheme))
        assert abs(float(m) * np.exp(float(lw)) - exact) < 1e-9 * abs(exact)
    with pytest.raises(ValueError, match="scheme"):
        tb.absorb_row(t(np.zeros((3, 4, 2, 4))), t(tn[0]), 4,
                      TruncParams(4, scheme="qdwh"))


def test_fast_blocks_fixed_and_shared():
    a = tb.fast_blocks(4, 6, 3, torch.float64, torch.device("cpu"))
    b = tb.fast_blocks(4, 6, 3, torch.float64, torch.device("cpu"))
    assert a.omega.shape == (3, 6, 3) and a is b
    c = tb.fast_blocks(4, 6, 3, torch.float32, torch.device("cpu"))
    assert torch.equal(c.omega, a.omega.float())


def test_row_trace_and_one_site_traces():
    rng = np.random.default_rng(4)
    lx, chi, D, d = 4, 3, 2, 2
    row = random_tn(rng, 1, lx, D)[0]
    top = rng.standard_normal((lx, chi, D, chi))
    bot = rng.standard_normal((lx, chi, D, chi))
    cands = rng.standard_normal((lx, d) + (D,) * 4)
    j_envs = jb.row_envs(top, bot, row)
    envs = tb.row_envs(t(top), t(bot), t(row))
    for x in range(lx + 1):
        assert rel(tb.row_trace(envs, x), jb.row_trace(j_envs, x)) < 1e-10
    ref = jb.replace_one_site_traces(j_envs, top, bot, cands)
    out = tb.replace_one_site_traces(envs, t(top), t(bot), t(cands))
    assert out.shape == (lx, d) and rel(out, ref) < 1e-10


@pytest.mark.parametrize("x", [1, 2, 3])
def test_entanglement_entropy_matches_reference(x):
    rng = np.random.default_rng(x)
    lx, chi, D = 4, 4, 2
    mps = rng.standard_normal((lx, chi, D, chi))
    mps[0, 1:] = 0
    mps[lx - 1, :, :, 1:] = 0
    ref = float(jb.entanglement_entropy(jnp.asarray(mps), x))
    out = tb.entanglement_entropy(t(mps), x)
    assert out.dtype == torch.float64 and abs(float(out) - ref) < 1e-10
    # batched, and float32 takes its eigenvalues in complex128 too
    both = tb.entanglement_entropy(t(np.stack([mps, mps])), x)
    assert both.shape == (2,) and abs(float(both[1]) - ref) < 1e-10
    f32 = tb.entanglement_entropy(t(mps).float(), x)
    assert f32.dtype == torch.float64 and abs(float(f32) - ref) < 1e-5


def test_fast_scheme_float32_rank_deficient_gram_is_finite():
    """A known fault of the reference: its float32 Cholesky-LQ
    (bmps.py:526) fails on a rank-deficient Gram, whose round-off exceeds
    the 1e-5 jitter, and the fast compression turns NaN (seen on the card
    at the main path's boundary). The port forms the Grams, factors and
    solves in float64: finite, L Q = M to float32 round-off (1e-5)."""
    rng = np.random.default_rng(0)
    mat = (rng.standard_normal((256, 1)) @ rng.standard_normal((1, 2048))) \
        .astype(np.float32)
    l, q = tb._chol_lq(t(mat), 1e-5)
    assert l.dtype == torch.float32 and bool(torch.isfinite(l).all())
    assert rel(l @ q, mat) < 1e-5
    jl, _ = jb._chol_lq(jnp.asarray(mat), 1e-5)
    assert not np.isfinite(np.asarray(jl)).all()        # the reference's NaN
    # the subspace step of a matrix with fewer rows than chi (a rank
    # deficient 16 x 16 Gram): finite, and it captures the range exactly
    omega = torch.randn(2048, 16, generator=torch.Generator().manual_seed(0))
    q0, carry = tb._subspace_project(t(mat[:8]), omega, 1e-5)
    assert bool(torch.isfinite(q0).all()) and rel(q0 @ carry, mat[:8]) < 1e-5
