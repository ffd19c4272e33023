"""Parity of the port's torus stack with the JAX package: svd_safe and its
backward, the coarse-graining contractor (both projector schemes), the
holes by autograd, the torus local energy, the evaluator's PBC pass, the
PBC exact sum (also against exact diagonalization) and the unfused sketch
compression.

Inputs are made with numpy from a seed and handed to both packages; the
fast scheme gets the reference's Gaussian test matrices (its fixed key's
draws). Tolerances: 1e-10 relative in float64 where chi reaches the bond
rank, 1e-8 on truncating states (the Gram factors square the condition
number), 1e-12 for the SVD backward fed the same factors, 1e-6 against ED
(the limit tests/test_pbc.py uses); float32 within 1e-4 relative (the
float32 round-off through the Grams' factorizations).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import linalg as jlinalg
from peps_tpu.algorithm import exact_sum as j_exs
from peps_tpu.algorithm import mc_evaluator as j_mce
from peps_tpu.algorithm.energy import ModelTensors as JModelTensors
from peps_tpu.algorithm.energy_pbc import local_energy_and_holes_pbc as j_le
from peps_tpu.contraction import bmps as jb
from peps_tpu.contraction import pbc as jp
from peps_tpu.lattice import BoundaryCondition as JBC
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as jspin
from peps_tpu_torch.algorithm import exact_sum, mc_evaluator
from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.algorithm.energy_pbc import local_energy_and_holes_pbc
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.contraction import pbc
from peps_tpu_torch.lattice import BoundaryCondition
from peps_tpu_torch.linalg import TruncParams, svd_safe, svd_safe_backward
from peps_tpu_torch.models import spin
from peps_tpu_torch.tps import exact_contract_pbc, project
from tests.ed_oracle import build_hamiltonian
from tests.test_torch_bmps import jax_sketch_blocks

PBC = BoundaryCondition.PERIODIC


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def jax_test_matrix(b, k, dtype, device):
    """The reference's fast-scheme test matrix: its fixed key's draw in the
    real dtype (``pbc.py:141``)."""
    real = torch.empty((), dtype=dtype).real.dtype
    jd = jnp.float64 if real == torch.float64 else jnp.float32
    return torch.as_tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(20260817), (b, k), jd)), device=device)


def tps_of(seed, ly, lx, d, D, scale=0.5):
    return np.random.default_rng(seed).normal(
        size=(ly, lx, d, D, D, D, D)) * scale


# ------------------------------------------------------------ svd_safe


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("shape", [(5, 5), (6, 4), (4, 6), (3, 5, 4)])
def test_svd_safe_backward_matches_reference(dtype, shape):
    """The same factors and cotangents through both backward formulas
    (the reference's in its JAX convention), rectangular off-range terms
    included."""
    rng = np.random.default_rng(1)

    def r(*sh):
        x = rng.normal(size=sh)
        return x + 1j * rng.normal(size=sh) if dtype == "complex128" else x

    mats = r(*shape).reshape(-1, *shape[-2:])
    for mat in mats:
        u, s, vh = np.linalg.svd(mat, full_matrices=False)
        du, ds, dvh = r(*u.shape), rng.normal(size=s.shape), r(*vh.shape)
        (want,) = jlinalg._svd_safe_bwd(
            ((jnp.asarray(u), jnp.asarray(s), jnp.asarray(vh)), mat.shape),
            (jnp.asarray(du), jnp.asarray(ds), jnp.asarray(dvh)))
        got = svd_safe_backward(*(torch.as_tensor(x) for x in
                                  (u, s, vh, du, ds, dvh)))
        assert rel(got.numpy(), want) < 1e-12
    # batched factors at once
    u, s, vh = np.linalg.svd(mats, full_matrices=False)
    du, ds, dvh = r(*u.shape), rng.normal(size=s.shape), r(*vh.shape)
    got = svd_safe_backward(*(torch.as_tensor(x) for x in
                              (u, s, vh, du, ds, dvh)))
    for i in range(mats.shape[0]):
        (want,) = jlinalg._svd_safe_bwd(
            ((jnp.asarray(u[i]), jnp.asarray(s[i]), jnp.asarray(vh[i])),
             mats[i].shape), (jnp.asarray(du[i]), jnp.asarray(ds[i]),
                              jnp.asarray(dvh[i])))
        assert rel(got[i].numpy(), want) < 1e-12


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_svd_safe_autograd_against_jax_grad(dtype):
    """Autograd through svd_safe gives jax.grad's gradient for a real
    matrix and its conjugate for a complex one (PyTorch's gradient of a
    real loss is the conjugate of JAX's)."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 4))
    if dtype == "complex128":
        a = a + 1j * rng.normal(size=(5, 4))

    def jf(m):
        u, s, vh = jlinalg.svd_safe(m)
        return jnp.sum(s ** 3) + jnp.sum(jnp.abs((u * s[None, :]) @ vh) ** 2)

    want = np.asarray(jax.grad(jf)(jnp.asarray(a)))
    at = torch.tensor(a, requires_grad=True)
    u, s, vh = svd_safe(at)
    loss = (s ** 3).sum() + ((u * s[None, :].to(u.dtype)) @ vh).abs().pow(2) \
        .sum()
    (got,) = torch.autograd.grad(loss, at)
    assert rel(got.resolve_conj().numpy(), np.conj(want)) < 1e-12


def test_svd_safe_degenerate_holes_finite():
    """Repeated and zero singular values: the regularised backward stays
    finite, where the plain SVD gradient divides by zero; it equals the
    reference's."""
    mat = np.diag([2.0, 2.0, 1.0, 0.0, 0.0])

    def jf(m):
        u, s, vh = jlinalg.svd_safe(m)
        return jnp.sum(u) + jnp.sum(s) + jnp.sum(vh)

    want = np.asarray(jax.grad(jf)(jnp.asarray(mat)))
    at = torch.tensor(mat, requires_grad=True)
    u, s, vh = svd_safe(at)
    (got,) = torch.autograd.grad(u.sum() + s.sum() + vh.sum(), at)
    assert torch.isfinite(got).all() and np.isfinite(want).all()
    assert rel(got.numpy(), want) < 1e-10
    z = torch.zeros(4, 4, dtype=torch.float64, requires_grad=True)
    u, s, vh = svd_safe(z)
    (gz,) = torch.autograd.grad(u.sum() + s.sum() + vh.sum(), z)
    assert torch.isfinite(gz).all()


# ------------------------------------------------------------ contractor


CONTRACT_CASES = [(2, 2, 8), (4, 2, 16), (3, 2, 16), (6, 2, 8), (4, 3, 16)]


@pytest.mark.parametrize("scheme", ["svd", "fast"])
@pytest.mark.parametrize("n,D,chi", CONTRACT_CASES)
def test_contract_pbc_matches_reference(n, D, chi, scheme):
    """psi = mantissa exp(log_weight) of a random torus network against
    the reference (1e-10 where chi reaches every bond's rank, 1e-8 where it
    truncates: 6x6 and 4x4 at D=3) and against the exact torus
    contraction up to 4x4."""
    tn = np.random.default_rng(n * 10 + D).normal(size=(n, n) + (D,) * 4) \
        * 0.5
    jt = JTrunc(chi, 1, 0.0, scheme=scheme, rsvd_power=1)
    jm, jl = jp.contract_pbc(jnp.asarray(tn), chi, jt)
    m, lw = pbc.contract_pbc(torch.as_tensor(tn), chi,
                             TruncParams(chi, 1, 0.0, scheme=scheme,
                                         rsvd_power=1),
                             test_matrix=jax_test_matrix)
    want = float(jm) * np.exp(float(jl))
    got = float(m) * np.exp(float(lw))
    truncating = n == 6 or D == 3
    assert abs(got - want) < (1e-8 if truncating else 1e-10) * abs(want)
    if n <= 4 and not truncating:
        ex = exact_contract_pbc(tn)
        assert abs(got - ex) < 1e-10 * abs(ex)


def test_contract_pbc_batches_and_float32():
    """A batch of networks in one call equals each alone; float32 within
    1e-4 of the reference's float32 and of float64."""
    rng = np.random.default_rng(5)
    tn = rng.normal(size=(3, 4, 4, 2, 2, 2, 2)) * 0.5
    tp = TruncParams(8, 1, 0.0, scheme="fast", rsvd_power=1)
    m, lw = pbc.contract_pbc(torch.as_tensor(tn), 8, tp,
                             test_matrix=jax_test_matrix)
    for i in range(3):
        mi, li = pbc.contract_pbc(torch.as_tensor(tn[i]), 8, tp,
                                  test_matrix=jax_test_matrix)
        assert abs(float(m[i]) * np.exp(float(lw[i]))
                   - float(mi) * np.exp(float(li))) \
            < 1e-12 * abs(float(mi) * np.exp(float(li)))
    t32 = tn[0].astype(np.float32)
    jm, jl = jp.contract_pbc(jnp.asarray(t32), 8,
                             JTrunc(8, 1, 0.0, scheme="fast", rsvd_power=1))
    m32, l32 = pbc.contract_pbc(torch.as_tensor(t32), 8, tp,
                                test_matrix=jax_test_matrix)
    assert m32.dtype == torch.float32
    v32 = float(m32) * np.exp(float(l32))
    assert abs(v32 - float(jm) * np.exp(float(jl))) < 1e-4 * abs(v32)
    v64 = float(m[0]) * np.exp(float(lw[0]))
    assert abs(v32 - v64) < 1e-4 * abs(v64)


def test_contract_pbc_complex_and_sizes():
    """A complex network contracts (the forward pass takes any dtype) to
    the exact torus value; a side that is not 2^k or 3*2^k is refused, and
    so are complex holes (the reference's are jax.grad of a real
    mantissa)."""
    rng = np.random.default_rng(6)
    tn = (rng.normal(size=(2, 4, 2, 2, 2, 2))
          + 1j * rng.normal(size=(2, 4, 2, 2, 2, 2))) * 0.5
    m, lw = pbc.contract_pbc(torch.as_tensor(tn), 16, TruncParams(16, 1, 0.0))
    ex = exact_contract_pbc(tn)
    assert abs(complex(m) * np.exp(float(lw)) - ex) < 1e-10 * abs(ex)
    with pytest.raises(ValueError, match="2\\^k or 3\\*2\\^k"):
        pbc.contract_pbc(torch.zeros(5, 5, 2, 2, 2, 2), 4, TruncParams(4))
    with pytest.raises(TypeError, match="real"):
        pbc.punch_all_holes_pbc(torch.as_tensor(tn), 16, TruncParams(16))


@pytest.mark.parametrize("n,D,chi,scheme", [(4, 2, 16, "svd"),
                                            (4, 2, 16, "fast"),
                                            (3, 2, 16, "svd"),
                                            (4, 3, 16, "fast")])
def test_punch_all_holes_pbc_matches_jax_grad(n, D, chi, scheme):
    """Every hole d(mantissa)/dT against jax.grad through the reference's
    contraction, within 1e-8 relative (4x4 D=3 chi=16 truncates)."""
    tn = np.random.default_rng(7 + n + D).normal(size=(n, n) + (D,) * 4) \
        * 0.5
    jt = JTrunc(chi, 1, 0.0, scheme=scheme, rsvd_power=1)
    jg, jm, _ = jp.punch_all_holes_pbc(jnp.asarray(tn), chi, jt)
    h, m, _ = pbc.punch_all_holes_pbc(
        torch.as_tensor(tn)[None], chi,
        TruncParams(chi, 1, 0.0, scheme=scheme, rsvd_power=1),
        test_matrix=jax_test_matrix)
    assert rel(h[0].numpy(), np.asarray(jg)) < 1e-8
    assert abs(float(m[0]) - float(jm)) < 1e-10 * abs(float(jm))
    assert torch.isfinite(h).all()


# ------------------------------------------------------------ energies

ENERGY_CASES = {
    "heisenberg_4x4": (4, 4, 2, 8, "fast", "heisenberg", (1.0,)),
    "heisenberg_4x4_svd": (4, 4, 2, 8, "svd", "heisenberg", (1.0,)),
    "tfim_2x2": (2, 2, 2, 8, "fast", "transverse_field_ising", (1.0, 3.0)),
    "j1j2_2x2": (2, 2, 2, 8, "svd", "j1j2_xxz", (1.0, 1.0, 0.5, 0.5)),
    "triangle_2x4": (2, 4, 2, 8, "fast", "triangle_j1j2_heisenberg",
                     (1.0, 0.5)),
}


@pytest.mark.parametrize("case", list(ENERGY_CASES))
def test_local_energy_and_holes_pbc_matches_reference(case):
    """E_loc, O, log|psi| and the mantissa of 3 configurations (h_h, h_v,
    h_d, h_ad and the one-site field) against the reference's, one
    configuration at a time there, the batch here; 1e-10 relative."""
    ly, lx, D, chi, scheme, name, args = ENERGY_CASES[case]
    tps = tps_of(11, ly, lx, 2, D)
    cfg = np.random.default_rng(12).integers(0, 2, size=(3, ly, lx))
    jm = JModelTensors.from_model(getattr(jspin, name)(*args), jnp.float64)
    jt = JTrunc(chi, 1, 0.0, scheme=scheme, rsvd_power=1)
    want = [j_le(jnp.asarray(tps), jnp.asarray(c), jm, chi, jt) for c in cfg]
    got = local_energy_and_holes_pbc(
        torch.as_tensor(tps), torch.as_tensor(cfg),
        ModelTensors.from_model(getattr(spin, name)(*args), torch.float64,
                                "cpu"),
        chi, TruncParams(chi, 1, 0.0, scheme=scheme, rsvd_power=1),
        test_matrix=jax_test_matrix)
    assert rel(got.e_loc.numpy(), [float(w.e_loc) for w in want]) < 1e-10
    assert rel(got.o_tensor.numpy(),
               np.stack([np.asarray(w.o_tensor) for w in want])) < 1e-10
    assert rel(got.log_abs_psi.numpy(),
               [float(w.log_abs_psi) for w in want]) < 1e-10
    no_holes = local_energy_and_holes_pbc(
        torch.as_tensor(tps), torch.as_tensor(cfg),
        ModelTensors.from_model(getattr(spin, name)(*args), torch.float64,
                                "cpu"),
        chi, TruncParams(chi, 1, 0.0, scheme=scheme, rsvd_power=1),
        with_holes=False, test_matrix=jax_test_matrix)
    assert no_holes.o_tensor is None
    assert rel(no_holes.e_loc.numpy(), got.e_loc.numpy()) < 1e-12


def test_local_energy_pbc_float32():
    """Float32 E_loc of the 4x4 Heisenberg torus within 1e-4 relative of
    the reference's float32 and of the port's float64."""
    tps = tps_of(13, 4, 4, 2, 2)
    cfg = np.random.default_rng(14).integers(0, 2, size=(2, 4, 4))
    jt = JTrunc(8, 1, 0.0, scheme="fast", rsvd_power=1)
    tp = TruncParams(8, 1, 0.0, scheme="fast", rsvd_power=1)
    jm = JModelTensors.from_model(jspin.heisenberg(1.0), jnp.float32)
    want = [float(j_le(jnp.asarray(tps, jnp.float32), jnp.asarray(c), jm, 8,
                       jt).e_loc) for c in cfg]
    model = spin.heisenberg(1.0)
    e32 = local_energy_and_holes_pbc(
        torch.as_tensor(tps, dtype=torch.float32), torch.as_tensor(cfg),
        ModelTensors.from_model(model, torch.float32, "cpu"), 8, tp,
        test_matrix=jax_test_matrix).e_loc
    e64 = local_energy_and_holes_pbc(
        torch.as_tensor(tps), torch.as_tensor(cfg),
        ModelTensors.from_model(model, torch.float64, "cpu"), 8, tp,
        test_matrix=jax_test_matrix).e_loc
    assert e32.dtype == torch.float32
    assert rel(e32.numpy(), want) < 1e-4
    assert rel(e32.double().numpy(), e64.numpy()) < 1e-4


def test_local_energy_pbc_float32_at_card_nan_configuration():
    """The 4x4 D=3 torus state an H100 built (chip_smoke phase 12, float32)
    and a configuration whose float32 E_loc (chi=12, the fast scheme with
    one power iteration and trunc_err 1e-6) came out NaN on that card
    (tests/data/pbc_eloc_nan.pt): the reference's float32 E_loc there is
    finite, and the port's on the CPU, float32 and float64, within 1e-4
    relative of it."""
    fx = torch.load(Path(__file__).parent / "data" / "pbc_eloc_nan.pt")
    tps, cfg = fx["tps"], fx["config"][None]
    chi = 12
    jm = JModelTensors.from_model(jspin.heisenberg(1.0), jnp.float32)
    want = float(j_le(jnp.asarray(tps.numpy()), jnp.asarray(cfg[0].numpy()),
                      jm, chi, JTrunc(chi, 1, 1e-6, scheme="fast",
                                      rsvd_power=1)).e_loc)
    assert np.isfinite(want)
    tp = TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1)
    model = spin.heisenberg(1.0)
    for dt in (torch.float32, torch.float64):
        got = local_energy_and_holes_pbc(
            tps.to(dt), cfg, ModelTensors.from_model(model, dt, "cpu"), chi,
            tp, with_holes=False, test_matrix=jax_test_matrix).e_loc
        assert abs(float(got[0]) - want) < 1e-4 * abs(want)


def test_local_energy_pbc_leaves_out_unreached_non_finite_entries(
        monkeypatch):
    """A replaced pair whose contraction is NaN (mantissa and log-weight)
    where h[c1, c2, p, q] = 0 (here the Sz-violating (0, 0) of every bond
    of a Neel configuration of the Heisenberg torus) leaves E_loc as it
    was within 1e-12 relative (the bond's scale then comes from its other
    entries); a NaN where h reaches (the exchange (1, 0)) makes it NaN."""
    from peps_tpu_torch.algorithm import energy_pbc
    tps = torch.as_tensor(tps_of(15, 2, 2, 2, 2))
    cfg = torch.tensor([[[0, 1], [1, 0]]])
    mt = ModelTensors.from_model(spin.heisenberg(1.0), torch.float64, "cpu")
    tp = TruncParams(8, 1, 0.0, scheme="fast", rsvd_power=1)
    want = energy_pbc.pbc_energy_and_holes(tps, cfg, mt, 8, tp,
                                           with_holes=False)[0]
    contract = energy_pbc.contract_pbc

    def poisoned(p, q):
        def f(net, *args, **kwargs):
            mant, logw = contract(net, *args, **kwargs)
            if net.dim() == 10:       # the bond tables' [nc, Nb, d, d, ...]
                mant, logw = mant.clone(), logw.clone()
                mant[:, :, p, q] = logw[:, :, p, q] = float("nan")
            return mant, logw
        return f

    monkeypatch.setattr(energy_pbc, "contract_pbc", poisoned(0, 0))
    got = energy_pbc.pbc_energy_and_holes(tps, cfg, mt, 8, tp,
                                          with_holes=False)[0]
    assert torch.isfinite(got).all()
    assert rel(got.numpy(), want.numpy()) < 1e-12
    monkeypatch.setattr(energy_pbc, "contract_pbc", poisoned(1, 0))
    got = energy_pbc.pbc_energy_and_holes(tps, cfg, mt, 8, tp,
                                          with_holes=False)[0]
    assert torch.isnan(got).all()


@pytest.mark.parametrize("with_sr", [True, False])
def test_pbc_eval_batch_matches_reference_and_chunks(with_sr):
    """The evaluator's PBC pass (one sample step of _mc_collect on the
    torus, full-recompute sweep): the reference's per-sample tuple
    (its _pbc_eval_batch) of the configurations after the step's sweep,
    and the same values with eval_chunk 2 as with all chains at once."""
    from peps_tpu_torch.algorithm.energy import o_tensor_of
    tps = tps_of(15, 2, 2, 2, 2)
    cfg = np.random.default_rng(16).integers(0, 2, size=(5, 2, 2))
    u = torch.rand(5, 8, generator=torch.Generator().manual_seed(17),
                   dtype=torch.float64)
    tp = TruncParams(8, 1, 0.0)
    model = ModelTensors.from_model(spin.heisenberg(1.0), torch.float64,
                                    "cpu")
    jm = JModelTensors.from_model(jspin.heisenberg(1.0), jnp.float64)

    def step(chunk, with_grad=True):
        return mc_evaluator._mc_collect(
            torch.as_tensor(tps), torch.as_tensor(cfg), model, 8, tp, 1,
            with_sr, lambda: u, with_grad=with_grad, eval_chunk=chunk,
            bc=PBC, trial_sweep=False)

    for chunk in (None, 2):
        cfgs, _, _, outs = step(chunk)
        want = j_mce._pbc_eval_batch(jnp.asarray(tps),
                                     jnp.asarray(cfgs.numpy()), jm, 8,
                                     JTrunc(8, 1, 0.0), True, None, with_sr)
        assert rel(outs["e_locs"][0].numpy(), np.asarray(want[0])) < 1e-10
        assert rel(outs["log_psi"][0].numpy(), np.asarray(want[4])) < 1e-10
        if with_sr:
            o = o_tensor_of(outs["holes"][0].reshape(5, 2, 2, 2, 2, 2, 2),
                            outs["psi_loc"][0], outs["cfgs"][0], 2)
            assert rel(o.reshape(5, -1).numpy(), np.asarray(want[1])) < 1e-10
            assert want[3] is None
        else:
            assert rel(outs["o_sum"].numpy(), np.asarray(want[2])) < 1e-10
            assert rel(outs["eo_sum"].numpy(), np.asarray(want[3])) < 1e-10
            assert want[1] is None
    cfgs, _, _, outs = step(2, with_grad=False)
    assert set(outs) == {"e_locs", "log_psi"}
    assert rel(outs["e_locs"][0].numpy(), np.asarray(want[0])) < 1e-10


# ------------------------------------------------------------ exact sums


def wavefunction_pbc(tps):
    ly, lx, d = tps.shape[:3]
    psi = []
    for cfg in exact_sum.all_configs(ly, lx, d):
        psi.append(exact_contract_pbc(tps[np.arange(ly)[:, None],
                                          np.arange(lx)[None, :], cfg]))
    return np.array(psi)


def ed_energy_pbc(tps, model):
    psi = wavefunction_pbc(tps)
    h = build_hamiltonian(model, tps.shape[0], tps.shape[1], periodic=True)
    return float(np.real(np.vdot(psi, h @ psi) / np.vdot(psi, psi)))


EXACT_MODELS = {"heisenberg": (1.0,), "transverse_field_ising": (1.0, 3.0),
                "j1j2_xxz": (1.0, 1.0, 0.5, 0.5)}


@pytest.mark.parametrize("name", list(EXACT_MODELS))
def test_pbc_exact_sum_matches_reference_and_ed(name):
    """The PBC exact sum of a random 2x2 D=2 torus state at chi=16: the
    energy against ED within 1e-6 (tests/test_pbc.py's limit) and against
    the reference's within 1e-10, the gradient within 1e-8 relative."""
    tps = tps_of(abs(hash(name)) % 1000, 2, 2, 2, 2, scale=0.7)
    args = EXACT_MODELS[name]
    configs = exact_sum.all_configs(2, 2, 2)
    tp = TruncParams(16, 1, 0.0)
    got = exact_sum.exact_sum_energy_gradient(
        torch.as_tensor(tps), configs, getattr(spin, name)(*args), 16, tp,
        bc=PBC)
    want = j_exs.exact_sum_energy_gradient(
        jnp.asarray(tps), jnp.asarray(configs),
        JModelTensors.from_model(getattr(jspin, name)(*args), jnp.float64),
        16, JTrunc(16, 1, 0.0), bc=JBC.PERIODIC)
    e_ed = ed_energy_pbc(tps, getattr(jspin, name)(*args))
    assert abs(float(got.energy) - e_ed) < 1e-6 * max(1.0, abs(e_ed))
    assert abs(float(got.energy) - float(want.energy)) \
        < 1e-10 * abs(float(want.energy))
    assert rel(got.gradient.numpy(), np.asarray(want.gradient)) < 1e-8


def test_pbc_exact_sum_evaluation_matches_reference():
    """The SR buffers of the PBC exact-sum evaluation (TFIM, 2x2, D=2,
    chi=16, in pieces of 5 configurations) against the reference's."""
    tps = tps_of(21, 2, 2, 2, 2, scale=0.5)
    configs = exact_sum.all_configs(2, 2, 2)
    got = exact_sum.exact_sum_evaluation(
        torch.as_tensor(tps), configs, spin.transverse_field_ising(1.0, 3.0),
        16, TruncParams(16, 1, 0.0), with_sr_buffers=True, batch_size=5,
        bc=PBC)
    want = j_exs.exact_sum_evaluation(
        jnp.asarray(tps), jnp.asarray(configs),
        JModelTensors.from_model(jspin.transverse_field_ising(1.0, 3.0),
                                 jnp.float64),
        16, JTrunc(16, 1, 0.0), with_sr_buffers=True, bc=JBC.PERIODIC)
    assert abs(float(got.energy) - float(want.energy)) \
        < 1e-10 * abs(float(want.energy))
    for name in ("gradient", "o_samples", "e_samples"):
        assert rel(getattr(got, name).numpy(),
                   np.asarray(getattr(want, name))) < 1e-8, name


def test_pbc_refusals():
    """Fermionic models are refused on the torus (boson-only, as the
    reference's), by the evaluator, the exact sums, vmc_optimize and
    measure(); with a bosonic model vmc_optimize and measure() run on the
    torus (a 2x2 state, one sample of two chains)."""
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.models.fermion import spinless_fermion
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SGDParams
    fm = spinless_fermion(1.0, 0.5)
    with pytest.raises(ValueError, match="boson-only"):
        mc_evaluator.require_bosonic_for_pbc(fm, PBC)
    mc_evaluator.require_bosonic_for_pbc(fm, BoundaryCondition.OPEN)
    tps = torch.as_tensor(tps_of(0, 2, 2, 2, 2))
    cfg = np.array([[[0, 1], [1, 0]]] * 2, np.int32)
    with pytest.raises(ValueError, match="boson-only"):
        exact_sum.exact_sum_energy_gradient(tps, cfg, fm, 8, TruncParams(8),
                                            bc=PBC)
    params = VMCParams(chi=8, trunc=TruncParams(8),
                       mc=MCParams(num_samples=1, num_warmup_sweeps=1,
                                   nchains=2),
                       optimizer=OptimizerParams(1, SGDParams()), bc=PBC)
    mparams = MeasurementParams(num_samples=1, num_warmup_sweeps=1,
                                nchains=2)
    for model in (fm, spin.heisenberg(1.0)):
        run_vmc = lambda: vmc_optimize(tps, model, params,
                                       configs=torch.as_tensor(cfg))
        run_measure = lambda: measure(tps, model, mparams, 8, TruncParams(8),
                                      UpdateRule(), torch.as_tensor(cfg),
                                      bc=PBC)
        if model is fm:
            for run in (run_vmc, run_measure):
                with pytest.raises(ValueError, match="boson-only"):
                    run()
            continue
        out = run_vmc()
        assert len(out.energies) == 1 and np.isfinite(out.energies[0])
        assert torch.equal(out.final_configs.sum((1, 2)),
                           torch.tensor([2, 2]))
        res = run_measure()
        assert set(res.stats) == {"energy", "sz", "szsz"}
        assert np.isfinite(res.stats["energy"][0])


# ------------------------------------------------------------ compress_sketch


def _full_state(mps):
    """Dense state of an MPS [Lx, chi, D, chi] closed at index 0."""
    mps = np.asarray(mps)
    v = mps[0, 0]
    for x in range(1, mps.shape[0]):
        v = np.tensordot(v, mps[x], axes=([-1], [0]))
    return v[..., 0]


def test_compress_sketch_matches_reference_and_fused():
    """The unfused sketch compression of a grown MPS against the
    reference's (its own blocks), and the port's fused absorb against the
    port's multiply_mpo -> compress_sketch (the reference's oracle
    test_absorb_row_sketch_equals_unfused); 1e-9 of the state's scale."""
    rng = np.random.default_rng(23)
    lx, chi_in, du, dl, chi = 4, 5, 3, 3, 6
    boundary = rng.normal(size=(lx, chi_in, du, chi_in))
    boundary[0, 1:] = 0
    boundary[lx - 1, :, :, 1:] = 0
    row = rng.normal(size=(lx, du, dl, du, dl))
    row[0, :, 1:] = 0
    row[lx - 1, :, :, :, 1:] = 0
    tp = TruncParams(chi, 1, 0.0, scheme="sketch")
    blocks = jax_sketch_blocks(lx, du, chi, 8, torch.float64)
    grown = tb.multiply_mpo(torch.as_tensor(boundary), torch.as_tensor(row))
    unfused = tb.compress_sketch(grown, chi, tp, blocks=blocks)
    want = jb.compress_sketch(jb.multiply_mpo(jnp.asarray(boundary),
                                              jnp.asarray(row)), chi,
                              JTrunc(chi, 1, 0.0, scheme="sketch"))
    su = _full_state(unfused.bmps) * np.exp(float(unfused.log_norm))
    sw = _full_state(want.bmps) * np.exp(float(want.log_norm))
    assert np.abs(su - sw).max() < 1e-9 * np.abs(sw).max()
    fused = tb.absorb_row_sketch(torch.as_tensor(boundary),
                                 torch.as_tensor(row), chi, tp, blocks=blocks)
    sf = _full_state(fused.bmps) * np.exp(float(fused.log_norm))
    assert np.abs(sf - su).max() < 1e-9 * np.abs(su).max()
    # a batch (the second grown MPS scaled by 2 in every core) represents
    # the same states; raw cores of a rank-deficient bond move with the
    # summation order, so the states are compared
    batched = tb.compress_sketch(torch.stack([grown, 2 * grown]), chi, tp,
                                 blocks=blocks)
    for i, scale in ((0, 1.0), (1, 2.0 ** lx)):
        sb = _full_state(batched.bmps[i]) * np.exp(float(batched.log_norm[i]))
        assert np.abs(sb - scale * su).max() < 1e-9 * scale * np.abs(su).max()


def test_jittered_cholesky_grows_only_where_it_fails():
    """Where the reference's jitter holds, the factor is the plain jittered
    Cholesky; a Gram whose round-off passes it (an eigenvalue of -1e-10
    under a 1e-12 jitter) gets a finite factor of a larger jitter instead
    of NaN."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(6, 6))
    good = a @ a.T / 6
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    bad = q @ np.diag([1.0, 0.5, 0.0, 0.0, 0.0, -1e-10]) @ q.T
    m = torch.as_tensor(np.stack([good, bad]))
    l = pbc._jittered_cholesky(m, 1e-12)
    plain, info = torch.linalg.cholesky_ex(m + 1e-12 * torch.eye(6))
    assert int(info[0]) == 0 and int(info[1]) > 0
    assert torch.equal(l[0], plain[0])
    assert torch.isfinite(l[1]).all()
    assert (l[1] @ l[1].T - m[1]).abs().max() < 1e-6


def test_fast_scheme_finite_where_reference_is_nan():
    """A 4x4 D=3 torus state 10 SU steps from the Neel state and random
    Sz = 0 configurations: one configuration's bond recompute fails the
    reference's float64 Cholesky (a late-stage Gram's round-off passes the
    1e-12 jitter) and its E_loc is NaN; the port grows the jitter there
    and is finite, and equals the reference within 1e-10 elsewhere."""
    from peps_tpu_torch.montecarlo.engine import init_configs_occupancy
    from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps_pbc,
                                     simple_update, to_tps_pbc)
    L, D, chi = 4, 3, 12
    peps = product_peps_pbc(L, L, D, np.indices((L, L)).sum(0) % 2, 2,
                            dtype=torch.float32, device="cpu")
    m = spin.heisenberg(1.0)
    for steps, tau in ((5, 0.2), (5, 0.05)):
        peps = simple_update(peps, m.h_h, m.h_v, SimpleUpdateParams(
            steps, tau, TruncParams(D, 1, 1e-10), energy_abs_tol=1e-8)).peps
    tps = to_tps_pbc(peps)
    tps = (tps / tps.abs().max()).double()
    cfg = init_configs_occupancy(torch.Generator().manual_seed(12), 4, L, L,
                                 {0: 8, 1: 8}, "cpu")
    jm = JModelTensors.from_model(jspin.heisenberg(1.0), jnp.float64)
    jt = JTrunc(chi, 1, 1e-6, scheme="fast", rsvd_power=1)
    want = np.array([float(j_le(jnp.asarray(tps.numpy()), jnp.asarray(c),
                                jm, chi, jt).e_loc) for c in cfg.numpy()])
    got = local_energy_and_holes_pbc(
        tps, cfg, ModelTensors.from_model(m, torch.float64, "cpu"), chi,
        TruncParams(chi, 1, 1e-6, scheme="fast", rsvd_power=1),
        test_matrix=jax_test_matrix).e_loc.numpy()
    nan = np.isnan(want)
    assert nan.any() and np.isfinite(got).all()
    assert np.abs(got[~nan] - want[~nan]).max() \
        < 1e-10 * np.abs(want[~nan]).max()
