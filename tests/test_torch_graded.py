"""The port's Z2-graded core (peps_tpu_torch.fermion.graded) against the
JAX package on random inputs made with numpy from a seed, float64 and
complex128 within 1e-12 relative: graded transpose and contraction
(including primal-first pairs and several contracted axes), fusion of
primal and dual groups, and the blockwise graded and charged truncated
SVDs, sector QR / LQ and graded QR. Factorizations are compared by what
is free of the factor gauge: singular values, reconstructions, isometry
and sector support. The port's leading batch axes are checked against a
loop over the items."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.fermion import graded as jg
from peps_tpu_torch.fermion import graded as tg
from test_torch_bmps import rel

PA = (0, 0, 1, 1, 1)
PB = (0, 1, 1)
PC = (0, 0, 1, 0)


def _arr(rng, shape, cplx):
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if cplx else a


@pytest.mark.parametrize("cplx", [False, True])
def test_transpose_contract_fuse_match_reference(cplx):
    rng = np.random.default_rng(3 + cplx)
    a = _arr(rng, (5, 3, 4, 3), cplx)
    b = _arr(rng, (4, 3, 5, 3), cplx)
    par_a, par_b = (PA, PB, PC, PB), (PC, PB, PA, PB)
    cases = (((False, True, False, True), (True, False, True, False),
              (2, 1), (0, 3)),
             ((True, False, True, False), (False, True, False, True),
              (0,), (2,)),
             ((False, False, True, True), (False, False, True, True),
              (2, 3), (0, 1)))
    for da, db, axa, axb in cases:
        ja, jb = jg.GT(jnp.asarray(a), par_a, da), jg.GT(jnp.asarray(b),
                                                         par_b, db)
        ta, tb = tg.GT(torch.as_tensor(a), par_a, da), \
            tg.GT(torch.as_tensor(b), par_b, db)
        ref = jg.gcontract(ja, axa, jb, axb)
        out = tg.gcontract(ta, axa, tb, axb)
        assert out.parity == ref.parity and out.dual == ref.dual
        assert rel(out.data, ref.data) < 1e-12
        perm = (2, 0, 3, 1)
        assert rel(tg.gtranspose(ta, perm).data,
                   jg.gtranspose(ja, perm).data) < 1e-12
    for dual in ((False,) * 4, (True,) * 4):
        ja = jg.GT(jnp.asarray(a), par_a, dual)
        ta = tg.GT(torch.as_tensor(a), par_a, dual)
        for n in (2, 3):
            ref, out = jg.fuse(ja, n), tg.fuse(ta, n)
            assert out.parity == ref.parity and out.dual == ref.dual
            assert np.array_equal(out.data.numpy(), np.asarray(ref.data))
    # batched contraction: leading axes broadcast, each item as unbatched
    batch = _arr(rng, (2, 5, 3, 4, 3), cplx)
    tb_ = tg.GT(torch.as_tensor(b), par_b, (True, False, True, False))
    out = tg.gcontract(tg.GT(torch.as_tensor(batch), par_a,
                             (False, True, False, True)), (2, 1), tb_, (0, 3))
    for i in range(2):
        one = tg.gcontract(tg.GT(torch.as_tensor(batch[i]), par_a,
                                 (False, True, False, True)), (2, 1), tb_,
                           (0, 3))
        assert rel(out.data[i], one.data) < 1e-14
    mat = _arr(rng, (4, 4, 3, 3), cplx)
    g = tg.operator_gt(torch.as_tensor(mat), (0, 1, 1, 0), (0, 1, 1, 0),
                       (0, 1, 0), (0, 1, 0))
    jgate = jg.operator_gt(jnp.asarray(mat), (0, 1, 1, 0), (0, 1, 1, 0),
                           (0, 1, 0), (0, 1, 0))
    assert np.array_equal(g.data.numpy(), np.asarray(jgate.data))
    assert np.array_equal(tg.gconj(ta).data.resolve_conj().numpy(),
                          np.asarray(jg.gconj(ja).data))


def _even_matrix(rng, pr, pc, cplx):
    m = _arr(rng, (len(pr), len(pc)), cplx)
    return m * (np.add.outer(pr, pc) % 2 == 0)


@pytest.mark.parametrize("cplx", [False, True])
def test_graded_svd_and_qr_match_reference(cplx):
    rng = np.random.default_rng(7 + cplx)
    pr = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1])
    pc = np.array([1, 0, 0, 1, 1, 0, 1])
    m = _even_matrix(rng, pr, pc, cplx)
    for de, do in ((2, 2), (3, 1)):
        ref = jg.graded_svd_truncated(jnp.asarray(m), pr, pc, de, do)
        out = tg.graded_svd_truncated(torch.as_tensor(m), pr, pc, de, do)
        assert out[4] == ref[4]
        assert rel(out[1], ref[1]) < 1e-12
        assert abs(float(out[3]) - float(ref[3])) < 1e-12
        rec = (out[0] * out[1].to(out[0].dtype)) @ out[2]
        jrec = (np.asarray(ref[0]) * np.asarray(ref[1])) @ np.asarray(ref[2])
        assert rel(rec, jrec) < 1e-12
    q, r, bp = tg.graded_qr(torch.as_tensor(m), pr, pc)
    jq, jr, jbp = jg.graded_qr(jnp.asarray(m), pr, pc)
    assert bp == jbp
    assert rel(q @ r, np.asarray(jq) @ np.asarray(jr)) < 1e-12
    assert rel(q @ r, m) < 1e-12
    # batched: each item as unbatched
    mb = np.stack([m, _even_matrix(rng, pr, pc, cplx)])
    ub, sb, vb, eb, _ = tg.graded_svd_truncated(torch.as_tensor(mb), pr, pc,
                                                2, 2)
    for i in range(2):
        u, s, v, e, _ = tg.graded_svd_truncated(torch.as_tensor(mb[i]), pr,
                                                pc, 2, 2)
        assert rel(sb[i], s) < 1e-13


@pytest.mark.parametrize("cplx", [False, True])
def test_charged_svd_and_sector_qr_match_reference(cplx):
    rng = np.random.default_rng(11 + cplx)
    qr_ = np.array([0, 1, -1, 2, 0, 1, -1, 0])
    qc = np.array([0, -1, 1, 0, 2, 1])
    secs = (0, 1, -1, 2)
    m = _arr(rng, (8, 6), cplx) * (qr_[:, None] == qc[None, :])
    rm = np.stack([(qr_ == s) for s in secs]).astype(np.float64)
    cm = np.stack([(qc == s) for s in secs]).astype(np.float64)
    keep = (1, 1, 1, 1)
    ref = jg.charged_svd_truncated(jnp.asarray(m), jnp.asarray(rm),
                                   jnp.asarray(cm), keep)
    out = tg.charged_svd_truncated(torch.as_tensor(m), rm, cm, keep)
    assert rel(out[1], ref[1]) < 1e-12
    assert abs(float(out[3]) - float(ref[3])) < 1e-12
    rec = (out[0] * out[1].to(out[0].dtype)) @ out[2]
    jrec = (np.asarray(ref[0]) * np.asarray(ref[1])) @ np.asarray(ref[2])
    assert rel(rec, jrec) < 1e-12
    # kept vectors lie on their sector: no weight leaks between charges
    for k, s in enumerate(secs):
        assert float((out[0][:, k].abs() * torch.as_tensor(1 - rm[k])).sum()) \
            == 0.0
    cols = tuple(tuple(np.where(qc == s)[0].tolist()) for s in secs)
    q, r = tg.sector_qr(torch.as_tensor(m), cols, rm)
    jq, jr = jg.sector_qr(jnp.asarray(m), cols, jnp.asarray(rm))
    assert rel(q @ r, np.asarray(jq) @ np.asarray(jr)) < 1e-12
    assert rel(q @ r, m) < 1e-12
    assert rel(r.abs(), np.abs(np.asarray(jr))) < 1e-12
    rows = tuple(tuple(np.where(qr_ == s)[0].tolist()) for s in secs)
    ll, lq = tg.sector_lq(torch.as_tensor(m), rows, cm)
    jl, jlq = jg.sector_lq(jnp.asarray(m), rows, jnp.asarray(cm))
    assert rel(ll @ lq, np.asarray(jl) @ np.asarray(jlq)) < 1e-12
    assert rel(ll @ lq, m) < 1e-12
