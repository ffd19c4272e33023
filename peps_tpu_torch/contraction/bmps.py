"""Boundary-MPS contraction, OBC (port of ``peps_tpu/contraction/bmps.py``).

Layouts as in the JAX package: boundary MPS [Lx, chi, D, chi] (vertical leg
contracts the row's ``u``), projected row [Lx, u, l, d, r], BTens
[chi, D, chi] with axes (top bond, site leg, bottom bond). Every function
here takes extra LEADING batch dimensions (chains, rows) where the JAX
package used ``vmap``; the scans over columns and rows are Python loops.

Edge bonds are embedded at index 0 and every step renormalizes to unit
Frobenius norm with a floor of ``finfo.tiny``, exactly as the reference,
so amplitude ratios formed from shared environments cancel the scales.

Compression schemes (``TruncParams.scheme``): "sketch" (the main path),
"svd", "var2"/"var1" (variational fitting) and "fast" (Cholesky-LQ with
randomized-subspace truncation). The random matrices of "sketch" and
"fast" are arguments (:class:`SketchBlocks`, :class:`FastBlocks`), drawn by
default once from a seeded CPU generator. Grams and triangular solves run
in full precision (the package turns TF32 off).

Every column transfer (the reference's ``_col_transfer_left/_right``) goes
through kernel K1 (:func:`peps_tpu_torch.kernels.col_transfer.col_transfer`
and :func:`~peps_tpu_torch.kernels.col_transfer.col_transfer_right`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.kernels.col_transfer import col_transfer, \
    col_transfer_right
from peps_tpu_torch.linalg import TruncParams, lq, qr_safe, truncated_svd

SKETCH_SEED = 20260816
FAST_SEED = 1234


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.real.dtype if t.is_complex() else t.dtype).tiny


def _normalize(x: torch.Tensor, ndim: int):
    """x / max(||x||, tiny) over the last ndim axes; returns (x', norm)."""
    n = torch.linalg.vector_norm(x, dim=tuple(range(-ndim, 0)))
    n = torch.clamp(n, min=_tiny(x))
    return x / n.reshape(n.shape + (1,) * ndim), n


def _unit_env(chi: int, dv: int, dtype, device, batch=()) -> torch.Tensor:
    t = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=device)
    t[..., 0, 0, 0] = 1.0
    return t


def init_boundary(lx: int, chi: int, d_bond: int, dtype, device=None,
                  batch=()) -> torch.Tensor:
    """Trivial boundary MPS [*batch, Lx, chi, D, chi] (index-0 product)."""
    return _unit_env(chi, d_bond, dtype, resolve_device(device),
                     tuple(batch) + (lx,))


def flip_vertical(tn: torch.Tensor) -> torch.Tensor:
    """Flip a projected network [..., Ly, Lx, u, l, d, r] upside down."""
    return torch.flip(tn, [-6]).transpose(-4, -2)


# ---------------------------------------------------------------------------
# svd scheme (the accuracy oracle): multiply_mpo + compress
# ---------------------------------------------------------------------------

class CompressResult(NamedTuple):
    bmps: torch.Tensor       # [..., Lx, chi, D, chi]
    log_norm: torch.Tensor   # [...]
    trunc_err: torch.Tensor  # [...]


def multiply_mpo(bmps: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Absorb a row without compression: [..., Lx, chi, D, chi] x
    [..., Lx, u, l, d, r] -> [..., Lx, chi*D, D, chi*D], edges re-masked."""
    lx, chi = bmps.shape[-4], bmps.shape[-3]
    dd = row.shape[-1]
    out = torch.einsum("...xaub,...xuldr->...xaldbr", bmps, row)
    out = out.reshape(*out.shape[:-6], lx, chi * dd, row.shape[-2], chi * dd)
    out = out.clone()
    out[..., 0, 1:, :, :] = 0.0
    out[..., lx - 1, :, :, 1:] = 0.0
    return out


def compress(mps: torch.Tensor, chi: int, trunc: TruncParams) -> CompressResult:
    """SVD compression [..., Lx, m, D, m] -> [..., Lx, chi, D, chi]:
    right-to-left LQ canonicalization, then a left-to-right truncated-SVD
    sweep; edges closed at index 0 and rebuilt by embedding."""
    lx, m, dv = mps.shape[-4], mps.shape[-3], mps.shape[-2]
    batch = mps.shape[:-4]
    dtype, dev = mps.dtype, mps.device
    tp = TruncParams(chi, trunc.d_min, trunc.trunc_err)

    l_last, q_last = lq(mps[..., lx - 1, :, :, 0])      # [m, k], [k, D]
    k = l_last.shape[-1]
    if k < m:
        l_last = torch.nn.functional.pad(l_last, (0, m - k))
        q_last = torch.nn.functional.pad(q_last, (0, 0, 0, m - k))
    carry = l_last
    inner = [None] * lx
    for x in range(lx - 2, 0, -1):
        t = torch.einsum("...avb,...bc->...avc", mps[..., x, :, :, :], carry)
        carry, q = lq(t.reshape(*batch, m, dv * m))
        inner[x] = q.reshape(*batch, m, dv, m)
    a0 = torch.einsum("...vb,...bc->...vc", mps[..., 0, 0, :, :], carry)

    u0, s0, vh0, err = truncated_svd(a0, tp)
    outs = [torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)]
    outs[0][..., 0, :, :] = u0
    carry = s0[..., :, None] * vh0
    for x in range(1, lx - 1):
        t = torch.einsum("...cb,...bvd->...cvd", carry, inner[x])
        u, s, vh, e = truncated_svd(t.reshape(*batch, chi * dv, m), tp)
        outs.append(u.reshape(*batch, chi, dv, chi))
        carry = s[..., :, None] * vh
        err = torch.maximum(err, e)
    last = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    last[..., :, :, 0] = torch.einsum("...cb,...bv->...cv", carry, q_last)
    outs.append(last)
    out, norms = _normalize(torch.stack(outs, dim=-4), 3)
    return CompressResult(out, torch.log(norms).sum(-1), err)


# ---------------------------------------------------------------------------
# sketch scheme (the main path)
# ---------------------------------------------------------------------------

class SketchBlocks(NamedTuple):
    """Gaussian mixing blocks of :func:`absorb_row_sketch`, already scaled
    as the reference scales them: z_last [dv, chi] / sqrt(dv);
    z_mid [lx-2, dv*chi, chi] / sqrt(dv*chi); y_first [dv, losk] / sqrt(dv);
    y_mid [lx-2, dv, losk, losk] / sqrt(dv*losk); losk = chi + oversample."""
    z_last: torch.Tensor
    z_mid: torch.Tensor
    y_first: torch.Tensor
    y_mid: torch.Tensor


@functools.lru_cache(maxsize=64)
def sketch_blocks(lx: int, dv: int, chi: int, oversample: int, dtype,
                  device) -> SketchBlocks:
    """The port's fixed blocks: drawn once from a CPU ``torch.Generator``
    seeded with the reference's sketch seed (the bits differ from JAX's),
    in float64, then cast and moved; cached per shape, dtype and device.
    Every call and every chain must share them: ratios formed across calls
    are consistent only under one fixed truncated map."""
    gen = torch.Generator().manual_seed(SKETCH_SEED)
    losk = chi + oversample
    mid = max(lx - 2, 0)

    def draw(shape, fan):
        return torch.randn(shape, generator=gen, dtype=torch.float64) \
            / math.sqrt(fan)

    blocks = (draw((dv, chi), dv), draw((mid, dv * chi, chi), dv * chi),
              draw((dv, losk), dv), draw((mid, dv, losk, losk), dv * losk))
    return SketchBlocks(*(b.to(dtype=dtype, device=device) for b in blocks))


def _sketch_pinv_apply(a, w, eps_rel):
    """pinv(a) @ w^T for a [..., l, chi], w [..., m, l] -> [..., chi, m] via
    eps-regularized normal equations. A failed Cholesky leaves NaNs (as
    JAX's does) instead of raising, so the evaluator counts the sample."""
    chi = a.shape[-1]
    g = a.mH @ a
    diag = torch.diagonal(g, dim1=-2, dim2=-1).real
    scale = torch.clamp(diag.amax(-1), min=_tiny(a))
    eye = torch.eye(chi, dtype=a.dtype, device=a.device)
    l, info = torch.linalg.cholesky_ex(g / scale[..., None, None] + eps_rel * eye)
    l = torch.where((info > 0)[..., None, None],
                    torch.full_like(l, float("nan")), l)
    rhs = (a.mH @ w.mT) / scale[..., None, None].to(a.dtype)
    y = torch.linalg.solve_triangular(l, rhs, upper=False)
    return torch.linalg.solve_triangular(l.mH, y, upper=True)


def compress_sketch(mps: torch.Tensor, chi: int, trunc: TruncParams,
                    oversample: int = 8,
                    blocks: SketchBlocks | None = None) -> CompressResult:
    """Randomized two-sided compression of a grown MPS [..., Lx, m, D, m]
    -> [..., Lx, chi, D, chi] (port of ``bmps.py:688 compress_sketch``):
    the right sketches V and left sketches W from the Gaussian mixing
    blocks (default :func:`sketch_blocks`, the ones
    :func:`absorb_row_sketch` uses), the oblique bond factors
    pinv(W^T V) W^T, the cores assembled and normalised. The unfused form:
    :func:`absorb_row_sketch` is ``multiply_mpo`` followed by this."""
    lx, m, dv = mps.shape[-4], mps.shape[-3], mps.shape[-2]
    batch = mps.shape[:-4]
    dtype, dev = mps.dtype, mps.device
    rdt = mps.real.dtype if mps.is_complex() else dtype
    eps_rel = 1e-12 if torch.finfo(rdt).bits >= 64 else 1e-5
    if blocks is None:
        blocks = sketch_blocks(lx, dv, chi, oversample, dtype, dev)
    z_last, z_mid, y_first, y_mid = blocks

    v, _ = _normalize(mps[..., lx - 1, :, :, 0] @ z_last, 2)    # [m, chi]
    vs = [None] * (lx - 1)
    vs[lx - 2] = v
    for x in range(lx - 2, 0, -1):
        t = torch.einsum("...avc,...ci->...avi", mps[..., x, :, :, :], v)
        v, _ = _normalize(t.reshape(*batch, m, dv * chi) @ z_mid[x - 1], 2)
        vs[x - 1] = v
    v = torch.stack(vs, dim=-3)                            # [lx-1, m, chi]

    w, _ = _normalize(torch.einsum("...vc,vj->...cj", mps[..., 0, 0, :, :],
                                   y_first), 2)                 # [m, losk]
    ws = [w]
    for x in range(1, lx - 1):
        t = torch.einsum("...ai,...avc->...vic", w, mps[..., x, :, :, :])
        w, _ = _normalize(torch.einsum("...vic,vij->...cj", t,
                                       y_mid[x - 1]), 2)
        ws.append(w)
    w = torch.stack(ws, dim=-3)                            # [lx-1, m, losk]

    a = torch.einsum("...bml,...bmc->...blc", w, v)
    g = _sketch_pinv_apply(a, w, eps_rel)                  # [lx-1, chi, m]
    first = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    first[..., 0, :, :] = torch.einsum("...vc,...cj->...vj",
                                       mps[..., 0, 0, :, :], v[..., 0, :, :])
    cores = [first]
    if lx > 2:
        inner = torch.einsum("...xka,...xavc,...xcj->...xkvj",
                             g[..., :lx - 2, :, :],
                             mps[..., 1:lx - 1, :, :, :], v[..., 1:, :, :])
        cores += list(inner.unbind(-4))
    last = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    last[..., :, :, 0] = torch.einsum("...ka,...av->...kv",
                                      g[..., lx - 2, :, :],
                                      mps[..., lx - 1, :, :, 0])
    cores.append(last)
    out, norms = _normalize(torch.stack(cores, dim=-4), 3)
    return CompressResult(out, torch.log(norms).sum(-1),
                          torch.zeros(batch, dtype=rdt, device=dev))


def absorb_row_sketch(bmps: torch.Tensor, row: torch.Tensor, chi: int,
                      trunc: TruncParams, oversample: int = 8,
                      blocks: SketchBlocks | None = None) -> CompressResult:
    """Fused multiply_mpo + randomized two-sided compression that never
    forms the grown MPS. bmps [..., Lx, chi_in, du, chi_in], row
    [..., Lx, u, l, v, r] -> [..., Lx, chi, v, chi].

    blocks: the Gaussian mixing blocks; default :func:`sketch_blocks`. The
    v/w recursions are K1 transfers with the block in the ``bot`` slot."""
    lx, chi_in = bmps.shape[-4], bmps.shape[-3]
    dl, dv = row.shape[-3], row.shape[-2]
    batch = torch.broadcast_shapes(bmps.shape[:-4], row.shape[:-5])
    m = chi_in * dl
    dtype, dev = bmps.dtype, bmps.device
    rdt = bmps.real.dtype if bmps.is_complex() else dtype
    eps_rel = 1e-12 if torch.finfo(rdt).bits >= 64 else 1e-5
    losk = chi + oversample
    if blocks is None:
        blocks = sketch_blocks(lx, dv, chi, oversample, dtype, dev)
    z_last, z_mid, y_first, y_mid = blocks

    # right sketches V_b, stored [chi_in, dl, chi]; edge core closed at (0, 0)
    v, _ = _normalize(torch.einsum(
        "...au,...ulv,vi->...ali", bmps[..., lx - 1, :, :, 0],
        row[..., lx - 1, :, :, :, 0], z_last), 3)
    vs = [None] * (lx - 1)
    vs[lx - 2] = v
    for x in range(lx - 2, 0, -1):
        # bot[j, v, i] = z[(v, i), j]
        zb = z_mid[x - 1].reshape(dv, chi, chi).permute(2, 0, 1)
        v, _ = _normalize(col_transfer_right(
            v, bmps[..., x, :, :, :], row[..., x, :, :, :, :], zb), 3)
        vs[x - 1] = v
    v = torch.stack([t.expand(*batch, *t.shape[-3:]) for t in vs], dim=-4)

    # left sketches W_b, stored [chi_in, dl, losk]; edge core closed at (0, 0)
    w, _ = _normalize(torch.einsum(
        "...ub,...uvr,vj->...brj", bmps[..., 0, 0, :, :],
        row[..., 0, :, 0, :, :], y_first), 3)
    ws = [w]
    for x in range(1, lx - 1):
        # bot[j, v, J] = y[v, j, J]
        yb = y_mid[x - 1].permute(1, 0, 2)
        w, _ = _normalize(col_transfer(
            w, bmps[..., x, :, :, :], row[..., x, :, :, :, :], yb), 3)
        ws.append(w)
    w = torch.stack([t.expand(*batch, *t.shape[-3:]) for t in ws], dim=-4)

    # cross matrices + bond pinv
    a = torch.einsum("...xblj,...xblc->...xjc", w, v)
    g = _sketch_pinv_apply(a, w.reshape(*batch, lx - 1, m, losk), eps_rel)
    g3 = g.reshape(*batch, lx - 1, chi, chi_in, dl)

    # assemble cores
    first = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    first[..., 0, :, :] = torch.einsum(
        "...ub,...uvr,...brj->...vj", bmps[..., 0, 0, :, :],
        row[..., 0, :, 0, :, :], v[..., 0, :, :, :])
    cores = [first]
    if lx > 2:
        q = torch.einsum("...xkal,...xaub->...xklub", g3[..., :lx - 2, :, :, :],
                         bmps[..., 1:lx - 1, :, :, :])
        r = torch.einsum("...xklub,...xulvr->...xkbvr", q,
                         row[..., 1:lx - 1, :, :, :, :])
        inner = torch.einsum("...xkbvr,...xbrj->...xkvj", r,
                             v[..., 1:, :, :, :])
        cores += list(inner.unbind(-4))
    last = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    last[..., :, :, 0] = torch.einsum(
        "...kal,...au,...ulv->...kv", g3[..., lx - 2, :, :, :],
        bmps[..., lx - 1, :, :, 0], row[..., lx - 1, :, :, :, 0])
    cores.append(last)
    out, norms = _normalize(torch.stack(cores, dim=-4), 3)
    return CompressResult(out, torch.log(norms).sum(-1),
                          torch.zeros(batch, dtype=rdt, device=dev))


# ---------------------------------------------------------------------------
# var2 / var1 schemes: variational fitting from the svd guess
# ---------------------------------------------------------------------------

def _edge_env(rows: int, cols: int, like: torch.Tensor, batch) -> torch.Tensor:
    e = torch.zeros(*batch, rows, cols, dtype=like.dtype, device=like.device)
    e[..., 0, 0] = 1.0
    return e


def _overlap_step_left(env, g_x, t_x):
    return torch.einsum("...am,...avb,...mvn->...bn", env, g_x.conj(), t_x)


def _overlap_env_right(guess, target):
    """OR[..., x] [chi, m]: overlaps <guess|target> of columns >= x, edges
    closed at index 0. Returns [..., Lx+1, chi, m]."""
    lx, chi, m = guess.shape[-4], guess.shape[-3], target.shape[-3]
    batch = torch.broadcast_shapes(guess.shape[:-4], target.shape[:-4])
    env = _edge_env(chi, m, guess, batch)
    rs = [env]
    for x in range(lx - 1, -1, -1):
        env = torch.einsum("...bn,...avb,...mvn->...am", env,
                           guess[..., x, :, :, :].conj(),
                           target[..., x, :, :, :])
        rs.append(env)
    return torch.stack(rs[::-1], dim=-3)


def _right_canonicalize_guess(guess):
    """LQ sweep right to left over [..., Lx, chi, D, chi] (edges closed at
    index 0); the represented state is kept exactly."""
    lx, chi, dv = guess.shape[-4], guess.shape[-3], guess.shape[-2]
    batch = guess.shape[:-4]
    gs = list(guess.unbind(-4))
    carry = torch.eye(chi, dtype=guess.dtype, device=guess.device)
    for x in range(lx - 1, 0, -1):
        t = torch.einsum("...avb,...bc->...avc", gs[x], carry)
        l_new, q = lq(t.reshape(*batch, chi, dv * chi))
        gs[x] = q.reshape(*batch, chi, dv, chi)
        carry = l_new
    gs[0] = torch.einsum("...avb,...bc->...avc", gs[0], carry)
    return gs


def compress_variational(mps: torch.Tensor, chi: int, trunc: TruncParams,
                         two_site: bool = True) -> CompressResult:
    """Variational fitting [..., Lx, m, D, m] -> [..., Lx, chi, D, chi]:
    the svd compression as the guess, then ``trunc.var_sweeps`` left-to-
    right sweeps that maximize <guess|target> by local updates, two-site
    (a truncated SVD re-splits each pair) or one-site (a QR moves the
    centre). The fitted MPS carries the target's scale, so the guess's
    log norm is not counted."""
    res = compress(mps, chi, trunc)
    lx, dv = mps.shape[-4], mps.shape[-2]
    m = mps.shape[-3]
    batch = mps.shape[:-4]
    tp = TruncParams(chi, trunc.d_min, trunc.trunc_err)
    target = mps.unbind(-4)
    guess = res.bmps
    for _ in range(trunc.var_sweeps):
        gs = _right_canonicalize_guess(guess)
        rights = _overlap_env_right(torch.stack(gs, dim=-4), mps)
        ol = _edge_env(chi, m, mps, batch)
        if two_site:
            for x in range(lx - 1):
                blk = torch.einsum("...am,...mvn,...nwp,...bp->...avwb", ol,
                                   target[x], target[x + 1],
                                   rights[..., x + 2, :, :])
                u, s, vh, _ = truncated_svd(
                    blk.reshape(*batch, chi * dv, dv * chi), tp)
                gs[x] = u.reshape(*batch, chi, dv, chi)
                gs[x + 1] = (s[..., :, None] * vh).reshape(*batch, chi, dv,
                                                           chi)
                ol = _overlap_step_left(ol, gs[x], target[x])
        else:
            # each column is replaced by its block from ol and the right
            # overlap, so the R that the reference pushes into the next
            # column is overwritten unread and is not formed here
            for x in range(lx):
                blk = torch.einsum("...am,...mvn,...bn->...avb", ol,
                                   target[x], rights[..., x + 1, :, :])
                if x < lx - 1:
                    q, _ = qr_safe(blk.reshape(*batch, chi * dv, chi))
                    blk = q.reshape(*batch, chi, dv, chi)
                gs[x] = blk
                ol = _overlap_step_left(ol, gs[x], target[x])
        guess = torch.stack(gs, dim=-4)
    out, norms = _normalize(guess, 3)
    return CompressResult(out, torch.log(norms).sum(-1), res.trunc_err)


# ---------------------------------------------------------------------------
# fast scheme: Cholesky-LQ canonicalization + randomized-subspace truncation
# ---------------------------------------------------------------------------

class FastBlocks(NamedTuple):
    """Gaussian test matrices of :func:`compress_fast`, one per bond:
    omega [lx-1, m, chi] (m = the grown bond dimension). The reference
    draws omega[k] from ``fold_in(PRNGKey(1234), k)``."""
    omega: torch.Tensor


@functools.lru_cache(maxsize=64)
def fast_blocks(lx: int, m: int, chi: int, dtype, device) -> FastBlocks:
    """The port's fixed test matrices: drawn once from a CPU
    ``torch.Generator`` seeded with the reference's key (the bits differ
    from JAX's), in float64, then cast and moved; cached per shape, dtype
    and device, so every call and chain shares one truncated map."""
    gen = torch.Generator().manual_seed(FAST_SEED)
    omega = torch.randn((max(lx - 1, 0), m, chi), generator=gen,
                        dtype=torch.float64)
    return FastBlocks(omega.to(dtype=dtype, device=device))


def _chol_factor(g, n: int, eps_rel: float):
    """Lower Cholesky factor of the Gram g [..., n, n] with its trace scale
    taken out and eps_rel jitter added, scaled back. A failed factorization
    leaves NaNs (as JAX's does) instead of raising."""
    tr = torch.diagonal(g, dim1=-2, dim2=-1).real.sum(-1)
    scale = torch.clamp(tr / n, min=_tiny(g))
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    l, info = torch.linalg.cholesky_ex(g / scale[..., None, None].to(g.dtype)
                                       + eps_rel * eye)
    l = torch.where((info > 0)[..., None, None],
                    torch.full_like(l, float("nan")), l)
    return l * torch.sqrt(scale)[..., None, None].to(g.dtype)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float64 (complex128). The fast scheme forms its Grams,
    Cholesky factors and triangular solves there: in float32 the round-off
    of a rank-deficient Gram (its largest eigenvalue near trace/rank, as
    at the main path's boundary) exceeds the jitter, the Cholesky fails
    and the reference's compression is NaN (``bmps.py:526-578``)."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def _chol_lq(mat, eps_rel):
    """mat = L @ Q with Q eps-approximately row-orthonormal; the product is
    exact by construction (L = chol(mat mat^H), Q = L^-1 mat)."""
    w = _wide(mat)
    l = _chol_factor(w @ w.mH, mat.shape[-2], eps_rel)
    q = torch.linalg.solve_triangular(l, w, upper=False)
    return l.to(mat.dtype), q.to(mat.dtype)


def _subspace_project(mat, omega, eps_rel, power_iters=0):
    """Left isometry Q [..., rows, chi] spanning about the dominant column
    space of mat (its range when rank <= chi), from the test matrix omega
    [cols, chi], orthonormalized by Cholesky-QR plus one Newton-Schulz
    step; returns (Q, Q^H mat)."""
    chi = omega.shape[-1]
    w = _wide(mat)
    eye = torch.eye(chi, dtype=w.dtype, device=w.device)

    def orthonormalize(y):
        l = _chol_factor(y.mH @ y, chi, eps_rel)
        q = torch.linalg.solve_triangular(l, y.mH, upper=False).mH
        return q @ (1.5 * eye - 0.5 * (q.mH @ q))

    q = orthonormalize(w @ _wide(omega))
    for _ in range(power_iters):
        q = orthonormalize(w @ (w.mH @ q))
    return q.to(mat.dtype), (q.mH @ w).to(mat.dtype)


def compress_fast(mps: torch.Tensor, chi: int, trunc: TruncParams,
                  eps_rel: float | None = None, power_iters: int = 0,
                  blocks: FastBlocks | None = None) -> CompressResult:
    """Matmul-and-Cholesky compression [..., Lx, m, D, m] -> [..., Lx, chi,
    D, chi]: right-to-left Cholesky-LQ canonicalization, then a left-to-
    right randomized-subspace truncation with the test matrices of
    ``blocks`` (default :func:`fast_blocks`)."""
    lx, m, dv = mps.shape[-4], mps.shape[-3], mps.shape[-2]
    batch = mps.shape[:-4]
    dtype, dev = mps.dtype, mps.device
    if eps_rel is None:
        eps_rel = 1e-12 if torch.finfo(mps.real.dtype).bits >= 64 else 1e-5
    if blocks is None:
        blocks = fast_blocks(lx, m, chi, dtype, dev)
    omega = blocks.omega

    carry, q_last = _chol_lq(mps[..., lx - 1, :, :, 0], eps_rel)
    inner = [None] * lx
    for x in range(lx - 2, 0, -1):
        t = torch.einsum("...avb,...bc->...avc", mps[..., x, :, :, :], carry)
        carry, q = _chol_lq(t.reshape(*batch, m, dv * m), eps_rel)
        inner[x] = q.reshape(*batch, m, dv, m)
    a0 = torch.einsum("...vb,...bc->...vc", mps[..., 0, 0, :, :], carry)

    q0, carry = _subspace_project(a0, omega[0], eps_rel, power_iters)
    first = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    first[..., 0, :, :] = q0
    outs = [first]
    for x in range(1, lx - 1):
        t = torch.einsum("...cb,...bvd->...cvd", carry, inner[x])
        q, carry = _subspace_project(t.reshape(*batch, chi * dv, m),
                                     omega[x], eps_rel, power_iters)
        outs.append(q.reshape(*batch, chi, dv, chi))
    last = torch.zeros(*batch, chi, dv, chi, dtype=dtype, device=dev)
    last[..., :, :, 0] = torch.einsum("...cb,...bv->...cv", carry, q_last)
    outs.append(last)
    out, norms = _normalize(torch.stack(outs, dim=-4), 3)
    return CompressResult(out, torch.log(norms).sum(-1),
                          torch.zeros(batch, dtype=mps.real.dtype,
                                      device=dev))


def absorb_row(bmps: torch.Tensor, row: torch.Tensor, chi: int,
               trunc: TruncParams) -> CompressResult:
    """One boundary growth step, compressed by trunc.scheme: "sketch" never
    forms the grown MPS; the other schemes compress multiply_mpo's."""
    if trunc.scheme == "sketch":
        return absorb_row_sketch(bmps, row, chi, trunc)
    grown = multiply_mpo(bmps, row)
    if trunc.scheme == "svd":
        return compress(grown, chi, trunc)
    if trunc.scheme in ("var2", "var1"):
        return compress_variational(grown, chi, trunc,
                                    two_site=trunc.scheme == "var2")
    if trunc.scheme == "fast":
        return compress_fast(grown, chi, trunc, power_iters=trunc.rsvd_power)
    raise ValueError(f"compression scheme {trunc.scheme!r}: expected one of "
                     "sketch, svd, var2, var1, fast")


# ---------------------------------------------------------------------------
# environment stacks and amplitudes
# ---------------------------------------------------------------------------

class EnvStacks(NamedTuple):
    """tops[..., y] absorbs rows 0..y-1, bots[..., y] rows y..Ly-1:
    [..., Ly+1, Lx, chi, D, chi]; log_tops/log_bots [..., Ly+1]."""
    tops: torch.Tensor
    bots: torch.Tensor
    log_tops: torch.Tensor
    log_bots: torch.Tensor


def all_top_envs(tn: torch.Tensor, chi: int, trunc: TruncParams):
    """tops[..., y] for y = 0..Ly of tn [..., Ly, Lx, u, l, d, r]."""
    ly, lx, dv = tn.shape[-6], tn.shape[-5], tn.shape[-4]
    batch = tn.shape[:-6]
    rdt = tn.real.dtype if tn.is_complex() else tn.dtype
    b = init_boundary(lx, chi, dv, tn.dtype, tn.device, batch)
    logw = torch.zeros(batch, dtype=rdt, device=tn.device)
    tops, logs = [b], [logw]
    for y in range(ly):
        res = absorb_row(b, tn[..., y, :, :, :, :, :], chi, trunc)
        b, logw = res.bmps, logw + res.log_norm
        tops.append(b)
        logs.append(logw)
    return torch.stack(tops, dim=-5), torch.stack(logs, dim=-1)


def all_env_stacks(tn: torch.Tensor, chi: int, trunc: TruncParams) -> EnvStacks:
    tops, log_tops = all_top_envs(tn, chi, trunc)
    ftops, flog = all_top_envs(flip_vertical(tn), chi, trunc)
    return EnvStacks(tops, torch.flip(ftops, [-5]), log_tops,
                     torch.flip(flog, [-1]))


def chain_slices(nc: int, chunk: int | None) -> list:
    """Slices of ``chunk`` chains (all nc at once for None) covering nc."""
    step = chunk or nc
    return [slice(i, min(i + step, nc)) for i in range(0, nc, step)]


def sub_stacks(stacks, sl: slice):
    """The chains sl of env stacks (or of a NamedTuple of tensors and such
    tuples, e.g. a GradedEnvShared) batched over a leading chain axis."""
    if stacks is None:
        return None
    return type(stacks)(*(sub_stacks(f, sl) if isinstance(f, tuple)
                          else f[sl] for f in stacks))


def cat_stacks(parts: list):
    """Env stacks (or nested NamedTuples of tensors) of consecutive chain
    slices joined along the chain axis."""
    if parts[0] is None:
        return None
    if len(parts) == 1:
        return parts[0]
    return type(parts[0])(*(cat_stacks(list(f)) if isinstance(f[0], tuple)
                            else torch.cat(f) for f in zip(*parts)))


def close_boundary(final: torch.Tensor) -> torch.Tensor:
    """Index-0 closure of a fully absorbed boundary MPS [..., Lx, chi, D, chi]."""
    v = final[..., 0, 0, 0, :]
    for x in range(1, final.shape[-4]):
        v = torch.einsum("...a,...ab->...b", v, final[..., x, :, 0, :])
    return v[..., 0]


def amplitude(tn: torch.Tensor, chi: int, trunc: TruncParams):
    """(mantissa, log_weight) of the full network; psi = mant * exp(logw)."""
    tops, log_tops = all_top_envs(tn, chi, trunc)
    return close_boundary(tops[..., -1, :, :, :, :]), log_tops[..., -1]


# ---------------------------------------------------------------------------
# row environments (BTens), holes, pair traces
# ---------------------------------------------------------------------------

class RowEnvs(NamedTuple):
    """lefts[..., x]: closure of columns < x; rights[..., x]: of columns
    >= x; both [..., Lx+1, chi, D, chi]; log_lefts/log_rights [..., Lx+1]."""
    lefts: torch.Tensor
    rights: torch.Tensor
    log_lefts: torch.Tensor
    log_rights: torch.Tensor


def row_envs(top: torch.Tensor, bot: torch.Tensor, row: torch.Tensor) -> RowEnvs:
    """All left/right BTens of the sandwiches top [..., Lx, chi, D, chi],
    row [..., Lx, u, l, d, r], bot [..., Lx, chi, D, chi]."""
    lx, chi = top.shape[-4], top.shape[-3]
    dv = row.shape[-3]
    batch = torch.broadcast_shapes(top.shape[:-4], row.shape[:-5],
                                   bot.shape[:-4])
    rdt = row.real.dtype if row.is_complex() else row.dtype
    init = _unit_env(chi, dv, row.dtype, row.device, batch)
    zero = torch.zeros(batch, dtype=rdt, device=row.device)

    def scan(step, xs):
        env, logw = init, zero
        envs, logs = [], []
        for x in xs:
            env, n = _normalize(step(env, top[..., x, :, :, :],
                                     row[..., x, :, :, :, :],
                                     bot[..., x, :, :, :]), 3)
            logw = logw + torch.log(n)
            envs.append(env)
            logs.append(logw)
        return envs, logs

    ls, log_ls = scan(col_transfer, range(lx))
    rs, log_rs = scan(col_transfer_right, range(lx - 1, -1, -1))
    lefts = torch.stack([init] + ls, dim=-4)
    rights = torch.stack(rs[::-1] + [init], dim=-4)
    return RowEnvs(lefts, rights, torch.stack([zero] + log_ls, dim=-1),
                   torch.stack(log_rs[::-1] + [zero], dim=-1))


def row_trace(envs: RowEnvs, x: int) -> torch.Tensor:
    """psi mantissa of each row sandwich closed at column x: lefts[..., x]
    against rights[..., x] -> [...]."""
    return torch.einsum("...alc,...alc->...", envs.lefts[..., x, :, :, :],
                        envs.rights[..., x, :, :, :])


def punch_holes_row(envs: RowEnvs, top: torch.Tensor, bot: torch.Tensor):
    """All site environments of a row: [..., Lx, u, l, d, r], grouped as
    (L.T)(B.R) like the reference."""
    lx = top.shape[-4]
    lt = torch.einsum("...xalc,...xauA->...xlcuA", envs.lefts[..., :lx, :, :, :],
                      top)
    br = torch.einsum("...xcdC,...xArC->...xcdAr", bot,
                      envs.rights[..., 1:, :, :, :])
    return torch.einsum("...xlcuA,...xcdAr->...xuldr", lt, br)


def replace_one_site_traces(envs: RowEnvs, top: torch.Tensor,
                            bot: torch.Tensor, candidates: torch.Tensor):
    """psi mantissas with site x replaced by each candidate: candidates
    [..., Lx, K, u, l, d, r] -> [..., Lx, K], through the row's holes."""
    holes = punch_holes_row(envs, top, bot)
    return torch.einsum("...xuldr,...xkuldr->...xk", holes, candidates)


def replace_nn_site_traces(envs: RowEnvs, top: torch.Tensor, bot: torch.Tensor,
                           cand1: torch.Tensor, cand2: torch.Tensor):
    """psi mantissas with sites (x, x+1) replaced by candidate pairs.
    cand1/cand2 [..., Lx-1, K, u, l, d, r] -> [..., Lx-1, K1, K2]. Both
    halves are K1 transfers batched over (bond, candidate)."""
    lx = top.shape[-4]

    def sl(t, a, b):   # columns a..b-1, plus a candidate axis
        return t[..., a:b, :, :, :].unsqueeze(-4)

    t1 = col_transfer(sl(envs.lefts, 0, lx - 1), sl(top, 0, lx - 1), cand1,
                      sl(bot, 0, lx - 1))
    t2 = col_transfer_right(sl(envs.rights, 2, lx + 1), sl(top, 1, lx), cand2,
                            sl(bot, 1, lx))
    return torch.einsum("...kalc,...jalc->...kj", t1, t2)


def replace_tnn_site_traces(envs: RowEnvs, top: torch.Tensor,
                            bot: torch.Tensor, cand1: torch.Tensor,
                            mid: torch.Tensor, cand2: torch.Tensor):
    """psi mantissas with the in-row third-neighbour pair (x, x+2) replaced
    by candidate pairs and the middle site x+1 unchanged. cand1/cand2
    [..., Lx-2, K, u, l, d, r], mid [..., Lx-2, u, l, d, r] (row[x+1]) ->
    [..., Lx-2, K1, K2]. Every transfer is a K1 launch batched over (bond,
    candidate)."""
    lx = top.shape[-4]
    nb = lx - 2

    def sl(t, a, b):   # columns a..b-1, plus a candidate axis
        return t[..., a:b, :, :, :].unsqueeze(-4)

    t1 = col_transfer(sl(envs.lefts, 0, nb), sl(top, 0, nb), cand1,
                      sl(bot, 0, nb))
    t1 = col_transfer(t1, sl(top, 1, nb + 1), mid.unsqueeze(-5),
                      sl(bot, 1, nb + 1))
    t2 = col_transfer_right(sl(envs.rights, 3, lx + 1), sl(top, 2, lx), cand2,
                            sl(bot, 2, lx))
    return torch.einsum("...kalc,...jalc->...kj", t1, t2)


# ---------------------------------------------------------------------------
# entanglement of a boundary MPS
# ---------------------------------------------------------------------------

def entanglement_entropy(mps: torch.Tensor, x: int) -> torch.Tensor:
    """Von Neumann entropy of a boundary MPS [..., Lx, chi, D, chi] across
    bond x (between columns x-1 and x, 1 <= x <= Lx-1), from the
    eigenvalues of G_L G_R (the cut's left and right Grams, trace-
    normalized per column): the squared Schmidt values. The eigenvalues of
    that non-Hermitian product are taken in complex128 for a real MPS, as
    the reference takes them; ``torch.linalg.eigvals`` of a CUDA tensor
    synchronizes with the host. Returns [...] in float64 for a real MPS."""
    lx, chi = mps.shape[-4], mps.shape[-3]
    batch = mps.shape[:-4]
    tiny = _tiny(mps)

    def trace_normalize(g):
        tr = torch.diagonal(g, dim1=-2, dim2=-1).real.sum(-1)
        return g / torch.clamp(tr, min=tiny)[..., None, None]

    gl = _edge_env(chi, chi, mps, batch)
    for t in mps[..., :x, :, :, :].unbind(-4):
        gl = trace_normalize(torch.einsum("...aA,...avb,...AvB->...bB", gl,
                                          t, t.conj()))
    gr = _edge_env(chi, chi, mps, batch)
    for t in reversed(mps[..., x:, :, :, :].unbind(-4)):
        gr = trace_normalize(torch.einsum("...avb,...AvB,...bB->...aA", t,
                                          t.conj(), gr))
    prod = gl @ gr
    lam = torch.linalg.eigvals(prod if mps.is_complex()
                               else prod.to(torch.complex128))
    p = torch.clamp(lam.real, min=0.0)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=tiny)
    return -torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-300)),
                        torch.zeros_like(p)).sum(-1)
