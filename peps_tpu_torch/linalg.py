"""Static-shape truncated linear algebra (port of ``peps_tpu/linalg.py``).

Truncation keeps the static rank ``d_max`` and masks discarded singular
triples to exact zeros, as the reference does. Every function takes leading
batch dimensions. Batched QR/SVD go to ``torch.linalg`` (cuSOLVER on the
card). :func:`svd_safe` is an SVD whose backward stays finite at
degenerate singular values (the torus contractor differentiates through
it).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TruncParams:
    """Truncation policy (same fields as the reference's ``TruncParams``).

    scheme: BMPS compression, "sketch" (randomized two-sided, the main
    path), "svd" (the accuracy oracle), "var2"/"var1" (variational fitting
    from the svd guess, two-site or one-site updates, ``var_sweeps``
    sweeps) or "fast" (Cholesky-LQ and randomized-subspace truncation,
    ``rsvd_power`` power iterations)."""
    d_max: int
    d_min: int = 1
    trunc_err: float = 1e-12
    scheme: str = "svd"
    var_sweeps: int = 2
    rsvd_power: int = 0


def _tiny(dtype) -> float:
    return torch.finfo(dtype).tiny


def svd_mask(s: torch.Tensor, params: TruncParams) -> torch.Tensor:
    """0/1 keep-mask over descending singular values [..., k]: keep the
    fewest leading values whose discarded squared weight stays within
    trunc_err, at least d_min and at most d_max."""
    s2 = s * s
    total = s2.sum(-1, keepdim=True)
    tail = torch.flip(torch.cumsum(torch.flip(s2, [-1]), -1), [-1])
    idx = torch.arange(s.shape[-1], device=s.device)
    keep = tail > params.trunc_err * torch.clamp(total, min=_tiny(s.dtype))
    keep = (keep | (idx < params.d_min)) & (idx < params.d_max)
    return keep.to(s.dtype)


def truncated_svd(mat: torch.Tensor, params: TruncParams):
    """Masked truncated SVD of [..., m, n] with static rank d_max.

    Returns (u [..., m, d_max], s [..., d_max], vh [..., d_max, n],
    trunc_err [...]); discarded triples are exact zeros, and the factors are
    zero-padded when min(m, n) < d_max."""
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    mask = svd_mask(s, params)
    s_kept = s * mask
    k = min(mat.shape[-2], mat.shape[-1])
    d_max = params.d_max
    err = ((s - s_kept) ** 2).sum(-1)
    trunc_err = err / torch.clamp((s * s).sum(-1), min=_tiny(s.dtype))
    if k >= d_max:
        col = mask[..., :d_max]
        u = u[..., :, :d_max] * col[..., None, :]
        s_kept = s_kept[..., :d_max]
        vh = vh[..., :d_max, :] * col[..., :, None]
    else:
        pad = d_max - k
        u = torch.nn.functional.pad(u * mask[..., None, :], (0, pad))
        s_kept = torch.nn.functional.pad(s_kept, (0, pad))
        vh = torch.nn.functional.pad(vh * mask[..., :, None], (0, 0, 0, pad))
    return u, s_kept, vh, trunc_err


def _rank_mask(s: torch.Tensor, shape) -> torch.Tensor:
    tol = torch.finfo(s.dtype).eps * max(shape[-2], shape[-1])
    smax = s.amax(-1, keepdim=True)
    return (s > tol * smax).to(s.dtype)


def lq(mat: torch.Tensor):
    """mat = L @ Q with Q row-orthonormal, through the SVD (L = U S, Q = Vh);
    sub-numerical-rank directions are masked to exact zeros so padded bond
    slots stay exactly zero (see the reference's docstring)."""
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    mask = _rank_mask(s, mat.shape)
    return u * (s * mask)[..., None, :].to(u.dtype), \
        vh * mask[..., :, None].to(vh.dtype)


def blq(mat: torch.Tensor):
    """Batched LQ through QR of the conjugate transpose: mat = L @ Q."""
    q_t, r_t = torch.linalg.qr(mat.mH, mode="reduced")
    return r_t.mH, q_t.mH


def qr(mat: torch.Tensor):
    """Reduced QR; returns (q, r)."""
    return torch.linalg.qr(mat, mode="reduced")


def qr_safe(mat: torch.Tensor):
    """mat = Q R with Q column-orthonormal through the SVD (Q = U, R = S Vh),
    sub-numerical-rank directions masked to exact zeros."""
    u, s, vh = torch.linalg.svd(mat, full_matrices=False)
    mask = _rank_mask(s, mat.shape)
    return u * mask[..., None, :].to(u.dtype), \
        (s * mask)[..., :, None].to(u.dtype) * vh


def safe_inverse(x: torch.Tensor, tol: float = 1e-10) -> torch.Tensor:
    """Elementwise pseudo-inverse with a cutoff relative to max |x| over the
    whole tensor (the lambda^-1 guard of simple update)."""
    ax = x.abs()
    scale = ax.max()
    cutoff = tol * torch.clamp(scale, min=_tiny(ax.dtype))
    keep = ax > cutoff
    return torch.where(keep, 1.0 / torch.where(keep, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def expm_taylor(mat: torch.Tensor, order: int = 16) -> torch.Tensor:
    """Taylor-series matrix exponential of [..., n, n] (small gates)."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    acc = eye.expand_as(mat).clone()
    term = acc.clone()
    for n in range(1, order + 1):
        term = term @ mat / n
        acc = acc + term
    return acc


# ---------------------------------------------------------------------------
# Degenerate-safe SVD for autograd (the torus contractor's holes)
# ---------------------------------------------------------------------------

def svd_safe_backward(u, s, vh, du, ds, dvh):
    """The reference's regularised SVD cotangent map (``peps_tpu/linalg.py:
    _svd_safe_bwd``) for factors u [..., m, k], s [..., k], vh [..., k, n]
    and cotangents du, ds, dvh (any may be None), in JAX's convention (a
    transpose, no conjugation). The 1/(s_i^2 - s_j^2) factors are
    regularised as diff / (diff^2 + eps), eps = 1e-12 max s^2 floored at
    the smallest normal number (so a zero matrix gives 0, not 0/0); the
    off-range terms of a rectangular matrix are added. Returns d mat
    [..., m, n]."""
    m, n, k = u.shape[-2], vh.shape[-1], s.shape[-1]
    dt = u.dtype
    s2 = s * s
    eps = torch.clamp(1e-12 * s2.amax(-1, keepdim=True),
                      min=_tiny(s.dtype))[..., None]
    diff = s2[..., None, :] - s2[..., :, None]
    f = diff / (diff * diff + eps)
    f = f * (1.0 - torch.eye(k, dtype=f.dtype, device=f.device))
    sinv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    zeros = torch.zeros(*s.shape[:-1], k, k, dtype=dt, device=u.device)
    uh_du = u.mH @ du if du is not None else zeros
    v = vh.mH
    dv = dvh.mH if dvh is not None else torch.zeros_like(v)
    vh_dv = vh @ dv
    j_u = f.to(dt) * uh_du
    j_v = f.to(dt) * vh_dv
    s_c = s.to(dt)
    term = (j_u + j_u.mH) * s_c[..., None, :] \
        + s_c[..., :, None] * (j_v + j_v.mH)
    if ds is not None:
        term = term + torch.diag_embed(ds.to(dt))
    dmat = u @ term @ vh
    if m > k and du is not None:
        proj = torch.eye(m, dtype=dt, device=u.device) - u @ u.mH
        dmat = dmat + proj @ du @ (sinv.to(dt)[..., :, None] * vh)
    if n > k and dvh is not None:
        proj = torch.eye(n, dtype=dt, device=u.device) - v @ vh
        dmat = dmat + (u * sinv.to(dt)[..., None, :]) @ dv.mH @ proj
    return dmat


class SvdSafe(torch.autograd.Function):
    """Thin SVD whose backward is :func:`svd_safe_backward`. PyTorch's
    gradient of a complex tensor is the conjugate of JAX's cotangent, so
    the backward maps conj(cotangent) and conjugates the result (the
    identity for real tensors)."""

    @staticmethod
    def forward(ctx, mat):
        # a non-finite matrix gives NaN factors, as JAX's SVD does, instead
        # of torch's error, so a batch keeps its finite members
        bad = ~torch.isfinite(mat).all(-1).all(-1)
        u, s, vh = torch.linalg.svd(
            torch.where(bad[..., None, None], torch.zeros_like(mat), mat),
            full_matrices=False)
        nan = torch.full((), float("nan"), dtype=s.dtype, device=s.device)
        u = torch.where(bad[..., None, None], nan.to(u.dtype), u)
        s = torch.where(bad[..., None], nan, s)
        vh = torch.where(bad[..., None, None], nan.to(vh.dtype), vh)
        ctx.save_for_backward(u, s, vh)
        return u, s, vh

    @staticmethod
    def backward(ctx, du, ds, dvh):
        u, s, vh = ctx.saved_tensors
        dmat = svd_safe_backward(u, s, vh, du.conj(), ds, dvh.conj())
        return dmat.conj()


def svd_safe(mat: torch.Tensor):
    """(u, s, vh) of [..., m, n], thin, with a backward that stays finite
    for (near-)degenerate and zero singular values (port of
    ``peps_tpu/linalg.py:192 svd_safe``)."""
    return SvdSafe.apply(mat)
