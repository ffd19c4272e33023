"""Static-shape truncated linear algebra (port of ``peps_tpu/linalg.py``).

Truncation keeps the static rank ``d_max`` and masks discarded singular
triples to exact zeros, as the reference does. Every function takes leading
batch dimensions. Batched QR/SVD go to ``torch.linalg`` (cuSOLVER on the
card). ``svd_safe`` and its custom VJP are off the OBC path: they come with
PBC contraction (ROADMAP queue 1, item 11).
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
