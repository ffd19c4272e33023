"""Matrix-free MinSR (port of ``peps_tpu/optimizer/krylov.py``): Lanczos
evaluation of the soft pseudo-inverse nat = A^H f(T) eps with T = A A^H
never formed. Every matvec T v = A (A^H v) is two matrix-vector products
over the [Ns, P] sample matrix, left to cuBLAS.

Exactness: Lanczos with full reorthogonalization reproduces f(T) b exactly
once m reaches the number of distinct T-eigenvalues represented in b
(m = Ns always suffices); for m < Ns it is the optimal-degree polynomial
approximation of f on the spectrum. The cutoff scale c is anchored to the
largest Ritz value, which converges to lambda_max(T) first.

The soft filter and the m x m tridiagonal eigenproblem run in float64
(``minsr_soft_filter``): the reference's lam^5 / (lam^6 + c^6) divides 0
by 0 in float32 once lam and c sit below about 1e-7 (c = 1e-8 lam_max
does at any Gram scale), and a centered sample matrix always has an
eigenvalue at round-off level.
"""
from __future__ import annotations

import torch


def minsr_soft_filter(lam: torch.Tensor, cutoff: float) -> torch.Tensor:
    """The MinSR soft pseudo-inverse f(lam) = lam^5 / (lam^6 + c^6) with
    c = cutoff * max(lam), in float64 and in a form that never forms lam^6
    or c^6: 1/lam / (1 + (c/lam)^6) for |lam| >= c, t^5 / (1 + t^6) / c
    with t = lam / c otherwise. Equal to the reference's formula wherever
    that is finite; finite for every finite lam (the reference gives
    0/0 = NaN at lam = 0 even in float64 when c^6 underflows)."""
    lam = lam.to(torch.float64)
    c = cutoff * torch.clamp(lam.max(), min=1e-300)
    big = lam.abs() >= c
    safe = torch.where(big, lam, torch.ones_like(lam))
    t = lam / c
    return torch.where(big, (1.0 / safe) / (1.0 + (c / safe) ** 6),
                       t ** 5 / (1.0 + t ** 6) / c)


def lanczos_fn_apply(matvec, b: torch.Tensor, m: int, filter_fn):
    """Return f(T) b for Hermitian PSD T given only ``matvec`` (v -> T v).

    Lanczos with full reorthogonalization (two Gram-Schmidt passes per step
    against the whole basis, held as [m+1, Ns] with unfilled rows zero, so
    the passes need no masking), a Python loop of m steps with no host
    synchronization. Breakdown (beta below round-off of the running scale,
    an invariant subspace found early) zeroes the next basis vector; the
    trailing tridiagonal block then decouples and carries no e1 weight.

    filter_fn maps the Ritz values (float64 [m]) to the filter values; the
    tridiagonal eigenproblem runs in float64 and the result is cast back to
    b's dtype.
    """
    ns = b.shape[0]
    dtype = b.dtype
    rdtype = b.real.dtype
    tiny = torch.finfo(rdtype).tiny
    eps_r = torch.finfo(rdtype).eps
    nb = torch.sqrt(torch.vdot(b, b).real)
    q0 = torch.where(nb > tiny, 1.0 / torch.clamp(nb, min=tiny),
                     torch.zeros_like(nb)) * b
    qbuf = torch.zeros((m + 1, ns), dtype=dtype, device=b.device)
    qbuf[0] = q0
    alphas, betas = [], []
    beta_prev = torch.zeros((), dtype=rdtype, device=b.device)
    for j in range(m):
        qj = qbuf[j]
        w = matvec(qj).to(dtype)
        alpha = torch.vdot(qj, w).real
        w = w - alpha * qj
        if j > 0:
            w = w - beta_prev * qbuf[j - 1]
        for _ in range(2):                       # zero rows add nothing
            w = w - qbuf.T @ (qbuf.conj() @ w)
        beta = torch.sqrt(torch.vdot(w, w).real)
        ok = beta > eps_r * torch.clamp(alpha.abs(), min=1.0)
        qbuf[j + 1] = torch.where(ok, 1.0 / torch.clamp(beta, min=tiny),
                                  torch.zeros_like(beta)) * w
        beta = torch.where(ok, beta, torch.zeros_like(beta))
        alphas.append(alpha)
        betas.append(beta)
        beta_prev = beta
    a64 = torch.stack(alphas).to(torch.float64)
    b64 = torch.stack(betas[:-1]).to(torch.float64) if m > 1 else \
        a64.new_zeros(0)
    tm = torch.diag(a64) + torch.diag(b64, 1) + torch.diag(b64, -1)
    lam, u = torch.linalg.eigh(tm)
    y = u @ (filter_fn(lam) * u[0, :])           # f(T_m) e1
    return qbuf[:m].T @ (nb * y.to(rdtype)).to(dtype)


def minsr_krylov_natural_gradient(o_samples: torch.Tensor,
                                  e_samples: torch.Tensor,
                                  pseudo_inverse_cutoff: float, m: int,
                                  shape):
    """MinSR natural gradient nat = A^H f(A A^H) eps without the Gram,
    with the dense path's filter (``minsr_soft_filter``); m >= Ns
    reproduces the dense path."""
    a = o_samples                                 # [Ns, P]
    eps = e_samples.to(a.dtype)                   # [Ns]
    x = lanczos_fn_apply(lambda v: a @ (a.mH @ v), eps, m,
                         lambda lam: minsr_soft_filter(
                             lam, pseudo_inverse_cutoff))
    return (a.mH @ x).reshape(shape)
