"""Conjugate gradient for Hermitian PSD operators (port of
``peps_tpu/optimizer/cg.py``).

The loop stays on the device: each iteration updates masked by a device-side
``active`` flag (rs > tol^2 and it < max_iter), so a converged solve stops
changing exactly where the reference's ``lax.while_loop`` stops. The host
reads the flag once every ``CHECK_EVERY`` iterations to leave the loop, so a
solve costs at most CHECK_EVERY - 1 wasted matvecs and one host sync per
CHECK_EVERY iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

CHECK_EVERY = 5


@dataclasses.dataclass(frozen=True)
class CGParams:
    max_iter: int = 100
    tol: float = 1e-6          # relative residual tolerance


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor   # 0-d int64 on the device
    residual_norm: torch.Tensor


def _rdot(a, b):
    return torch.vdot(a, b).real


def cg_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None,
             params: CGParams) -> CGResult:
    """Solve A x = b for Hermitian positive (semi)definite A."""
    tiny = torch.finfo(b.real.dtype).tiny
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    p = r
    rs = _rdot(r, r)
    b_norm = torch.sqrt(torch.clamp(_rdot(b, b), min=tiny))
    tol2 = (params.tol * b_norm) ** 2
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(params.max_iter):
        if k % CHECK_EVERY == 0 and not bool(rs > tol2):
            break
        active = rs > tol2
        ap = matvec(p)
        alpha = rs / torch.clamp(_rdot(p, ap), min=tiny)
        alpha = torch.where(active, alpha, torch.zeros_like(alpha))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _rdot(r, r)
        beta = rs_new / torch.clamp(rs, min=tiny)
        p = torch.where(active, r + beta * p, p)
        rs = torch.where(active, rs_new, rs)
        it = it + active.to(it.dtype)
    return CGResult(x, it, torch.sqrt(rs))
