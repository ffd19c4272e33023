"""Suwa-Todo rejection-free pick (PRL 105, 120603), batched over a leading
axis (port of ``peps_tpu/montecarlo/suwa_todo.py``): geometric allocation
on a ring with the largest weight swapped to index 0, driven by one
uniform per pick."""
from __future__ import annotations

import torch


def suwa_todo_pick(weights: torch.Tensor, current: torch.Tensor,
                   u: torch.Tensor) -> torch.Tensor:
    """Next state of each row of non-negative weights [..., K], given the
    current states [...] (weights[current] > 0) and uniforms u [...] in
    [0, 1). Returns int64 states [...]."""
    k = weights.shape[-1]
    current = current.long()
    kmax = torch.argmax(weights, dim=-1, keepdim=True)
    w0 = weights[..., :1]
    wmax = torch.gather(weights, -1, kmax)
    w = weights.clone()
    w[..., :1] = wmax
    w.scatter_(-1, kmax, w0)
    kmax = kmax.squeeze(-1)
    cur = torch.where(current == kmax, 0,
                      torch.where(current == 0, kmax, current))
    s = torch.cumsum(w, dim=-1)
    total = s[..., k - 1]
    s_im1 = torch.where(
        cur == 0, torch.zeros_like(total),
        torch.gather(s, -1, torch.clamp(cur - 1, min=0)[..., None])
        .squeeze(-1))
    start = s_im1 + w[..., 0]
    start = torch.where(start >= total, start - total, start)
    x = start + u.to(w.dtype) * torch.gather(w, -1, cur[..., None]).squeeze(-1)
    x = torch.where(x >= total, x - total, x)
    j = torch.searchsorted(s.contiguous(), x[..., None].contiguous(),
                           right=True).squeeze(-1)
    j = torch.clamp(j, max=k - 1)
    return torch.where(j == 0, kmax, torch.where(j == kmax, 0, j))
