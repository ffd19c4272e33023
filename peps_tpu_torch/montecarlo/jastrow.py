"""Density-density Jastrow dress (port of ``peps_tpu/montecarlo/jastrow.py``).

psi_J(s) = exp(-1/2 sum_ij v_ij n_i n_j) psi(s), with v a dense symmetric
[N, N] matrix (N = Ly*Lx, zero diagonal) and n_i the density of site i's
local state (``nvals[config]``). Replacement ratios come from the field
F_i = sum_j v_ij n_j. Every function takes configurations with leading
chain dimensions, config [..., Ly, Lx].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from peps_tpu_torch.device import resolve_device


class JastrowDress(NamedTuple):
    v: torch.Tensor        # [N, N] symmetric, zero diagonal
    nvals: torch.Tensor    # [d] density of each local state

    def densities(self, config):
        """n [..., N] of config [..., Ly, Lx]."""
        return self.nvals[config.long()].flatten(-2)

    def log_factor(self, config):
        """log J(s) = -1/2 n.v.n -> [...]."""
        n = self.densities(config)
        return -0.5 * (n * (n @ self.v.mT)).sum(-1)

    def field(self, config):
        """F [..., N], F_i = sum_j v_ij n_j."""
        return self.densities(config) @ self.v.mT


def hole_attraction_dress(hole_vals, ly: int, lx: int, kappa: float,
                          diagonal: bool = False, dtype=torch.float64,
                          device=None) -> JastrowDress:
    """J(s) = 2 kappa sum_<ij> h_i h_j over OBC nearest neighbours (and
    diagonal neighbours with diagonal=True), h the per-state hole indicator
    ``hole_vals`` [d]: v_ij = -2 kappa on every such pair. The support-
    conditioning dress of the reference's t-J pair-correlation estimator
    (see its docstring for the recipe)."""
    device = resolve_device(device)
    n = ly * lx
    v = torch.zeros(n, n, dtype=dtype, device=device)
    idx = torch.arange(n, device=device).reshape(ly, lx)
    pairs = [(idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])]
    if diagonal:
        pairs += [(idx[:-1, :-1], idx[1:, 1:]), (idx[:-1, 1:], idx[1:, :-1])]
    for a, b in pairs:
        v[a.reshape(-1), b.reshape(-1)] = -2.0 * kappa
        v[b.reshape(-1), a.reshape(-1)] = -2.0 * kappa
    return JastrowDress(v, torch.as_tensor(hole_vals, dtype=dtype,
                                           device=device))


def holes_adjacent(config, hole_vals, diagonal: bool = True):
    """1.0 where some pair of holes is (Chebyshev-)adjacent, per
    configuration of config [..., Ly, Lx] -> float32 [...]."""
    h = torch.as_tensor(hole_vals, device=config.device)[config.long()] > 0.5
    hits = (h[..., :, :-1] & h[..., :, 1:]).flatten(-2).any(-1) \
        | (h[..., :-1, :] & h[..., 1:, :]).flatten(-2).any(-1)
    if diagonal:
        hits = hits | (h[..., :-1, :-1] & h[..., 1:, 1:]).flatten(-2).any(-1) \
            | (h[..., :-1, 1:] & h[..., 1:, :-1]).flatten(-2).any(-1)
    return hits.to(torch.float32)


def one_site_log_ratios(dress: JastrowDress, config, ly: int, lx: int):
    """log(J(s')/J(s)) for site (y, x) replaced by each state p:
    [..., Ly, Lx, d]. With v_ii = 0 the change is -delta_i F_i."""
    cur = dress.nvals[config.long()]
    f = dress.field(config).reshape(cur.shape)
    return -(dress.nvals - cur[..., None]) * f[..., None]


def pair_log_ratios(nvals, n1, n2, f1, f2, v12):
    """log Jastrow ratios [..., d, d] of a site pair replaced by every
    (p, q), from the pair's densities n1, n2, the fields f1, f2 at its
    sites and their coupling v12 (each broadcasting as [..., 1, 1])."""
    f1 = f1 - v12 * n2                                # field without partner
    f2 = f2 - v12 * n1
    d1 = nvals[:, None] - n1                          # [..., d, 1]
    d2 = nvals[None, :] - n2                          # [..., 1, d]
    return -d1 * f1 - d2 * f2 - v12 * ((n1 + d1) * (n2 + d2) - n1 * n2)


def two_site_log_ratios(dress: JastrowDress, config, idx1, idx2):
    """log Jastrow ratios for the flat sites idx1[k], idx2[k] replaced by
    (p, q): [..., K, d, d]."""
    n = dress.densities(config)
    f = n @ dress.v.mT
    return pair_log_ratios(dress.nvals, n[..., idx1, None, None],
                           n[..., idx2, None, None], f[..., idx1, None, None],
                           f[..., idx2, None, None],
                           dress.v[idx1, idx2][:, None, None])
