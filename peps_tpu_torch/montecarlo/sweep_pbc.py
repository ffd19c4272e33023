"""Monte Carlo sweeps of the torus (port of
``peps_tpu/montecarlo/sweep_pbc.py``).

A sweep visits every nearest-neighbour bond of the torus in a fixed order:
all horizontal bonds, then all vertical ones, each row-major. All chains
decide on the same bond at the same time, as one batch. Two samplers:

* :func:`mc_sweep_pbc`, the full recompute: every proposal contracts the
  whole torus. The exchange rule carries log|psi| of the current
  configurations and contracts one proposal per chain whose two sites
  differ; the Suwa-Todo rule contracts the d^2 candidates of every chain
  in one batched call.
* :func:`mc_sweep_pbc_trial`, the trial/commit cache
  (:mod:`~peps_tpu_torch.contraction.pbc_trial`): the cache is built from
  the current configurations once a sweep (unless passed in), and each
  proposal re-propagates a small window through it, with the frozen
  projectors (exact=False) or fresh ones (exact=True).

Random numbers: one uniform per chain per bond decision, ``[nc, 2 Ly
Lx]`` in the bond order above, passed in (the parity tests replay the
reference's key splits) or drawn by :func:`draw_uniforms_pbc`. Both rules
take that one uniform: the exchange rule's Metropolis test and the
Suwa-Todo pick. Both samplers read the same uniforms, so where chi does
not truncate they follow the same trajectories.

Not ported: the reference's host-driven and bond-fused variants
(``mc_sweep_pbc_host``, ``fuse_bonds``) and its chain grouping, which work
around XLA:TPU compile limits; the bond loop here is a Python loop.
"""
from __future__ import annotations

import torch

from peps_tpu_torch.contraction.pbc import TestMatrix, contract_pbc
from peps_tpu_torch.contraction.pbc_trial import (PBCCache, _log_abs,
                                                  begin_trial, build_cache,
                                                  commit_trial,
                                                  replace_sites,
                                                  select_trial,
                                                  trial_log_abs)
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.suwa_todo import suwa_todo_pick
from peps_tpu_torch.montecarlo.sweep import SweepStats, UpdateRule
from peps_tpu_torch.tps import project


def _all_nn_bonds(ly: int, lx: int) -> list:
    """(y1, x1, y2, x2) of every torus bond: horizontal, then vertical."""
    h = [(y, x, y, (x + 1) % lx) for y in range(ly) for x in range(lx)]
    v = [(y, x, (y + 1) % ly, x) for y in range(ly) for x in range(lx)]
    return h + v


def draw_uniforms_pbc(generator: torch.Generator, nc: int, ly: int, lx: int,
                      dtype, device) -> torch.Tensor:
    """One torus sweep's uniforms [nc, 2 Ly Lx] from one generator call."""
    return torch.rand(nc, 2 * ly * lx, generator=generator, dtype=dtype,
                      device=device)


def _log_abs_of(tn, chi, trunc, test_matrix):
    return _log_abs(*contract_pbc(tn, chi, trunc, test_matrix=test_matrix))


def _pairs(d: int, device):
    """The d^2 candidate pairs (p, q) of a bond, p-major."""
    p = torch.arange(d, device=device)
    return p.repeat_interleave(d), p.repeat(d)


def _check_uniforms(uniforms, nc, ly, lx):
    if tuple(uniforms.shape) != (nc, 2 * ly * lx):
        raise ValueError(f"torus sweep uniforms: expected [{nc}, "
                         f"{2 * ly * lx}], got {tuple(uniforms.shape)}")


def mc_sweep_pbc(tps: torch.Tensor, configs: torch.Tensor, chi: int,
                 trunc: TruncParams, rule: UpdateRule,
                 uniforms: torch.Tensor,
                 test_matrix: TestMatrix | None = None):
    """One full-recompute sweep of every chain over all torus bonds.

    tps [Ly, Lx, d, D, D, D, D]; configs [nc, Ly, Lx]; uniforms
    [nc, 2 Ly Lx]. Returns (configs', SweepStats) with per-chain accepted
    and trial counts [nc]."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    configs = configs.long().clone()
    nc = configs.shape[0]
    _check_uniforms(uniforms, nc, ly, lx)
    acc = torch.zeros(nc, dtype=torch.int64, device=tps.device)
    tri = torch.zeros_like(acc)
    bonds = _all_nn_bonds(ly, lx)
    if rule.mode == "exchange":
        la0 = _log_abs_of(project(tps, configs), chi, trunc, test_matrix)
        for b, (y1, x1, y2, x2) in enumerate(bonds):
            c1, c2 = configs[:, y1, x1], configs[:, y2, x2]
            differ = c1 != c2
            tri += differ
            # a chain whose two sites are equal cannot accept: only the
            # others are contracted
            idx = differ.nonzero().squeeze(1)
            if idx.numel() == 0:
                continue
            cand = configs[idx]
            cand[:, y1, x1], cand[:, y2, x2] = c2[idx], c1[idx]
            la1 = _log_abs_of(project(tps, cand), chi, trunc, test_matrix)
            ok = uniforms[idx, b] < torch.exp(2.0 * (la1 - la0[idx]))
            hit = idx[ok]
            configs[hit] = cand[ok]
            la0[hit] = la1[ok]
            acc[hit] += 1
        return configs, SweepStats(acc, tri)
    cmask = rule.mask_array(d, tps.real.dtype if tps.is_complex()
                            else tps.dtype, tps.device)
    pp, qq = _pairs(d, tps.device)
    for b, (y1, x1, y2, x2) in enumerate(bonds):
        net = project(tps, configs)[:, None].repeat(1, d * d, 1, 1, 1, 1, 1,
                                                    1)
        net[:, :, y1, x1] = tps[y1, x1][pp]
        net[:, :, y2, x2] = tps[y2, x2][qq]
        mant, logw = contract_pbc(net, chi, trunc, test_matrix=test_matrix)
        table = mant * torch.exp(logw - logw.amax(-1, keepdim=True)) \
            .to(mant.dtype)
        cur = configs[:, y1, x1] * d + configs[:, y2, x2]
        new = _suwa_todo(table.abs() ** 2, cur, uniforms[:, b], cmask)
        configs[:, y1, x1], configs[:, y2, x2] = new // d, new % d
        acc += new != cur
        tri += 1
    return configs, SweepStats(acc, tri)


def _suwa_todo(w, cur, u, cmask):
    if cmask is not None:
        w = w * cmask[cur]
    return suwa_todo_pick(w, cur, u)


def _windows(horizontal: bool):
    """((wr, wc), (dy, dx)): the stage-0 window of a bond and the offset of
    its second site."""
    return ((1, 2), (0, 1)) if horizontal else ((2, 1), (1, 0))


def mc_sweep_pbc_trial(tps: torch.Tensor, configs: torch.Tensor, chi: int,
                       trunc: TruncParams, rule: UpdateRule,
                       uniforms: torch.Tensor,
                       caches: PBCCache | None = None, exact: bool = False,
                       return_caches: bool = False,
                       test_matrix: TestMatrix | None = None):
    """One sweep of every chain through the trial/commit cache.

    The bond order, uniforms and returns are those of
    :func:`mc_sweep_pbc`; with return_caches the committed cache is
    returned as a third element. caches: a cache of exactly these
    configurations (e.g. a previous call's), which skips the rebuild (the
    frozen map then stays that of the older configurations) and is
    committed in place; None builds it from configs. exact=True re-propagates with fresh projectors (equal to
    the full recompute to round-off)."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    configs = configs.long().clone()
    nc = configs.shape[0]
    _check_uniforms(uniforms, nc, ly, lx)
    if caches is None:
        caches = build_cache(project(tps, configs), chi, trunc,
                             test_matrix=test_matrix)
    kw = {"chi": chi, "trunc": trunc, "exact": exact,
          "test_matrix": test_matrix}
    acc = torch.zeros(nc, dtype=torch.int64, device=tps.device)
    tri = torch.zeros_like(acc)
    cmask = rule.mask_array(d, tps.real.dtype if tps.is_complex()
                            else tps.dtype, tps.device)
    pp, qq = _pairs(d, tps.device)
    b = 0
    for horizontal in (True, False):
        (wr, wc), (dy, dx) = _windows(horizontal)
        for y in range(ly):
            for x in range(lx):
                y2, x2 = (y + dy) % ly, (x + dx) % lx
                c1, c2 = configs[:, y, x], configs[:, y2, x2]
                u = uniforms[:, b]
                b += 1
                if rule.mode == "exchange":
                    blk = replace_sites(tps, configs, [(0, 0), (dy, dx)],
                                        [c2, c1], y, x, wr, wc)
                    trial = begin_trial(caches, blk, y, x, **kw)
                    ratio2 = torch.exp(2.0 * (trial_log_abs(caches, trial)
                                              - caches.log_abs))
                    differ = c1 != c2
                    accept = differ & (u < ratio2)
                    configs[:, y, x], configs[:, y2, x2] = \
                        torch.where(accept, c2, c1), \
                        torch.where(accept, c1, c2)
                    commit_trial(caches, trial, accept)
                    acc += accept
                    tri += differ
                    continue
                states = [pp.expand(nc, -1), qq.expand(nc, -1)]
                blk = replace_sites(tps, configs, [(0, 0), (dy, dx)],
                                    states, y, x, wr, wc)
                trials = begin_trial(caches, blk, y, x, **kw)
                las = trial_log_abs(caches, trials)
                w = torch.exp(2.0 * (las - las.amax(-1, keepdim=True)))
                cur = c1 * d + c2
                new = _suwa_todo(w, cur, u, cmask)
                commit_trial(caches, select_trial(trials, new))
                configs[:, y, x], configs[:, y2, x2] = new // d, new % d
                acc += new != cur
                tri += 1
    out = (configs, SweepStats(acc, tri))
    return out + (caches,) if return_caches else out
