"""Trial/commit cache of the torus contractor (port of
``peps_tpu/contraction/pbc_trial.py``).

A bond proposal on the torus changes two sites. Instead of coarse-graining
the whole network again, the cache keeps every stage grid, every stage's
absorb-ready projector grids and every node's log-norm of one full
contraction, and a trial re-propagates only a small window of nodes
through the stages:

* ``exact=True`` takes fresh projectors on the window, which dilates by
  one row on each side per stage (a projector reads the row below its
  bond); it equals the full recompute to round-off.
* ``exact=False`` (frozen) reuses the cached projectors: matmuls only, and
  the window never dilates. Amplitude ratios are then formed through one
  fixed truncated map, re-derived from the current configuration when the
  cache is rebuilt (once a sweep in :mod:`~peps_tpu_torch.montecarlo.
  sweep_pbc`).

Layout: every grid carries a leading chain axis, stage grids are
[nc, n_s, m_s, u, l, d, r]. Every chain sits at the same bond at the same
time (the bond order is fixed), so a window's anchor is a pair of Python
integers and a window is one index gather per lattice axis for all chains;
the torus wrap-around is a modular index list. A trial block may carry more
leading axes than the cache (the Suwa-Todo rule's d^2 candidates of each
chain); the cached windows are broadcast over them.

Bookkeeping: ``logw = sum over stages of the node log-norms``; a trial
carries ``dln`` = (new window log-norms) - (cached ones), so
``log|psi_trial| = log|mant_trial| + cache.logw + dln``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from peps_tpu_torch.contraction.pbc import (TestMatrix, _absorb_pair,
                                            _pair_truncate, _pbc_size_ok,
                                            _transpose_frame,
                                            _triple_columns,
                                            _truncate_vertical_merged)
from peps_tpu_torch.linalg import TruncParams


# ----------------------------------------------------------------- plans


def stage_plan(ly: int, lx: int) -> tuple:
    """The contraction's stages: (kind, n, m, m2) per coarse-graining
    step, with the entry grid [n, m], the pairing kind ("pair", "triple"
    or "none") and the column count after it (before the frame
    transpose)."""
    plan = []
    n, m = ly, lx
    while n > 1 or m > 1:
        if m > 1:
            kind, m2 = (("triple", m // 3) if m % 3 == 0 and m % 2 != 0
                        else ("pair", m // 2))
        else:
            kind, m2 = "none", m
        plan.append((kind, n, m, m2))
        n, m = m2, n
    return tuple(plan)


def window_plan(plan, wr0: int, wc0: int, exact: bool) -> tuple:
    """Per-stage window extents of a trial whose stage-0 block is
    [wr0, wc0]: the entry window (wr, wc), the input rows iwr and the
    output block (owr, owc). Frozen windows never dilate; exact ones grow
    by one row on each side per stage."""
    wps = []
    wr, wc = wr0, wc0
    for kind, n, m, m2 in plan:
        wr, wc = min(wr, n), min(wc, m)
        if kind == "none":
            owr, owc, iwr = wr, wc, wr
        else:
            g = 2 if kind == "pair" else 3
            owc = min(m2, wc // g + 1)
            if exact:
                owr = min(n, wr + 2)
                iwr = min(n, owr + 2)
            else:
                owr = iwr = wr
        wps.append({"kind": kind, "n": n, "m": m, "m2": m2, "wr": wr,
                    "wc": wc, "iwr": iwr, "owr": owr, "owc": owc})
        wr, wc = owc, owr               # the frame transpose swaps the axes
    return tuple(wps)


# ----------------------------------------------- modular gather / scatter


@functools.lru_cache(maxsize=None)
def _ring(r0: int, nr: int, n: int, device) -> torch.Tensor:
    return torch.tensor([(r0 + i) % n for i in range(nr)], dtype=torch.int64,
                        device=device)


def _take2(grid, r0: int, nr: int, c0: int, nc: int, ax: int):
    """Rows r0.. (nr of them) and columns c0.. (nc) of a grid whose
    lattice axes are ax and ax + 1, modulo the torus."""
    n, m = grid.shape[ax], grid.shape[ax + 1]
    return grid.index_select(ax, _ring(r0, nr, n, grid.device)) \
        .index_select(ax + 1, _ring(c0, nc, m, grid.device))


def _put2(grid, r0: int, c0: int, blk, ax: int) -> None:
    """Write blk into the grid at (r0, c0) modulo the torus, in place."""
    n, m = grid.shape[ax], grid.shape[ax + 1]
    ri = _ring(r0, blk.shape[ax], n, grid.device)
    ci = _ring(c0, blk.shape[ax + 1], m, grid.device)
    grid[(slice(None),) * ax + (ri[:, None], ci[None, :])] = blk


def _overlay(win, blk, lr0: int, lc0: int, ax: int):
    """A copy of the window with blk written at local offsets (lr0, lc0),
    modulo the window's own extent."""
    win = win.clone()
    _put2(win, lr0, lc0, blk, ax)
    return win


def _spread(x, lead: tuple):
    """A cached tensor [nc, ...] broadcast over a trial's leading axes
    (nc, ...)."""
    extra = len(lead) - 1
    if extra == 0:
        return x
    return x.reshape(x.shape[0], *(1,) * extra, *x.shape[1:]) \
        .expand(*lead, *x.shape[1:])


def _normalize_nodes(t):
    """Each node divided by its norm, as the contractor normalises, and
    the node log-norms [..., n, m] (detached)."""
    rdt = t.real.dtype if t.is_complex() else t.dtype
    nrm = torch.linalg.vector_norm(t, dim=(-4, -3, -2, -1), keepdim=True)
    nrm = torch.clamp(nrm, min=torch.finfo(rdt).tiny).detach()
    return t / nrm, torch.log(nrm)[..., 0, 0, 0, 0]


def _log_abs(mant, logw):
    rdt = mant.real.dtype if mant.is_complex() else mant.dtype
    return torch.log(torch.clamp(mant.abs(), min=torch.finfo(rdt).tiny)) \
        + logw


# ----------------------------------------------------------------- cache


@dataclasses.dataclass
class PBCCache:
    """The multi-scale contraction of nc configurations.

    stages[s]: the normalised entry grid of stage s in its own frame,
    [nc, n_s, m_s, u, l, d, r]; the last is the [1, 1] grid whose u-d and
    l-r trace is ``mant``. projs[s]: the (pb, pt) projector grids of stage
    s by output node in its pre-transpose frame, None for a "none" stage.
    lnorms[s]: the node log-norms [nc, n_s, m_s] taken when stage s's
    entry was normalised. mant, logw: [nc]. commit_trial updates the
    tensors in place."""
    stages: list
    projs: list
    lnorms: list
    mant: torch.Tensor
    logw: torch.Tensor

    @property
    def log_abs(self) -> torch.Tensor:
        return _log_abs(self.mant, self.logw)


def build_cache(tn: torch.Tensor, chi: int, trunc: TruncParams,
                inv_relative_eps: float = 1e-12,
                test_matrix: TestMatrix | None = None) -> PBCCache:
    """Contract torus networks tn [nc, Ly, Lx, u, l, d, r] (the math of
    :func:`~peps_tpu_torch.contraction.pbc.contract_pbc`) and record every
    stage grid, projector grid and node log-norm."""
    ly, lx = tn.shape[-6], tn.shape[-5]
    if tn.dim() != 7 or not (_pbc_size_ok(ly) and _pbc_size_ok(lx)):
        raise ValueError(f"build_cache: networks [nc, Ly, Lx, u, l, d, r] "
                         f"with sides 2^k or 3*2^k, got {tuple(tn.shape)}")
    g, ln = _normalize_nodes(tn)
    stages, lnorms, projs = [g], [ln], []
    for kind, _, _, _ in stage_plan(ly, lx):
        if kind == "triple":
            mrg = _triple_columns(g)
            out, prj = _truncate_vertical_merged(
                mrg, min(chi, mrg.shape[-4]), trunc, inv_relative_eps,
                test_matrix, return_projs=True)
        elif kind == "pair":
            out, prj = _pair_truncate(g, chi, trunc, inv_relative_eps,
                                      test_matrix, return_projs=True)
        else:
            out, prj = g, None
        out, ln_out = _normalize_nodes(out)
        g = _transpose_frame(out).contiguous()
        stages.append(g)
        lnorms.append(ln_out.transpose(-1, -2).contiguous())
        projs.append(prj)
    mant = torch.einsum("...ulul->...", g[:, 0, 0])
    logw = sum(l.sum((-2, -1)) for l in lnorms)
    return PBCCache(stages, projs, lnorms, mant, logw)


# ----------------------------------------------------------------- trial


class PBCTrial(NamedTuple):
    """A shadow propagation. blocks[s] = (blk, ln_blk, r0, c0): the
    would-be stage-s entry values of the window in the stage-s frame
    (s = 0: the replaced sites, normalised); proj_blocks[s] = (pb, pt,
    or0, oc0) in stage s's pre-transpose output frame for exact trials,
    else None. mant and dln carry the trial's leading axes."""
    mant: torch.Tensor
    dln: torch.Tensor
    blocks: tuple
    proj_blocks: tuple


def begin_trial(cache: PBCCache, blk_raw: torch.Tensor, r0: int, c0: int, *,
                chi: int, trunc: TruncParams, inv_relative_eps: float = 1e-12,
                exact: bool = False,
                test_matrix: TestMatrix | None = None) -> PBCTrial:
    """Shadow-propagate a window replacement through the cached stages.

    blk_raw [nc, ..., wr, wc, u, l, d, r]: the raw (unnormalised) site
    tensors of lattice rows (r0 + i) % Ly and columns (c0 + j) % Lx. The
    unchanged positions must carry the raw tensors the cache was built
    from, so that their log-norms reproduce the cached ones
    (:func:`replace_sites` builds such a block). exact=False reuses the
    cached projectors; exact=True takes fresh ones on the dilated window
    (the test matrix of the fast scheme as in the full contraction)."""
    lead = tuple(blk_raw.shape[:-6])
    ax = len(lead)
    ly, lx = cache.stages[0].shape[1], cache.stages[0].shape[2]
    wps = window_plan(stage_plan(ly, lx), blk_raw.shape[-6],
                      blk_raw.shape[-5], exact)

    blk, ln_blk = _normalize_nodes(blk_raw)
    old = _take2(cache.lnorms[0], r0, blk.shape[-6], c0, blk.shape[-5], 1)
    dln = ln_blk.sum((-2, -1)) - _spread(old.sum((-2, -1)), lead)
    blocks, proj_blocks = [(blk, ln_blk, r0, c0)], []
    for s, wp in enumerate(wps):
        kind, n, m = wp["kind"], wp["n"], wp["m"]
        iwr, owr, owc = wp["iwr"], wp["owr"], wp["owc"]
        prj = None
        if kind == "none":
            out_blk, or0, oc0 = blk, r0, c0
        else:
            g = 2 if kind == "pair" else 3
            oc0 = c0 // g
            ic0 = g * oc0
            if exact:
                or0 = 0 if owr >= n else (r0 - 1) % n
                ir0 = 0 if iwr >= n else (or0 - 1) % n
            else:
                or0 = ir0 = r0
            win = _spread(_take2(cache.stages[s], ir0, iwr, ic0, g * owc, 1),
                          lead)
            win = _overlay(win, blk, (r0 - ir0) % n, (c0 - ic0) % m, ax)
            if exact:
                if kind == "pair":
                    full, (pb, pt) = _pair_truncate(
                        win, chi, trunc, inv_relative_eps, test_matrix,
                        return_projs=True)
                else:
                    mrg = _triple_columns(win)
                    full, (pb, pt) = _truncate_vertical_merged(
                        mrg, min(chi, mrg.shape[-4]), trunc,
                        inv_relative_eps, test_matrix, return_projs=True)
                if iwr >= n:
                    # the window holds the whole ring: slice the out rows
                    lr = (or0 - ir0) % n
                    out_blk, pb, pt = (_take2(x, lr, owr, 0, owc, ax)
                                       for x in (full, pb, pt))
                else:
                    # rows 1..iwr-2 saw their true neighbours
                    out_blk, pb, pt = (x.narrow(ax, 1, owr)
                                       for x in (full, pb, pt))
                prj = (pb, pt, or0, oc0)
            else:
                pb, pt = (_spread(_take2(p, or0, owr, oc0, owc, 1), lead)
                          for p in cache.projs[s])
                if kind == "pair":
                    out_blk = _absorb_pair(pb, win[..., 0::2, :, :, :, :],
                                           win[..., 1::2, :, :, :, :], pt)
                else:
                    out_blk = torch.einsum("...ulDr,...Dc->...ulcr",
                                           _triple_columns(win), pt)
                    out_blk = torch.einsum("...ku,...ulcr->...klcr", pb,
                                           out_blk)
        out_blk, ln_new = _normalize_nodes(out_blk)
        # the cached log-norms of stage s+1 are in the post-transpose frame
        old = _take2(cache.lnorms[s + 1], oc0, out_blk.shape[-5], or0,
                     out_blk.shape[-6], 1)
        dln = dln + ln_new.sum((-2, -1)) - _spread(old.sum((-2, -1)), lead)
        blk = _transpose_frame(out_blk)
        r0, c0 = oc0, or0
        blocks.append((blk, ln_new.transpose(-1, -2), r0, c0))
        proj_blocks.append(prj)
    mant = torch.einsum("...ulul->...", blk[..., 0, 0, :, :, :, :])
    return PBCTrial(mant, dln, tuple(blocks), tuple(proj_blocks))


def trial_log_abs(cache: PBCCache, trial: PBCTrial) -> torch.Tensor:
    """log|psi| of the trial states, over the trial's leading axes."""
    lead = tuple(trial.mant.shape)
    return _log_abs(trial.mant, _spread(cache.logw, lead) + trial.dln)


def select_trial(trial: PBCTrial, index: torch.Tensor) -> PBCTrial:
    """The trial of candidate index[i] of each chain i, from a trial with
    leading axes (nc, K)."""
    rows = torch.arange(index.shape[0], device=index.device)

    def pick(x):
        return x[rows, index]

    blocks = tuple((pick(b), pick(l), r0, c0)
                   for b, l, r0, c0 in trial.blocks)
    projs = tuple(None if p is None else (pick(p[0]), pick(p[1]), p[2], p[3])
                  for p in trial.proj_blocks)
    return PBCTrial(pick(trial.mant), pick(trial.dln), blocks, projs)


def commit_trial(cache: PBCCache, trial: PBCTrial,
                 accept: torch.Tensor | None = None) -> PBCCache:
    """Write the trial's windows into the cache, in place, and return it.
    With accept (bool [nc]) a rejecting chain keeps its cached values: the
    selection runs over the window blocks only, and leaves a rejecting
    chain's cache bit-identical."""
    def keep(new, grid, r0, c0):
        if accept is None:
            return new
        old = _take2(grid, r0, new.shape[1], c0, new.shape[2], 1)
        return torch.where(accept.reshape(-1, *(1,) * (new.dim() - 1)), new,
                           old)

    for s, (blk, ln_blk, r0, c0) in enumerate(trial.blocks):
        blk = keep(blk, cache.stages[s], r0, c0)
        ln_blk = keep(ln_blk, cache.lnorms[s], r0, c0)
        _put2(cache.stages[s], r0, c0, blk, 1)
        _put2(cache.lnorms[s], r0, c0, ln_blk, 1)
    for s, prj in enumerate(trial.proj_blocks):
        if prj is None:
            continue
        pb, pt, or0, oc0 = prj
        pbg, ptg = cache.projs[s]
        pb, pt = keep(pb, pbg, or0, oc0), keep(pt, ptg, or0, oc0)
        _put2(pbg, or0, oc0, pb, 1)
        _put2(ptg, or0, oc0, pt, 1)
    if accept is None:
        cache.mant = trial.mant
        cache.logw = cache.logw + trial.dln
    else:
        cache.mant = torch.where(accept, trial.mant, cache.mant)
        cache.logw = cache.logw + torch.where(accept, trial.dln,
                                              torch.zeros_like(trial.dln))
    return cache


def replace_sites(tps: torch.Tensor, config: torch.Tensor, sites, states,
                  r0: int, c0: int, wr: int, wc: int) -> torch.Tensor:
    """The raw stage-0 block [nc, ..., wr, wc, u, l, d, r] of the window at
    (r0, c0): every position carries tps[y, x, config[:, y, x]], except
    the window-local offsets ``sites`` [(dy, dx), ...], which take
    ``states`` (tensors [nc] or [nc, K]; their shape sets the block's
    leading axes). Unchanged positions are the cache's tensors exactly."""
    ly, lx = tps.shape[0], tps.shape[1]
    ri = _ring(r0, wr, ly, tps.device)
    ci = _ring(c0, wc, lx, tps.device)
    cfg = config.long().index_select(1, ri).index_select(2, ci)
    lead = torch.broadcast_shapes(*(s.shape for s in states))
    cfg = cfg.reshape(cfg.shape[0], *(1,) * (len(lead) - 1), wr, wc) \
        .expand(*lead, wr, wc).clone()
    for (dy, dx), st in zip(sites, states):
        cfg[..., dy, dx] = st
    return tps[ri[:, None], ci[None, :], cfg]


def evaluate_replacement(cache: PBCCache, blk_raw, r0: int, c0: int, *,
                         chi: int, trunc: TruncParams,
                         inv_relative_eps: float = 1e-12,
                         exact: bool = False,
                         test_matrix: TestMatrix | None = None):
    """The trial amplitude without touching the cache: (mantissa,
    log_weight)."""
    t = begin_trial(cache, blk_raw, r0, c0, chi=chi, trunc=trunc,
                    inv_relative_eps=inv_relative_eps, exact=exact,
                    test_matrix=test_matrix)
    return t.mant, _spread(cache.logw, tuple(t.mant.shape)) + t.dln
