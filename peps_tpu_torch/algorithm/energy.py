"""Local energy and gradient holes (port of the bosonic part of
``peps_tpu/algorithm/energy.py``).

Full amplitude-ratio tables per bond from shared row environments,
contracted against the model's coupling tensors, on the reference's routes:
horizontal NN bonds and one-site terms from single-row sandwiches
(``_row_pass``); vertical NN bonds through the transposed frame
(``_bond_pass``) when they are the only two-row term, else from the
two-row (BTen2) sandwiches of ``_pair_pass`` with the diagonal,
anti-diagonal and sqrt5 terms; in-row third neighbours from
``_tnn_row_pass``; the second sqrt5 family and in-column third neighbours
in the transposed frame.

Every two-row transfer goes through kernel K3
(:mod:`peps_tpu_torch.kernels.pair_transfer`) on the two rows as they are;
the reference's column-fused site (``_fuse_pair_columns``), a TPU layout
choice, is not formed. Every function is batched over a leading chain
axis: config [nc, Ly, Lx].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.kernels.pair_transfer import (pair_transfer,
                                                  pair_transfer_right)
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project


class ModelTensors(NamedTuple):
    """Dense couplings h[p1', p2', p1, p2] (any may be None), as tensors."""
    h_h: torch.Tensor | None
    h_v: torch.Tensor | None
    h_d: torch.Tensor | None
    h_ad: torch.Tensor | None
    h_site: torch.Tensor | None
    h_s5a: torch.Tensor | None = None
    h_s5b: torch.Tensor | None = None
    h_tnn_h: torch.Tensor | None = None
    h_tnn_v: torch.Tensor | None = None

    @classmethod
    def from_model(cls, model, dtype, device=None):
        device = resolve_device(device)
        def conv(name):
            m = getattr(model, name, None)
            return None if m is None else torch.as_tensor(
                np.array(m), dtype=dtype, device=device)
        return cls(*(conv(f) for f in cls._fields))


def bosonic_model_tensors(model, dtype, device, entry: str) -> ModelTensors:
    """ModelTensors of a bosonic square-lattice model (passed through when
    it already is one); anything else is a fermionic model, which the port
    takes with ROADMAP queue 1, item 10."""
    if isinstance(model, ModelTensors):
        return model
    if not hasattr(model, "h_h"):
        raise NotImplementedError(
            f"{entry} of a {type(model).__name__}: fermionic models come "
            "with ROADMAP queue 1, item 10")
    return ModelTensors.from_model(model, dtype, device)


class EnergyHoles(NamedTuple):
    e_loc: torch.Tensor                # [nc]
    o_tensor: torch.Tensor | None      # [nc, Ly, Lx, d, D, D, D, D]
    log_abs_psi: torch.Tensor          # [nc]
    psi_mant: torch.Tensor             # [nc]


class _RowPass(NamedTuple):
    bond_e: torch.Tensor     # [nc]
    ratio1: torch.Tensor     # [nc, Ly, Lx, d]
    holes: torch.Tensor      # [nc, Ly, Lx, u, l, d, r]
    psi_loc: torch.Tensor    # [nc, Ly, Lx]


def _safe(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _table_energy(table, cp, cq, h):
    """sum over bonds of h[cp, cq, :, :] * table / table[cp, cq]; table
    [nc, ..., d, d] with the bonds' configurations cp, cq [nc, ...] -> [nc]."""
    psi_b = table.take_along_dim(cp[..., None, None], -2) \
        .take_along_dim(cq[..., None, None], -1)[..., 0, 0]
    ratios = table / _safe(psi_b)[..., None, None]
    return (h[cp, cq] * ratios).flatten(1).sum(1)


def _row_pass(tps, tn, config, h_bond, stacks) -> _RowPass:
    """Single-row machinery over all chains and rows at once: horizontal
    bond energies, one-site ratio tables, holes and local psi."""
    ly, lx = tps.shape[0], tps.shape[1]
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, tn)
    holes = bmps.punch_holes_row(envs, tops, bots)
    psi_loc = torch.einsum("...uldr,...uldr->...", holes, tn)
    ones = torch.einsum("nyxuldr,yxpuldr->nyxp", holes, tps)
    ratio1 = ones / _safe(psi_loc)[..., None]
    bond_e = torch.zeros_like(psi_loc[:, 0, 0])
    if h_bond is not None:
        nn = bmps.replace_nn_site_traces(envs, tops, bots, tps[:, :lx - 1],
                                         tps[:, 1:])
        bond_e = _table_energy(nn, config[..., :-1], config[..., 1:], h_bond)
    return _RowPass(bond_e, ratio1, holes, psi_loc)


def _bond_pass(tps, tn, config, h_bond, stacks):
    """In-row NN bond energies only (the transposed-frame vertical bonds)."""
    ly, lx = tps.shape[0], tps.shape[1]
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, tn)
    nn = bmps.replace_nn_site_traces(envs, tops, bots, tps[:, :lx - 1],
                                     tps[:, 1:])
    return _table_energy(nn, config[..., :-1], config[..., 1:], h_bond)


def _tnn_row_pass(tps, tn, config, h_tnn, stacks):
    """Third-neighbour in-row bond energies ((y,x)-(y,x+2)) from single-row
    sandwiches."""
    ly, lx = tps.shape[0], tps.shape[1]
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, tn)
    tnn = bmps.replace_tnn_site_traces(envs, tops, bots, tps[:, :lx - 2],
                                       tn[:, :, 1:lx - 1], tps[:, 2:])
    return _table_energy(tnn, config[..., :-2], config[..., 2:], h_tnn)


def _pair_row_envs(top, bot, row1, row2, with_logs: bool = False):
    """Left/right two-row environments (BTen2) of the sandwiches top
    [..., Lx, chi, D, chi], row1/row2 [..., Lx, u, l, d, r] (row2's u-leg
    contracts row1's d-leg), bot [..., Lx, chi, D, chi]. Axes of an env:
    (a = top bond, m = row1's l-leg, n = row2's l-leg, c = bot bond).
    Returns (lefts, rights), each [..., Lx+1, chi, D, D, chi]; with_logs
    appends the cumulative logs of the per-step norms (log_lefts,
    log_rights [..., Lx+1]). Every step is one K3 launch."""
    lx, chi = top.shape[-4], top.shape[-3]
    dv = row1.shape[-3]
    batch = torch.broadcast_shapes(top.shape[:-4], bot.shape[:-4],
                                   row1.shape[:-5], row2.shape[:-5])
    rdt = row1.real.dtype if row1.is_complex() else row1.dtype
    init = torch.zeros(*batch, chi, dv, dv, chi, dtype=row1.dtype,
                       device=row1.device)
    init[..., 0, 0, 0, 0] = 1.0
    zero = torch.zeros(batch, dtype=rdt, device=row1.device)

    def scan(step, xs):
        env, logw = init, zero
        envs, logs = [], []
        for x in xs:
            env, n = bmps._normalize(step(
                env, top[..., x, :, :, :], row1[..., x, :, :, :, :],
                row2[..., x, :, :, :, :], bot[..., x, :, :, :]), 4)
            logw = logw + torch.log(n)
            envs.append(env)
            logs.append(logw)
        return envs, logs

    ls, log_ls = scan(pair_transfer, range(lx))
    rs, log_rs = scan(pair_transfer_right, range(lx - 1, -1, -1))
    lefts = torch.stack([init] + ls, dim=-5)
    rights = torch.stack(rs[::-1] + [init], dim=-5)
    if with_logs:
        return (lefts, rights, torch.stack([zero] + log_ls, dim=-1),
                torch.stack(log_rs[::-1] + [zero], dim=-1))
    return lefts, rights


def _vertical_pair_table(lefts, rights, top, bot, cands1, cands2):
    """Vertical-pair amplitude tables [..., Lx, d, d] through the two-row
    hole of each column: the (c, A) contraction (K = chi^2) gives the
    column's environment, then both candidate substitutions. Grouped as
    the reference groups them."""
    lx = top.shape[-4]
    dv = lefts.shape[-3]
    lf = lefts[..., :lx, :, :, :, :].flatten(-3, -2)
    rt = rights[..., 1:, :, :, :, :].flatten(-3, -2)
    t1 = torch.einsum("...xaMc,...xauA->...xucMA", lf, top)
    t2 = torch.einsum("...xceC,...xARC->...xecAR", bot, rt)
    hole2 = torch.einsum("...xucMA,...xecAR->...xueMR", t1, t2)
    h6 = hole2.reshape(*hole2.shape[:-2], dv, dv, dv, dv)   # x,u,e,m,n,r,f
    t3 = torch.einsum("...xuemnrf,...xpumdr->...xpnefd", h6, cands1)
    return torch.einsum("...xpnefd,...xqdnef->...xpq", t3, cands2)


def _pair_pass(tps, tn, config, h_v, h_d, h_ad, stacks, h_s5=None):
    """Vertical, diagonal, anti-diagonal and sqrt5 ((y+1,x)-(y,x+2)) bond
    energies [nc] from the two-row sandwiches of every row pair (y, y+1),
    batched over chains and row pairs. Every lblk/rblk and middle-column
    chain is one K3 launch with a candidate batch axis; the closures are
    products of the two blocks."""
    ly, lx = tps.shape[0], tps.shape[1]
    top, bot = stacks.tops[:, :ly - 1], stacks.bots[:, 2:]
    row1, row2 = tn[:, :ly - 1], tn[:, 1:]
    cands1, cands2 = tps[:ly - 1], tps[1:]       # [Ly-1, Lx, d, D, D, D, D]
    c1, c2 = config[:, :ly - 1], config[:, 1:]
    lefts, rights = _pair_row_envs(top, bot, row1, row2)
    e = torch.zeros(config.shape[0], dtype=lefts.real.dtype,
                    device=lefts.device)

    def cols(t, a, b, nd):
        """Columns a..b-1 of t (trailing nd dims each), with a candidate
        axis of size 1 after the column axis."""
        return t[(..., slice(a, b)) + (slice(None),) * nd].unsqueeze(-nd - 1)

    def side(a, b):   # top, row1, row2, bot of columns a..b-1
        return (cols(top, a, b, 3), cols(row1, a, b, 4), cols(row2, a, b, 4),
                cols(bot, a, b, 3))

    def closure(l, r):
        return torch.einsum("...pABCE,...qABCE->...pq", l, r)

    if h_v is not None:
        table = _vertical_pair_table(lefts, rights, top, bot, cands1, cands2)
        e = e + _table_energy(table, c1, c2, h_v)

    nb = lx - 1
    if nb > 0 and (h_d is not None or h_ad is not None):
        env_l, env_r = cols(lefts, 0, nb, 4), cols(rights, 2, lx + 1, 4)
        tl, r1l, r2l, bl = side(0, nb)
        tr, r1r, r2r, br = side(1, lx)
        if h_d is not None:     # row1 @ x (p) and row2 @ x+1 (q) replaced
            lblk = pair_transfer(env_l, tl, cands1[:, :nb], r2l, bl)
            rblk = pair_transfer_right(env_r, tr, r1r, cands2[:, 1:], br)
            e = e + _table_energy(closure(lblk, rblk), c1[..., :nb],
                                  c2[..., 1:], h_d)
        if h_ad is not None:    # row2 @ x (q) and row1 @ x+1 (p) replaced
            lblk = pair_transfer(env_l, tl, r1l, cands2[:, :nb], bl)
            rblk = pair_transfer_right(env_r, tr, cands1[:, 1:], r2r, br)
            e = e + _table_energy(closure(lblk, rblk), c2[..., :nb],
                                  c1[..., 1:], h_ad)

    nb2 = lx - 2
    if nb2 > 0 and h_s5 is not None:
        # lower-left (row2 @ x, q) with upper-right (row1 @ x+2, p); the
        # middle column x+1 unchanged
        tl, r1l, _, bl = side(0, nb2)
        lblk = pair_transfer(cols(lefts, 0, nb2, 4), tl, r1l,
                             cands2[:, :nb2], bl)
        lblk = pair_transfer(lblk, *side(1, nb2 + 1))
        tr, _, r2r, br = side(2, lx)
        rblk = pair_transfer_right(cols(rights, 3, lx + 1, 4), tr,
                                   cands1[:, 2:], r2r, br)
        e = e + _table_energy(closure(lblk, rblk), c2[..., :nb2],
                              c1[..., 2:], h_s5)
    return e


def o_tensor_of(holes, psi_loc, config, d):
    """O = d ln psi / dA: holes / psi scattered by the one-hot config,
    [nc, Ly, Lx, d, D, D, D, D] (the reference's O build, energy.py:112-116)."""
    sel = torch.nn.functional.one_hot(config, d).to(holes.dtype)
    return (holes / _safe(psi_loc)[..., None, None, None, None])[:, :, :, None] \
        * sel[..., None, None, None, None]


def _only_v(model: ModelTensors) -> bool:
    """Vertical NN bonds are the only two-row term of the normal frame: they
    take the transposed frame's single-row pass (the reference's route)."""
    return model.h_v is not None and model.h_d is None \
        and model.h_ad is None and model.h_s5a is None


def needs_transposed_frame(model: ModelTensors) -> bool:
    """Whether the local energy of model reads the transposed frame's env
    stacks (stacks_t of :func:`_local_energy`)."""
    return _only_v(model) or model.h_s5b is not None \
        or model.h_tnn_v is not None


def _local_energy(tps, config, model: ModelTensors, chi: int,
                  trunc: TruncParams, stacks=None, stacks_t=None):
    """(e_loc [nc], _RowPass, log_abs_psi [nc], mant [nc]) for config
    [nc, Ly, Lx]. stacks / stacks_t: optional env stacks of these
    configurations in the normal / transposed frame (the latter is read
    only where :func:`needs_transposed_frame` says so), so that a caller
    shares them with other passes over the same configurations."""
    ly = tps.shape[0]
    config = config.long()
    tn = project(tps, config)
    if stacks is None:
        stacks = bmps.all_env_stacks(tn, chi, trunc)
    rp = _row_pass(tps, tn, config, model.h_h, stacks)
    e = rp.bond_e
    if model.h_site is not None:
        e = e + (model.h_site[config] * rp.ratio1).sum(dim=(1, 2, 3))
    if needs_transposed_frame(model):
        tps_t = transpose_tps(tps)
        cfg_t = config.transpose(1, 2)
        tn_t = project(tps_t, cfg_t)
        if stacks_t is None:
            stacks_t = bmps.all_env_stacks(tn_t, chi, trunc)
    if _only_v(model):
        e = e + _bond_pass(tps_t, tn_t, cfg_t, model.h_v, stacks_t)
    elif any(h is not None for h in (model.h_v, model.h_d, model.h_ad,
                                     model.h_s5a)):
        e = e + _pair_pass(tps, tn, config, model.h_v, model.h_d, model.h_ad,
                           stacks, h_s5=model.h_s5a)
    if model.h_tnn_h is not None:
        e = e + _tnn_row_pass(tps, tn, config, model.h_tnn_h, stacks)
    # the second sqrt5 family ((y+2,x)-(y,x+1)) and in-column third
    # neighbours are the first family and in-row third neighbours of the
    # transposed frame; there h_s5b's (site1, site2) order swaps
    if model.h_s5b is not None:
        e = e + _pair_pass(tps_t, tn_t, cfg_t, None, None, None, stacks_t,
                           h_s5=model.h_s5b.permute(1, 0, 3, 2))
    if model.h_tnn_v is not None:
        e = e + _tnn_row_pass(tps_t, tn_t, cfg_t, model.h_tnn_v, stacks_t)
    mant = bmps.close_boundary(stacks.tops[:, ly])
    rdt = tn.real.dtype if tn.is_complex() else tn.dtype
    log_abs = torch.log(torch.clamp(mant.abs(), min=torch.finfo(rdt).tiny)) \
        + stacks.log_tops[:, ly]
    return e, rp, log_abs, mant


def local_energy_and_holes(tps, config, model: ModelTensors, chi: int,
                           trunc: TruncParams,
                           with_holes: bool = True) -> EnergyHoles:
    """E_loc and O = d ln psi / dA for every chain of config [nc, Ly, Lx]."""
    e, rp, log_abs, mant = _local_energy(tps, config, model, chi, trunc)
    o = o_tensor_of(rp.holes, rp.psi_loc, config.long(), tps.shape[2]) \
        if with_holes else None
    return EnergyHoles(e, o, log_abs, mant)
