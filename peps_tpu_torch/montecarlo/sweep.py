"""Monte Carlo sweep with environment reuse (port of
``peps_tpu/montecarlo/sweep.py``).

Same schedule as the reference: bottom stack from the pre-sweep network (or
passed in), top boundary grown row by row with the updated rows, per-row
right BTens and right candidate blocks, and a sequential left-to-right bond
scan whose accepted candidate slice is the next left env. A sweep is the
horizontal pass then the vertical pass on the transposed lattice. The chain
axis is a leading batch dimension; rows and bonds are Python loops.

Random numbers: one uniform per bond per frame, ``u_h [nc, Ly, Lx-1]`` and
``u_v [nc, Lx, Ly-1]``, either passed in (the parity tests replay the
reference's key splits) or drawn from a ``torch.Generator`` in one call per
sweep. Both update rules of the reference take that one uniform per bond:
"exchange" (swap the two values if they differ, Metropolis accept) and
"suwa_todo" (a rejection-free pick over all d^2 values of the bond,
optionally masked by a conservation table). An optional Jastrow dress
(:class:`~peps_tpu_torch.montecarlo.jastrow.JastrowDress`) multiplies every
amplitude table by its ratio factors, from a field carried along the scan.

:func:`mc_sweep_3site` is the reference's permutation sweep over every
horizontal and vertical 3-site window: a Suwa-Todo pick among the six
orderings of the window's sorted value triple (repeats weighted zero),
one uniform per window (``u_h [nc, Ly, Lx-2]``, ``u_v [nc, Lx, Ly-2]``).
Its window table is three K1 transfers per window, each batched over
[chains, 6 candidates].
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.kernels.col_transfer import col_transfer, \
    col_transfer_right
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.jastrow import pair_log_ratios
from peps_tpu_torch.montecarlo.suwa_todo import suwa_todo_pick
from peps_tpu_torch.tps import project

# the six orderings of a 3-site window's sorted values
_PERMS3 = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """mode: "exchange" or "suwa_todo". conserve_mask: optional [d*d, d*d]
    0/1 table (nested tuples, hashable) of the allowed (current pair ->
    new pair) transitions, applied in suwa_todo mode."""
    mode: str = "exchange"
    conserve_mask: tuple | None = None

    def __post_init__(self):
        if self.mode not in ("exchange", "suwa_todo"):
            raise ValueError(f"update rule {self.mode!r}: expected "
                             "'exchange' or 'suwa_todo'")

    def mask_array(self, d: int, dtype, device) -> torch.Tensor | None:
        if self.conserve_mask is None:
            return None
        return torch.as_tensor(self.conserve_mask, dtype=dtype,
                               device=device).reshape(d * d, d * d)


class SweepStats(NamedTuple):
    accepted: torch.Tensor
    trials: torch.Tensor


def _project_row(tps_row: torch.Tensor, cfg_row: torch.Tensor) -> torch.Tensor:
    """tps_row [Lx, d, u, l, d, r], cfg_row [..., Lx] -> [..., Lx, u, l, d, r]."""
    xs = torch.arange(tps_row.shape[0], device=tps_row.device)
    return tps_row[xs, cfg_row.long()]


def _right_btens(top, bot, row):
    """Right BTens [..., Lx+1, chi, D, chi] of a row sandwich (normalized)."""
    lx, chi, dv = top.shape[-4], top.shape[-3], row.shape[-3]
    batch = torch.broadcast_shapes(top.shape[:-4], row.shape[:-5])
    env = bmps._unit_env(chi, dv, row.dtype, row.device, batch)
    rs = [env]
    for x in range(lx - 1, -1, -1):
        env, _ = bmps._normalize(col_transfer_right(
            env, top[..., x, :, :, :], row[..., x, :, :, :, :],
            bot[..., x, :, :, :]), 3)
        rs.append(env)
    return torch.stack(rs[::-1], dim=-4)


def _right_blocks(rights, top, bot, cands):
    """rblk[..., x, j, a, l, c] = right transfer of rights[x+2] through
    top[x+1], cands[x+1, j], bot[x+1]; batched over (bond, candidate)."""
    return col_transfer_right(rights[..., 2:, None, :, :, :],
                              top[..., 1:, None, :, :, :], cands[1:],
                              bot[..., 1:, None, :, :, :])


def draw_uniforms(generator: torch.Generator, nc: int, ly: int, lx: int,
                  dtype, device, window: int = 2):
    """One sweep's uniforms from one generator call, one per window of
    ``window`` sites: (u_h [nc, Ly, Lx-window+1], u_v [nc, Lx,
    Ly-window+1]); window 2 for :func:`mc_sweep`, 3 for
    :func:`mc_sweep_3site`."""
    wh, wv = max(lx - window + 1, 0), max(ly - window + 1, 0)
    nh, nv = ly * wh, lx * wv
    u = torch.rand(nc, nh + nv, generator=generator, dtype=dtype,
                   device=device)
    return u[:, :nh].reshape(nc, ly, wh), u[:, nh:].reshape(nc, lx, wv)


def _bottom_stack(tps, config, chi, trunc):
    """bots[:, y] closes rows y..Ly-1 of the pre-sweep network."""
    ftops, _ = bmps.all_top_envs(bmps.flip_vertical(project(tps, config)),
                                 chi, trunc)
    return torch.flip(ftops, [-5])


def _sweep_rows(tps, config, uniforms, chi, trunc: TruncParams,
                rule: UpdateRule = UpdateRule(), bots=None, dress=None):
    """One pass over all horizontal bonds of every chain.

    tps [Ly, Lx, d, ...]; config [nc, Ly, Lx]; uniforms [nc, Ly, Lx-1];
    bots: optional bottom stack [nc, Ly+1, Lx, chi, D, chi] of the pre-sweep
    network; dress: optional JastrowDress of this frame, its field carried
    along the scan. Returns (config', SweepStats) with device-side counts."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    nc = config.shape[0]
    dtype, dev = tps.dtype, tps.device
    rdt = tps.real.dtype if tps.is_complex() else dtype
    tiny = torch.finfo(rdt).tiny
    config = config.long()
    if bots is None:
        bots = _bottom_stack(tps, config, chi, trunc)
    if dress is not None:
        field = dress.field(config)
    chains = torch.arange(nc, device=dev)
    cmask = rule.mask_array(d, rdt, dev)
    top = bmps.init_boundary(lx, chi, tps.shape[3], dtype, dev, (nc,))
    l0 = bmps._unit_env(chi, tps.shape[3], dtype, dev, (nc,))
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    tri = torch.zeros((), dtype=torch.int64, device=dev)
    new_rows = []
    for y in range(ly):
        bot = bots[:, y + 1]
        cfg_row = config[:, y]
        rights = _right_btens(top, bot, _project_row(tps[y], cfg_row))
        rblks = _right_blocks(rights, top, bot, tps[y])
        lenv, c_cur = l0, cfg_row[:, 0]
        heads = []
        for x in range(lx - 1):
            # left chain over all d first-site candidates (K1, batch [nc, d])
            h1 = col_transfer(lenv[:, None], top[:, x, None], tps[y, x],
                              bot[:, x, None])
            table = torch.einsum("nkABC,njABC->nkj", h1, rblks[:, x])
            c2 = cfg_row[:, x + 1]
            i1 = y * lx + x
            if dress is not None:
                nv = dress.nvals
                table = table * torch.exp(pair_log_ratios(
                    nv, nv[c_cur][:, None, None], nv[c2][:, None, None],
                    field[:, i1, None, None], field[:, i1 + 1, None, None],
                    dress.v[i1, i1 + 1])).to(table.dtype)
            if rule.mode == "exchange":
                psi_cur = table[chains, c_cur, c2]
                psi_new = table[chains, c2, c_cur]
                ratio2 = psi_new.abs() ** 2 / torch.clamp(psi_cur.abs() ** 2,
                                                          min=tiny)
                differ = c_cur != c2
                accept = differ & (uniforms[:, y, x] < ratio2)
                new1 = torch.where(accept, c2, c_cur)
                new2 = torch.where(accept, c_cur, c2)
                acc = acc + accept.sum()
                tri = tri + differ.sum()
            else:
                cur_idx = c_cur * d + c2
                w = table.reshape(nc, d * d).abs() ** 2
                if cmask is not None:
                    w = w * cmask[cur_idx]
                new_idx = suwa_todo_pick(w, cur_idx, uniforms[:, y, x])
                new1, new2 = new_idx // d, new_idx % d
                acc = acc + (new_idx != cur_idx).sum()
                tri = tri + nc
            if dress is not None:
                field = field \
                    + (nv[new1] - nv[c_cur])[:, None] * dress.v[:, i1] \
                    + (nv[new2] - nv[c2])[:, None] * dress.v[:, i1 + 1]
            lenv, _ = bmps._normalize(h1[chains, new1], 3)
            heads.append(new1)
            c_cur = new2
        new_row = torch.stack(heads + [c_cur], dim=1)
        new_rows.append(new_row)
        top = bmps.absorb_row(top, _project_row(tps[y], new_row), chi,
                              trunc).bmps
    return torch.stack(new_rows, dim=1), SweepStats(acc, tri)


def _transpose_dress(dress, ly: int, lx: int):
    """The dress of the transposed lattice: v with its site order
    transposed."""
    if dress is None:
        return None
    perm = torch.arange(ly * lx, device=dress.v.device) \
        .reshape(ly, lx).T.reshape(-1)
    return type(dress)(dress.v[perm][:, perm], dress.nvals)


def _sweep_uniforms(uniforms, generator, tps, nc, ly, lx, window):
    if uniforms is not None:
        return uniforms
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    return draw_uniforms(generator, nc, ly, lx, rdt, tps.device, window)


def mc_sweep(tps, tps_t, config, chi, trunc: TruncParams, uniforms=None,
             generator: torch.Generator | None = None, bots=None,
             rule: UpdateRule = UpdateRule(), dress=None):
    """One full sweep of every chain: horizontal bonds, then vertical bonds
    on the transposed lattice (tps_t = transpose_tps(tps)).

    config [nc, Ly, Lx]; uniforms (u_h, u_v) or None to draw them from
    ``generator``; bots: optional bottom stack of the pre-sweep network;
    dress: optional JastrowDress multiplied into every amplitude table.
    Returns (config' [nc, Ly, Lx] int64, SweepStats)."""
    ly, lx = config.shape[-2:]
    u_h, u_v = _sweep_uniforms(uniforms, generator, tps, config.shape[0], ly,
                               lx, 2)
    config, st_h = _sweep_rows(tps, config, u_h, chi, trunc, rule, bots,
                               dress)
    cfg_t, st_v = _sweep_rows(tps_t, config.transpose(1, 2), u_v, chi, trunc,
                              rule, dress=_transpose_dress(dress, ly, lx))
    return cfg_t.transpose(1, 2).contiguous(), SweepStats(
        st_h.accepted + st_v.accepted, st_h.trials + st_v.trials)


def _window_candidates(vals, perms):
    """The six orderings [nc, 6, 3] of each chain's sorted value triple
    vals [nc, 3], a mask [nc, 6] of orderings that repeat an earlier one,
    and the index [nc] of the current ordering (its first occurrence)."""
    cand = torch.sort(vals, dim=-1).values[:, perms]
    same = (cand[:, :, None, :] == cand[:, None, :, :]).all(-1)
    dup = torch.tril(same, diagonal=-1).any(-1)
    cur = (cand == vals[:, None, :]).all(-1) & ~dup
    return cand, dup, torch.argmax(cur.to(torch.int8), dim=-1)


def _sweep_rows_3site(tps, config, uniforms, chi, trunc: TruncParams):
    """One pass of Suwa-Todo permutation updates over every horizontal
    3-site window of every chain; uniforms [nc, Ly, Lx-2]. Returns
    (config', SweepStats)."""
    ly, lx = tps.shape[0], tps.shape[1]
    nc = config.shape[0]
    dev = tps.device
    config = config.long()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    tri = torch.zeros((), dtype=torch.int64, device=dev)
    if lx < 3:
        return config, SweepStats(acc, tri)
    bots = _bottom_stack(tps, config, chi, trunc)
    perms = torch.as_tensor(_PERMS3, device=dev)
    chains = torch.arange(nc, device=dev)
    top = bmps.init_boundary(lx, chi, tps.shape[3], tps.dtype, dev, (nc,))
    l0 = bmps._unit_env(chi, tps.shape[3], tps.dtype, dev, (nc,))
    new_rows = []
    for y in range(ly):
        bot = bots[:, y + 1]
        cfg_row = config[:, y]
        rights = _right_btens(top, bot, _project_row(tps[y], cfg_row))
        lenv, v2, v3 = l0, cfg_row[:, 0], cfg_row[:, 1]
        heads = []
        for x in range(lx - 2):
            vals = torch.stack([v2, v3, cfg_row[:, x + 2]], dim=-1)
            cand, dup, cur_idx = _window_candidates(vals, perms)
            # the window table: the candidates' three transfers, each
            # normalized with its log kept (K1, batch [nc, 6])
            env = lenv[:, None]
            logw = 0.0
            for i in range(3):
                env, n = bmps._normalize(col_transfer(
                    env, top[:, x + i, None], tps[y, x + i][cand[:, :, i]],
                    bot[:, x + i, None]), 3)
                logw = logw + torch.log(n)
                if i == 0:
                    firsts = env
            amps = torch.einsum("nkalc,nalc->nk", env, rights[:, x + 3])
            amps = amps * torch.exp(logw - logw.amax(-1, keepdim=True))
            w = amps.abs() ** 2 * (~dup).to(amps.real.dtype)
            new_idx = suwa_todo_pick(w, cur_idx, uniforms[:, y, x])
            new_vals = cand[chains, new_idx]
            acc = acc + (new_idx != cur_idx).sum()
            tri = tri + nc
            # the accepted first site's transfer is the candidate's first
            lenv = firsts[chains, new_idx]
            heads.append(new_vals[:, 0])
            v2, v3 = new_vals[:, 1], new_vals[:, 2]
        new_row = torch.stack(heads + [v2, v3], dim=1)
        new_rows.append(new_row)
        top = bmps.absorb_row(top, _project_row(tps[y], new_row), chi,
                              trunc).bmps
    return torch.stack(new_rows, dim=1), SweepStats(acc, tri)


def mc_sweep_3site(tps, tps_t, config, chi, trunc: TruncParams,
                   uniforms=None, generator: torch.Generator | None = None):
    """One full 3-site permutation sweep of every chain: horizontal
    windows, then vertical ones on the transposed lattice. A permutation
    keeps every chain's value counts. uniforms (u_h [nc, Ly, Lx-2], u_v
    [nc, Lx, Ly-2]) or None to draw them from ``generator``. Returns
    (config' [nc, Ly, Lx] int64, SweepStats)."""
    ly, lx = config.shape[-2:]
    u_h, u_v = _sweep_uniforms(uniforms, generator, tps, config.shape[0], ly,
                               lx, 3)
    config, st_h = _sweep_rows_3site(tps, config, u_h, chi, trunc)
    cfg_t, st_v = _sweep_rows_3site(tps_t, config.transpose(1, 2), u_v, chi,
                                    trunc)
    return cfg_t.transpose(1, 2).contiguous(), SweepStats(
        st_h.accepted + st_v.accepted, st_h.trials + st_v.trials)
