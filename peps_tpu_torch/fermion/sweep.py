"""Environment-shared MC sweep of graded fermionic states (port of
``peps_tpu/fermion/sweep.py``), batched over chains.

The bosonic sweep's schedule (one boundary descent, O(1) contractions a
bond) on the dressed projection, exchange moves only (they keep every
occupation number). An exchange changes the snake prefix parity only on
the interval between its two sites:

* Horizontal bonds are snake-adjacent. A row scan in snake direction
  carries a flag g, the prefix flip at the current site from the row's
  finalized sites; ONE normal right-env stack closes every proposal.
* Vertical bonds (y,x)-(y+1,x): the interval is one full side of the
  two-row window. The scan carries one pending flag g (each accepted
  exchange toggles it); the right stacks are the two-row envs of the
  normal and the prefix-flipped row pair, with their logs.

Odd snake rows are reflected in x (the R->L frame onto the L->R scan) and
reflected back. The horizontal transfers are K1 launches; the vertical
pass runs on the two rows as they are, every transfer a K3 launch (the
reference's column-fused two-row site is not formed). The candidates and
the flipped rows come from K4, for the rows a step reads.

Random numbers: one uniform per bond, ``u_h [nc, Ly, Lx-1]`` indexed by the
row and the kernel position (the reflected frame's x on odd rows) and
``u_v [nc, Lx, Ly-1]`` indexed by the kernel position and the pair, the
bosonic sweep's shapes; the parity tests replay the reference's per-bond
keys into them.
"""
from __future__ import annotations

import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.fermion.convert import fermion_project
from peps_tpu_torch.fermion.tables import fermion_candidates
from peps_tpu_torch.kernels.col_transfer import (col_transfer,
                                                 col_transfer_right)
from peps_tpu_torch.kernels.pair_transfer import (pair_transfer,
                                                  pair_transfer_right)
from peps_tpu_torch.montecarlo.sweep import SweepStats, draw_uniforms


def _refl_site(c):
    """Reflect site / candidate tensors [nc, Lx, ..., u, l, d, r] in x and
    swap their l and r legs."""
    return torch.flip(c.transpose(-3, -1), [1])


def _refl_bmps(b):
    """Reflect boundary MPSs [nc, Lx, a, v, b] in x."""
    return torch.flip(b, [1]).transpose(-3, -1)


def _right_btens(top, bot, row):
    """Right single-row BTens [nc, Lx+1, chi, D, chi] of the sandwiches
    (top, row, bot), normalized each step (K1, right form)."""
    lx, chi, dv = top.shape[1], top.shape[2], row.shape[-3]
    env = bmps._unit_env(chi, dv, row.dtype, row.device, (row.shape[0],))
    rs = [env]
    for x in range(lx - 1, -1, -1):
        env, _ = bmps._normalize(col_transfer_right(
            env, top[:, x], row[:, x], bot[:, x]), 3)
        rs.append(env)
    return torch.stack(rs[::-1], dim=1)


def _pair_rights(top, bot, row1, row2):
    """Right two-row envs [nc, Lx+1, chi, D, D, chi] and their cumulative
    log norms [nc, Lx+1] (K3, right form)."""
    nc, lx, chi = top.shape[0], top.shape[1], top.shape[2]
    dv = row1.shape[-3]
    rdt = row1.real.dtype if row1.is_complex() else row1.dtype
    env = torch.zeros(nc, chi, dv, dv, chi, dtype=row1.dtype,
                      device=row1.device)
    env[:, 0, 0, 0, 0] = 1.0
    logw = torch.zeros(nc, dtype=rdt, device=row1.device)
    rs, logs = [env], [logw]
    for x in range(lx - 1, -1, -1):
        env, n = bmps._normalize(pair_transfer_right(
            env, top[:, x], row1[:, x], row2[:, x], bot[:, x]), 4)
        logw = logw + torch.log(n)
        rs.append(env)
        logs.append(logw)
    return torch.stack(rs[::-1], dim=1), torch.stack(logs[::-1], dim=1)


def _ratio2(psi, rdt):
    """|psi_new|^2 / max(|psi_cur|^2, tiny) of psi [nc, 2] (cur, new)."""
    a2 = psi.abs() ** 2
    return a2[:, 1] / torch.clamp(a2[:, 0], min=torch.finfo(rdt).tiny)


def _h_row(top, bot, cands, cfg0, pi_d, u, chi, trunc, jrow=None):
    """One snake-direction (L->R frame) pass over the horizontal bonds of
    one row of every chain. top/bot [nc, Lx, chi, D, chi]; cands
    [nc, Lx, d, 2, u,l,d,r] against the current configurations; cfg0
    [nc, Lx] the row at pass start; u [nc, Lx-1]; jrow: optional Jastrow
    (nvals [d], field [nc, Lx] at the row's sites, vrow [Lx, Lx]), in
    kernel position order. Returns (new row [nc, Lx], new top, accepted
    [nc], trials [nc])."""
    nc, lx = cfg0.shape
    rdt = cands.real.dtype if cands.is_complex() else cands.dtype
    ar = torch.arange(nc, device=cfg0.device)
    xs = torch.arange(lx, device=cfg0.device)
    row_n = cands[ar[:, None], xs[None, :], cfg0, 0]
    rights = _right_btens(top, bot, row_n)
    pi0 = pi_d[cfg0]
    lenv = bmps._unit_env(chi, row_n.shape[-3], row_n.dtype, row_n.device,
                          (nc,))
    c_cur, g_cur = cfg0[:, 0], torch.zeros_like(cfg0[:, 0])
    acc = torch.zeros_like(c_cur)
    tri = torch.zeros_like(c_cur)
    field = None if jrow is None else jrow[1]
    heads, flags = [], []
    for x in range(lx - 1):
        c2, p0_1 = cfg0[:, x + 1], pi0[:, x]
        # the sites right of x hold pass-start values: flag 0 for the
        # current state, and the normal right stack closes both states
        pj_new = g_cur ^ (pi_d[c2] ^ p0_1)
        s1 = torch.stack([cands[ar, x, c_cur, g_cur],
                          cands[ar, x, c2, g_cur]], 1)
        s2 = torch.stack([cands[ar, x + 1, c2, 0],
                          cands[ar, x + 1, c_cur, pj_new]], 1)
        e1 = col_transfer(lenv[:, None], top[:, x, None], s1,
                          bot[:, x, None])
        e2 = col_transfer(e1, top[:, x + 1, None], s2, bot[:, x + 1, None])
        psi = (e2 * rights[:, x + 2, None]).sum((-3, -2, -1))
        ratio2 = _ratio2(psi, rdt)
        if jrow is not None:
            nvals, _, vrow = jrow
            delta = nvals[c2] - nvals[c_cur]
            ratio2 = ratio2 * torch.exp(2.0 * (
                -delta * (field[:, x] - field[:, x + 1])
                + delta * delta * vrow[x, x + 1]))
        differ = c_cur != c2
        accept = differ & (u[:, x] < ratio2)
        new1 = torch.where(accept, c2, c_cur)
        new2 = torch.where(accept, c_cur, c2)
        acc, tri = acc + accept, tri + differ
        if jrow is not None:
            d_acc = torch.where(accept, nvals[c2] - nvals[c_cur],
                                torch.zeros_like(field[:, 0]))
            field = field + d_acc[:, None] * (vrow[:, x] - vrow[:, x + 1])
        lenv, _ = bmps._normalize(e1[ar, accept.long()], 3)
        heads.append(new1)
        flags.append(g_cur)
        g_cur = g_cur ^ (pi_d[new1] ^ p0_1)
        c_cur = new2
    new_cfg = torch.stack(heads + [c_cur], 1)
    flags_all = torch.stack(flags + [g_cur], 1)
    row_new = cands[ar[:, None], xs[None, :], new_cfg, flags_all]
    return new_cfg, bmps.absorb_row(top, row_new, chi, trunc).bmps, acc, tri


def _v_pair(top, bot, cands1, cands2, cfg1, cfg2, pi_d, u, jwin=None):
    """One snake-direction (L->R frame) pass over the vertical bonds of a
    row pair of every chain, on the two unfused rows (K3). cands1/cands2
    [nc, Lx, d, 2, u,l,d,r]; cfg1/cfg2 [nc, Lx]; u [nc, Lx]; jwin:
    optional Jastrow (nvals [d], field [nc, 2 Lx] over row1 ++ row2,
    vwin [2 Lx, 2 Lx]). Returns (new row1, new row2, the finalized dressed
    upper row [nc, Lx, u,l,d,r], accepted [nc], trials [nc])."""
    nc, lx = cfg1.shape
    rdt = cands1.real.dtype if cands1.is_complex() else cands1.dtype
    ar = torch.arange(nc, device=cfg1.device)
    xs = torch.arange(lx, device=cfg1.device)[None, :]
    arr = ar[:, None]
    rights_n, lw_n = _pair_rights(top, bot, cands1[arr, xs, cfg1, 0],
                                  cands2[arr, xs, cfg2, 0])
    rights_f, lw_f = _pair_rights(top, bot, cands1[arr, xs, cfg1, 1],
                                  cands2[arr, xs, cfg2, 1])
    chi, dv = top.shape[2], cands1.shape[-3]
    lenv = torch.zeros(nc, chi, dv, dv, chi, dtype=cands1.dtype,
                       device=cands1.device)
    lenv[:, 0, 0, 0, 0] = 1.0
    g = torch.zeros_like(cfg1[:, 0])
    acc = torch.zeros_like(g)
    tri = torch.zeros_like(g)
    field = None if jwin is None else jwin[1]
    v1s, v2s, g1s = [], [], []

    def pick(flag, f_val, n_val):
        shape = (-1,) + (1,) * (f_val.dim() - 1)
        return torch.where((flag == 1).reshape(shape), f_val, n_val)

    for x in range(lx):
        s1v, s2v = cfg1[:, x], cfg2[:, x]
        gj_new = g ^ (pi_d[s1v] ^ pi_d[s2v])
        r1 = torch.stack([cands1[ar, x, s1v, g], cands1[ar, x, s2v, g]], 1)
        r2 = torch.stack([cands2[ar, x, s2v, g],
                          cands2[ar, x, s1v, gj_new]], 1)
        e = pair_transfer(lenv[:, None], top[:, x, None], r1, r2,
                          bot[:, x, None])
        r_cur = pick(g, rights_f[:, x + 1], rights_n[:, x + 1])
        r_new = pick(gj_new, rights_f[:, x + 1], rights_n[:, x + 1])
        psi = (e * torch.stack([r_cur, r_new], 1)).sum((-4, -3, -2, -1))
        lw_cur = pick(g, lw_f[:, x + 1], lw_n[:, x + 1])
        lw_new = pick(gj_new, lw_f[:, x + 1], lw_n[:, x + 1])
        ratio2 = _ratio2(psi, rdt) * torch.exp(2.0 * (lw_new - lw_cur))
        if jwin is not None:
            nvals, _, vwin = jwin
            delta = nvals[s2v] - nvals[s1v]
            ratio2 = ratio2 * torch.exp(2.0 * (
                -delta * (field[:, x] - field[:, lx + x])
                + delta * delta * vwin[x, lx + x]))
        differ = s1v != s2v
        accept = differ & (u[:, x] < ratio2)
        v1 = torch.where(accept, s2v, s1v)
        v2 = torch.where(accept, s1v, s2v)
        acc, tri = acc + accept, tri + differ
        if jwin is not None:
            d_acc = torch.where(accept, nvals[s2v] - nvals[s1v],
                                torch.zeros_like(field[:, 0]))
            field = field + d_acc[:, None] * (vwin[:, x] - vwin[:, lx + x])
        lenv, _ = bmps._normalize(e[ar, accept.long()], 4)
        v1s.append(v1)
        v2s.append(v2)
        g1s.append(g)
        g = torch.where(accept, gj_new, g)
    v1s, v2s, g1s = (torch.stack(t, 1) for t in (v1s, v2s, g1s))
    return v1s, v2s, cands1[arr, xs, v1s, g1s], acc, tri


def _sweep_uniforms(uniforms, generator, tps, nc, ly, lx):
    if uniforms is not None:
        return uniforms
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    return draw_uniforms(generator, nc, ly, lx, rdt, tps.device)


def mc_sweep_fermion_shared(tps, space, config, chi: int, trunc,
                            uniforms=None,
                            generator: torch.Generator | None = None,
                            dress=None):
    """One env-shared MC sweep of every chain: all horizontal bonds row by
    row, then all vertical bonds pair by pair, exchange moves. config
    [nc, Ly, Lx]; uniforms (u_h [nc, Ly, Lx-1], u_v [nc, Lx, Ly-1]) or None
    to draw them from ``generator``; dress: optional JastrowDress (every
    exchange ratio takes its factor through a carried field). Returns
    (config' [nc, Ly, Lx] int64, SweepStats of per-chain counts [nc])."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long().clone()
    nc = config.shape[0]
    dev = tps.device
    u_h, u_v = _sweep_uniforms(uniforms, generator, tps, nc, ly, lx)
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    pi_d = torch.as_tensor(space.phys_parity, dtype=torch.int64, device=dev)
    ids = torch.arange(ly * lx, device=dev).reshape(ly, lx)
    acc = torch.zeros(nc, dtype=torch.int64, device=dev)
    tri = torch.zeros_like(acc)
    top0 = bmps.init_boundary(lx, chi, tps.shape[-1], tps.dtype, dev, (nc,))

    def bottoms():
        net = fermion_project(tps, config, space)
        ftops, _ = bmps.all_top_envs(bmps.flip_vertical(net), chi, trunc)
        return torch.flip(ftops, [-5])

    def jastrow(sid, odd):
        if dress is None:
            return None
        sid = sid.flip(-1) if odd else sid
        w = sid.reshape(-1)
        return (dress.nvals.to(rdt), dress.field(config).to(rdt)[:, w],
                dress.v[w][:, w].to(rdt))

    bots = bottoms()
    top = top0
    for y in range(ly):
        odd = y % 2 == 1
        cands = fermion_candidates(tps, config, space, y, 1)[:, 0]
        cfg_row = config[:, y]
        if odd:
            top_u, bot_u = _refl_bmps(top), _refl_bmps(bots[:, y + 1])
            cands, cfg_row = _refl_site(cands), cfg_row.flip(-1)
        else:
            top_u, bot_u = top, bots[:, y + 1]
        new_row, new_top, a, t = _h_row(top_u, bot_u, cands, cfg_row, pi_d,
                                        u_h[:, y], chi, trunc,
                                        jastrow(ids[y], odd))
        if odd:
            new_row, new_top = new_row.flip(-1), _refl_bmps(new_top)
        config[:, y] = new_row
        top = new_top
        acc, tri = acc + a, tri + t
    if ly > 1:
        bots = bottoms()
        top = top0
        for y in range(ly - 1):
            odd = y % 2 == 1
            cands = fermion_candidates(tps, config, space, y, 2)
            c1, c2 = cands[:, 0], cands[:, 1]
            cfg1, cfg2 = config[:, y], config[:, y + 1]
            top_u, bot_u = top, bots[:, y + 2]
            if odd:
                top_u, bot_u = _refl_bmps(top_u), _refl_bmps(bot_u)
                c1, c2 = _refl_site(c1), _refl_site(c2)
                cfg1, cfg2 = cfg1.flip(-1), cfg2.flip(-1)
            v1, v2, row1, a, t = _v_pair(top_u, bot_u, c1, c2, cfg1, cfg2,
                                         pi_d, u_v[:, :, y],
                                         jastrow(ids[y:y + 2], odd))
            if odd:
                v1, v2, row1 = v1.flip(-1), v2.flip(-1), _refl_site(row1)
            config[:, y], config[:, y + 1] = v1, v2
            top = bmps.absorb_row(top, row1, chi, trunc).bmps
            acc, tri = acc + a, tri + t
    return config, SweepStats(acc, tri)


def mc_sweep_fermion_oracle(tps, space, config, chi: int, trunc, uniforms,
                            dress=None):
    """Full-recompute replay of :func:`mc_sweep_fermion_shared`'s
    trajectory (the same bond order and uniforms), batched over chains: the
    equivalence oracle, for tests. Returns (config', SweepStats)."""
    from peps_tpu_torch.fermion.vmc import log_abs_psi_fermion

    ly, lx = config.shape[-2:]
    u_h, u_v = uniforms
    cfg = config.long().clone()
    acc = torch.zeros(cfg.shape[0], dtype=torch.int64, device=cfg.device)
    tri = torch.zeros_like(acc)

    def logpsi(c):
        la, _ = log_abs_psi_fermion(tps, c, space, chi, trunc)
        if dress is not None:
            la = la + dress.log_factor(c).to(la.dtype)
        return la

    def try_bond(s1, s2, u):
        nonlocal cfg, acc, tri
        (y1, x1), (y2, x2) = s1, s2
        a, b = cfg[:, y1, x1].clone(), cfg[:, y2, x2].clone()
        cand = cfg.clone()
        cand[:, y1, x1], cand[:, y2, x2] = b, a
        ratio2 = torch.exp(2.0 * (logpsi(cand) - logpsi(cfg)))
        differ = a != b
        accept = differ & (u < ratio2)
        cfg = torch.where(accept[:, None, None], cand, cfg)
        acc, tri = acc + accept, tri + differ

    for y in range(ly):
        for xp in range(lx - 1):
            if y % 2 == 0:
                try_bond((y, xp), (y, xp + 1), u_h[:, y, xp])
            else:        # reflected frame: kernel position xp
                try_bond((y, lx - 1 - xp), (y, lx - 2 - xp), u_h[:, y, xp])
    for y in range(ly - 1):
        for xp in range(lx):
            x = xp if y % 2 == 0 else lx - 1 - xp
            try_bond((y, x), (y + 1, x), u_v[:, xp, y])
    return cfg, SweepStats(acc, tri)
