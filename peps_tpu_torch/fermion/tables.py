"""Environment-shared amplitude-ratio tables of graded fermionic states
(port of ``peps_tpu/fermion/tables.py``), batched over chains.

The dressed projection's only non-local ingredient is the snake PREFIX
parity Pi. Replacing the two sites of a parity-conserving bond changes Pi
only on the snake interval BETWEEN them:

* horizontal bonds are snake-adjacent: only the two candidate tensors
  change (the JW-later one conditioned on the earlier one's parity flip);
* vertical bonds (y, x)-(y+1, x): the interval is the rest of rows y and
  y+1 (right of x for even y, left for odd y), so a SECOND two-row env
  stack of the prefix-flipped rows covers every replacement; the diagonal
  and anti-diagonal (t2) tables use the same four stacks.

Parity-violating candidate entries get arbitrary values; a parity-
conserving Hamiltonian never reads them. The candidates and the flipped
rows come from kernel K4 (:mod:`peps_tpu_torch.kernels.fermion_dress`);
the row envs and NN traces are K1 launches, the two-row envs (with their
logs) and the diagonal blocks K3 launches, every one batched over chains
and rows (row pairs). The vertical tables take the bosonic port's route
(``energy._vertical_pair_table``: the column's two-row hole, then the
candidates).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from peps_tpu_torch.algorithm.energy import (_log_abs_psi, _pair_row_envs,
                                             _ratio_table,
                                             _vertical_pair_table)
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.fermion.convert import dress_tables, fermion_project
from peps_tpu_torch.kernels.fermion_dress import fermion_dress
from peps_tpu_torch.kernels.pair_transfer import (pair_transfer,
                                                  pair_transfer_right)


def fermion_candidates(tps, config, space, y0: int = 0,
                       ny: int | None = None):
    """Dressed candidate tensors [nc, ny, Lx, d, 2, D, D, D, D] of the rows
    [y0, y0+ny) (default all): entry (y, x, a, f) is tps[y, x, a] dressed
    for the value a with the site's snake prefix parity XOR f (f = 1 where
    an upstream replacement flipped the prefix). One K4 launch."""
    ly, lx = config.shape[-2:]
    return fermion_dress(tps, config, dress_tables(space, ly, lx), y0, ny)


def fermion_flip_mask(config, space, ly, lx, dtype):
    """Sign tensor [nc, Ly, Lx, D, D, D, D]: the factor a dressed site
    tensor takes when its snake prefix parity flips (one K4 launch on
    ones)."""
    d, D = len(space.phys_parity), space.bond_dim
    ones = torch.ones(ly, lx, d, D, D, D, D, dtype=dtype,
                      device=config.device)
    both = fermion_project(ones, config, space, flags=(0, 1))
    return both[:, 0] * both[:, 1]


class FermionTables(NamedTuple):
    """ratio_h [nc, Ly, Lx-1, d, d]; ratio_v [nc, Ly-1, Lx, d, d];
    log_abs_psi, psi_mant [nc]; ratio_d [nc, Ly-1, Lx-1, d, d] (a at
    (y,x), b at (y+1,x+1)) and ratio_ad (a at (y+1,x), b at (y,x+1)), None
    unless asked for."""
    ratio_h: torch.Tensor
    ratio_v: torch.Tensor
    log_abs_psi: torch.Tensor
    psi_mant: torch.Tensor
    ratio_d: torch.Tensor | None = None
    ratio_ad: torch.Tensor | None = None


def _where(mask, a, b):
    """a where mask [P] (a per-pair / per-row flag at axis 1), else b."""
    m = mask.reshape((1, -1) + (1,) * (a.dim() - 2))
    return torch.where(m, a, b)


def _horizontal(stacks, net, cands, config, pi_of, ly, lx):
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, net)
    even = torch.arange(ly, device=net.device) % 2 == 0
    c1, c2 = cands[:, :, :lx - 1], cands[:, :, 1:]
    traces = []
    for f in (0, 1):
        # the JW-earlier site keeps flag 0: left on even rows, right on odd
        ca = _where(even, c1[:, :, :, :, 0], c1[:, :, :, :, f])
        cb = _where(even, c2[:, :, :, :, f], c2[:, :, :, :, 0])
        traces.append(bmps.replace_nn_site_traces(envs, tops, bots, ca, cb))
    pi_d = pi_of(torch.arange(cands.shape[3], device=net.device))
    pi_row = pi_of(config)
    cond = _where(even, pi_d[:, None] != pi_row[:, :, :-1, None, None],
                  pi_d[None, :] != pi_row[:, :, 1:, None, None])
    table = torch.where(cond, traces[1], traces[0])
    return _ratio_table(table, config[:, :, :-1], config[:, :, 1:])


def _diag_tables(kind, even, envs, rows, cand1, cand2, top, bot, lx):
    """Diagonal ("d": (y,x)-(y+1,x+1)) or anti-diagonal ("ad":
    (y+1,x)-(y,x+1)) amplitude tables of every row pair for flag 0 and 1,
    from the four env stacks (normal and prefix-flipped, left and right).
    Replacing the pair flips Pi on one in-window current tensor and one
    full side of the two-row window: the right side on even pairs, the left
    on odd ones. Each block is one K3 launch with a candidate axis."""
    (lefts_n, rights_n, lwl_n, lwr_n), (lefts_f, rights_f, lwl_f, lwr_f) \
        = envs
    row1, row2, frow1, frow2 = rows
    nb = lx - 1
    odd = ~even

    def cols(t, a, b, nd):
        return t[(..., slice(a, b)) + (slice(None),) * nd].unsqueeze(-nd - 1)

    tl, bl = cols(top, 0, nb, 3), cols(bot, 0, nb, 3)
    tr, br = cols(top, 1, lx, 3), cols(bot, 1, lx, 3)
    out = []
    for f in (0, 1):
        if f:
            env_l = _where(odd, lefts_f, lefts_n)
            env_r = _where(even, rights_f, rights_n)
            r1_left, r2_left = _where(odd, frow1, row1), _where(odd, frow2,
                                                                row2)
            r1_right = _where(even, frow1, row1)
            r2_right = _where(even, frow2, row2)
        else:
            env_l, env_r = lefts_n, rights_n
            r1_left = r1_right = row1
            r2_left = r2_right = row2
        env_l, env_r = cols(env_l, 0, nb, 4), cols(env_r, 2, lx + 1, 4)
        if kind == "d":      # row1 @ x (p, flag 0) and row2 @ x+1 (q, flag f)
            lblk = pair_transfer(env_l, tl, cand1[:, :, :nb, :, 0],
                                 cols(r2_left, 0, nb, 4), bl)
            rblk = pair_transfer_right(env_r, tr, cols(r1_right, 1, lx, 4),
                                       cand2[:, :, 1:, :, f], br)
        else:                # row2 @ x (q, flag f) and row1 @ x+1 (p, flag 0)
            lblk = pair_transfer(env_l, tl, cols(r1_left, 0, nb, 4),
                                 cand2[:, :, :nb, :, f], bl)
            rblk = pair_transfer_right(env_r, tr, cand1[:, :, 1:, :, 0],
                                       cols(r2_right, 1, lx, 4), br)
        tab = torch.einsum("...pABCE,...qABCE->...pq", lblk, rblk)
        if f:
            comp = _where(even, torch.exp(lwr_f[..., 2:] - lwr_n[..., 2:]),
                          torch.exp(lwl_f[..., :nb] - lwl_n[..., :nb]))
            tab = tab * comp[..., None, None].to(tab.dtype)
        out.append(tab)
    return out


def _pair_tables(stacks, net, net_flip, cands, config, pi_of, ly, lx,
                 want_diag):
    top, bot = stacks.tops[:, :ly - 1], stacks.bots[:, 2:]
    rows = (net[:, :ly - 1], net[:, 1:], net_flip[:, :ly - 1],
            net_flip[:, 1:])
    envs = (_pair_row_envs(top, bot, rows[0], rows[1], with_logs=True),
            _pair_row_envs(top, bot, rows[2], rows[3], with_logs=True))
    (lefts_n, rights_n, lwl_n, lwr_n), (lefts_f, rights_f, lwl_f, lwr_f) \
        = envs
    even = torch.arange(ly - 1, device=net.device) % 2 == 0
    odd = ~even
    cand1, cand2 = cands[:, :ly - 1], cands[:, 1:]
    c1, c2 = config[:, :ly - 1], config[:, 1:]
    pi_d = pi_of(torch.arange(cands.shape[3], device=net.device))
    pi1 = pi_of(c1)

    # vertical: the upper candidate keeps flag 0; the lower one and the
    # interval's envs are flip-conditioned, the mixed-stack traces rescaled
    # by the log-norm difference so both flags share one normalisation
    t0 = _vertical_pair_table(lefts_n, rights_n, top, bot,
                              cand1[..., 0, :, :, :, :],
                              cand2[..., 0, :, :, :, :])
    t1 = _vertical_pair_table(_where(odd, lefts_f, lefts_n),
                              _where(even, rights_f, rights_n), top, bot,
                              cand1[..., 0, :, :, :, :],
                              cand2[..., 1, :, :, :, :])
    comp = _where(even, torch.exp(lwr_f[..., 1:] - lwr_n[..., 1:]),
                  torch.exp(lwl_f[..., :lx] - lwl_n[..., :lx]))
    t1 = t1 * comp[..., None, None].to(t1.dtype)
    cond = pi_d[:, None] != pi1[..., None, None]
    ratio_v = _ratio_table(torch.where(cond, t1, t0), c1, c2)
    if not want_diag or lx < 2:
        return ratio_v, None, None
    td0, td1 = _diag_tables("d", even, envs, rows, cand1, cand2, top, bot,
                            lx)
    cond_d = pi_d[:, None] != pi1[..., :-1, None, None]
    ratio_d = _ratio_table(torch.where(cond_d, td1, td0), c1[..., :-1],
                           c2[..., 1:])
    ta0, ta1 = _diag_tables("ad", even, envs, rows, cand1, cand2, top, bot,
                            lx)
    cond_a = pi_d[None, :] != pi1[..., 1:, None, None]
    ratio_ad = _ratio_table(torch.where(cond_a, ta1, ta0), c2[..., :-1],
                            c1[..., 1:])
    return ratio_v, ratio_d, ratio_ad


def fermion_ratio_tables(tps, config, space, chi: int, trunc,
                         want_diag: bool = False, nets=None,
                         stacks=None, cands=None) -> FermionTables:
    """All NN amplitude-ratio tables of a graded state from SHARED
    environments, for config [nc, Ly, Lx]: ratio[y, x, a, b] = psi(S with
    the bond -> (a, b)) / psi(S), sign-consistent by construction.
    want_diag adds the t2 tables from the same stacks. nets: optional
    (net, prefix-flipped net) [nc, Ly, Lx, D^4] of these configurations;
    stacks: optional env stacks of net; cands: optional candidates of
    these configurations (:func:`fermion_candidates`)."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    if nets is None:
        both = fermion_project(tps, config, space, flags=(0, 1))
        nets = (both[:, 0], both[:, 1])
    net, net_flip = nets
    if stacks is None:
        stacks = bmps.all_env_stacks(net, chi, trunc)
    if cands is None:
        cands = fermion_candidates(tps, config, space)
    pp = torch.as_tensor(space.phys_parity, device=config.device)

    def pi_of(c):
        return pp[c]

    ratio_h = _horizontal(stacks, net, cands, config, pi_of, ly, lx)
    ratio_v = ratio_d = ratio_ad = None
    if ly > 1:
        ratio_v, ratio_d, ratio_ad = _pair_tables(
            stacks, net, net_flip, cands, config, pi_of, ly, lx,
            want_diag and lx > 1)
    log_abs, mant = _log_abs_psi(stacks, net)
    return FermionTables(ratio_h, ratio_v, log_abs, mant, ratio_d, ratio_ad)
