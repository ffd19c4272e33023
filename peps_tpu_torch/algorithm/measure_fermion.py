"""Fermionic measurement: t-J singlet-pair correlations (port of
``peps_tpu/algorithm/measure_fermion.py``), batched over configurations
config [nc, Ly, Lx].

<Delta^dag_b Delta_b'> for bond pairs b, b' along a lattice line, with
Delta_b = (c_{i up} c_{j dn} - c_{i dn} c_{j up}) / sqrt(2). Each Delta is
parity-even, so no string stretches between the bonds: the operator signs
are exact sequential parity counts on the occupation vector, for every
(configuration, line, i, k, channel, orientation) entry at once
(:func:`_pair_op_sign`, cumsums and gathers on an int tensor). Entry
(i, k) of a table is supported when the sample holds the singlet pair at
bond i and the two holes at bond k, in either order of i and k, |i-k| > 1:
orientation A (pair left of the holes) fills the upper triangle, B the
lower.

The walkers:

* Jordan-Wigner states (:func:`tj_singlet_pair_corr_row` and ``_col``, the
  latter on the transposed frame), modes in row-major order, and graded
  states' horizontal pairs (:func:`tj_singlet_pair_corr_graded_rowshared`,
  flag-1 candidates on each bond's snake-second site), modes in snake
  order: the row environments of the projection; the start envs of every
  (chain, row, start bond i) with their three carries, then per end bond
  k one K1 launch per column transfer for all of them
  (:func:`_line_amplitudes`).
* Graded vertical pairs (:func:`tj_singlet_pair_corr_graded_colshared`):
  excited boundary MPSs. Per (column x, start bond i) a top carry that
  absorbed the bond's two modified rows, propagated down plain rows and
  closed against the excited bottoms of the end bond by kernel K5
  (:mod:`peps_tpu_torch.kernels.bmps_overlap`).

A walker evaluates only the lanes a step can use: at end bond k the start
bonds i < k - 1 (the reference computes every (i, k) and masks the rest).
:func:`tj_singlet_pair_corr_graded` is the full-recompute oracle that the
tests hold both graded walkers against. :func:`count_adjacent` and
:func:`conditioned_pair_tables` are the two runs of the support-
conditioned estimator C = P(A) E[table | A] (the reference's
``examples/flagship_pc_cond.py``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.fermion.convert import fermion_project
from peps_tpu_torch.fermion.exact import snake_order
from peps_tpu_torch.fermion.tables import fermion_candidates
from peps_tpu_torch.fermion.vmc import _phase, log_abs_psi_fermion
from peps_tpu_torch.kernels.bmps_overlap import bmps_overlap
from peps_tpu_torch.kernels.col_transfer import col_transfer
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project

# t-J local basis: 0 = empty, 1 = up, 2 = down
_N_UP = (0, 1, 0)
_N_DN = (0, 0, 1)
HOLE_VALUES = (1.0, 0.0, 0.0)
# the start carries of a bond: its (first, second) site states: the
# emptied pair (orientation A), the created (up, dn) and (dn, up) pairs (B)
_START = ((0, 0), (1, 2), (2, 1))
# the four closures at the end bond: (carry, first state, second state):
# A with the created (up, dn) and (dn, up) pairs, B's two carries emptied
_CLOSE = ((0, 1, 2), (0, 2, 1), (1, 0, 0), (2, 0, 0))


class GradedEnvShared(NamedTuple):
    """What the graded energy pass and both graded pair walkers share for
    config [nc, Ly, Lx]: the dressed projection ``net`` and the prefix-
    flipped one ``net_flip`` [nc, Ly, Lx, D, D, D, D] (one K4 launch; the
    reference's flip mask is their ratio), the env stacks of net, and the
    flag-conditioned candidates ``cands`` [nc, Ly, Lx, d, 2, D, D, D, D]
    (one K4 launch)."""
    net: torch.Tensor
    net_flip: torch.Tensor
    stacks: bmps.EnvStacks
    cands: torch.Tensor


def graded_env_shared(tps, config, space, chi: int,
                      trunc: TruncParams) -> GradedEnvShared:
    config = config.long()
    both = fermion_project(tps, config, space, flags=(0, 1))
    net = both[:, 0]
    return GradedEnvShared(net, both[:, 1],
                           bmps.all_env_stacks(net, chi, trunc),
                           fermion_candidates(tps, config, space))


def _snake_positions(ly: int, lx: int, device):
    """(pos [Ly, Lx]: each site's snake position, order [N]: the flat
    row-major site at each snake position), int64."""
    order = [y * lx + x for y, x in snake_order(ly, lx)]
    pos = np.empty(ly * lx, np.int64)
    pos[order] = np.arange(ly * lx)
    return (torch.as_tensor(pos.reshape(ly, lx), device=device),
            torch.as_tensor(order, device=device))


def _occ_vector(config, order=None):
    """Mode occupations [nc, 2N] int64 of config [nc, Ly, Lx]: mode
    2 p + spin (0 up, 1 down) for the site at position p of ``order`` (flat
    row-major sites; default the row-major order itself)."""
    cfg = config.long()
    up = torch.as_tensor(_N_UP, device=cfg.device)[cfg].flatten(-2)
    dn = torch.as_tensor(_N_DN, device=cfg.device)[cfg].flatten(-2)
    if order is not None:
        up, dn = up[..., order], dn[..., order]
    return torch.stack([up, dn], -1).flatten(-2)


def _apply_op(occ, mode, is_cdag: bool):
    """c^dag (is_cdag) or c at mode [...] on occ [..., M]. Returns (sign
    [...]: 0 where the operator annihilates, else -1 to the number of
    occupied modes before it; occ')."""
    idx = mode[..., None]
    par = (torch.cumsum(occ, -1) - occ).gather(-1, idx)[..., 0] % 2
    ok = occ.gather(-1, idx)[..., 0] == (0 if is_cdag else 1)
    sign = torch.where(ok, 1 - 2 * par, torch.zeros_like(par))
    return sign, occ.scatter(-1, idx, torch.full_like(idx, int(is_cdag)))


def _pair_op_sign(occ_sprime, i, j, k, l, sa, sb):
    """Sign of <s| c^dag_{j, 1-sa} c^dag_{i, sa} c_{k, sb} c_{l, 1-sb} |s'>
    applied to occ(s') [..., M], for every entry at once: the flat site
    indices i, j, k, l and the spins sa, sb (0 up, 1 down) are int tensors
    broadcasting against the batch of occ_sprime. Returns int64 [...] in
    {-1, 0, 1}: the reference's sequential count, operator by operator."""
    ops = ((2 * l + (1 - sb), False), (2 * k + sb, False),
           (2 * i + sa, True), (2 * j + (1 - sa), True))
    shape = torch.broadcast_shapes(occ_sprime.shape[:-1],
                                   *(m.shape for m, _ in ops))
    occ = occ_sprime.expand(*shape, occ_sprime.shape[-1])
    sign = torch.ones(shape, dtype=torch.int64, device=occ.device)
    for mode, is_cdag in ops:
        s, occ = _apply_op(occ, mode.expand(shape), is_cdag)
        sign = sign * s
    return sign


def _occ_sprime(occ, sp, sq, hp, hq, up_first):
    """occ(s') of every entry: both modes of the pair sites sp, sq emptied,
    the hole sites hp, hq filled with the channel's singlet member (up at
    hp and down at hq where up_first, else the reverse). occ [..., M]; the
    sites and up_first broadcast against its batch."""
    shape = torch.broadcast_shapes(occ.shape[:-1], sp.shape, sq.shape,
                                   hp.shape, hq.shape, up_first.shape)
    out = occ.expand(*shape, occ.shape[-1]).clone()
    sp, sq, hp, hq = (t.expand(shape) for t in (sp, sq, hp, hq))
    out.scatter_(-1, torch.stack([2 * sp, 2 * sp + 1, 2 * sq, 2 * sq + 1],
                                 -1), 0)
    u = up_first.expand(shape).long()
    out.scatter_(-1, torch.stack([2 * hp, 2 * hp + 1, 2 * hq, 2 * hq + 1],
                                 -1), torch.stack([u, 1 - u, 1 - u, u], -1))
    return out


def _pair_coefficients(occ, sites, sa, rdt):
    """0.5 coef_a coef_b sign of every entry: [nc, nl, nb (i), nb (k),
    2 (orientation), 2 (channel)] in dtype rdt. occ [nc, M] the sample's
    mode occupations; sites [nl, L] the mode-order site index of every
    line position; sa [nc, nl, nb] the spin at each bond's first site (0
    where the bond holds (up, dn), 1 for (dn, up)). Orientation A: the pair
    at bond i is annihilated, the holes at bond k filled; B the reverse.
    Channel 0 creates (up, dn), 1 (dn, up); the singlet's (dn, up) members
    take coefficient -1."""
    ch = torch.arange(2, device=occ.device)
    up_first = ch == 0
    p1, p2 = sites[:, :-1], sites[:, 1:]
    at_i = (p1[:, :, None, None], p2[:, :, None, None])
    at_k = (p1[:, None, :, None], p2[:, None, :, None])
    occ = occ[:, None, None, None, None, :]

    def orient(pair, holes, s_a):
        occp = _occ_sprime(occ, *pair, *holes, up_first)
        sgn = _pair_op_sign(occp, *pair, *holes, s_a, ch)
        coef = (1 - 2 * (s_a != 0).long()) * (1 - 2 * ch)
        return 0.5 * (coef * sgn).to(rdt)

    return torch.stack([orient(at_i, at_k, sa[:, :, :, None, None]),
                        orient(at_k, at_i, sa[:, :, None, :, None])], -2)


def _bond_states(lines):
    """lines [nc, nl, L] -> (pair, sa, holes) [nc, nl, L-1]: whether each
    bond holds a singlet-ordered pair, the spin at its first site (1 for
    (dn, up)), whether it holds two holes."""
    c1, c2 = lines[..., :-1], lines[..., 1:]
    ud = (c1 == 1) & (c2 == 2)
    du = (c1 == 2) & (c2 == 1)
    return ud | du, du.long(), (c1 == 0) & (c2 == 0)


def _assemble(amps, coefs, pair, holes, safe=None):
    """The tables [nc, nl, nb, nb] from the closures' amplitudes amps
    [nc, nl, nb (i), nb (k), 4] (_CLOSE order; divided by safe [nc, nl, nb]
    of the start bond where given): orientation A at (i, k), B at (k, i),
    each where its sample supports it."""
    nb = pair.shape[-1]
    i = torch.arange(nb, device=amps.device)
    gap = i[None, :] > i[:, None] + 1
    valid_a = pair[..., :, None] & holes[..., None, :] & gap
    valid_b = holes[..., :, None] & pair[..., None, :] & gap
    val_a = coefs[..., 0, 0] * amps[..., 0] + coefs[..., 0, 1] * amps[..., 1]
    val_b = coefs[..., 1, 0] * amps[..., 2] + coefs[..., 1, 1] * amps[..., 3]
    if safe is not None:
        val_a = val_a / safe[..., None]
        val_b = val_b / safe[..., None]
    zero = torch.zeros_like(val_a)
    return (torch.where(valid_a, val_a, zero)
            + torch.where(valid_b, val_b, zero).transpose(-1, -2))


def _line_amplitudes(envs, top, bot, row, first, second):
    """The walker closures of every (chain, line, start bond i, end bond
    k > i + 1) along the lines of a frame: amps [nc, nl, nb, nb, 4] in
    _CLOSE order, zero where k <= i + 1, each relative to the start bond's
    own closure psi_ref, and safe [nc, nl, nb] (psi_ref, 1 where it is 0).

    envs: RowEnvs of the sandwiches (top, row, bot), each [nc, nl, L, ...];
    first / second [nc or 1, nl, L, d, u, l, d, r]: the site tensor of each
    state at a bond's first / second site. The start envs (three carries
    and the sample's own sites, psi_ref) of every bond are two K1 launches;
    each end bond k closes the lanes i < k - 1 in two and steps them
    through column k in one."""
    nc, nl, lx = row.shape[0], row.shape[1], row.shape[2]
    nb = lx - 1
    dev, dt = row.device, row.dtype
    amps = torch.zeros(nc, nl, nb, nb, 4, dtype=dt, device=dev)

    def cols(t, a, b):                   # columns a..b-1 with a carry axis
        return t[:, :, a:b, None]

    def states(sites, a, b, which):
        s = sites[:, :, a:b].index_select(3, torch.as_tensor(which,
                                                             device=dev))
        return torch.cat([s.expand(nc, *s.shape[1:]), cols(row, a, b)], 3)

    e = col_transfer(cols(envs.lefts, 0, nb), cols(top, 0, nb),
                     states(first, 0, nb, [s for s, _ in _START]),
                     cols(bot, 0, nb))
    e = col_transfer(e, cols(top, 1, lx),
                     states(second, 1, lx, [s for _, s in _START]),
                     cols(bot, 1, lx))
    carries = e[:, :, :, :3]
    psi_ref = torch.einsum("nyialc,nyialc->nyi", e[:, :, :, 3],
                           envs.rights[:, :, 2:lx + 1])
    safe = torch.where(psi_ref == 0, torch.ones_like(psi_ref), psi_ref)
    pick = torch.as_tensor([c for c, _, _ in _CLOSE], device=dev)
    s1 = torch.as_tensor([s for _, s, _ in _CLOSE], device=dev)
    s2 = torch.as_tensor([s for _, _, s in _CLOSE], device=dev)
    for k in range(2, nb):
        lanes = k - 1

        def at(t, x):
            return t[:, :, x, None, None]

        c = col_transfer(carries[:, :, :lanes].index_select(3, pick),
                         at(top, k), first[:, :, k, None].index_select(3, s1),
                         at(bot, k))
        c = col_transfer(c, at(top, k + 1),
                         second[:, :, k + 1, None].index_select(3, s2),
                         at(bot, k + 1))
        val = torch.einsum("nyiqalc,nyalc->nyiq", c, envs.rights[:, :, k + 2])
        # the right envs dropped other log weights than the start closure
        scale = torch.exp(envs.log_rights[:, :, k + 2, None]
                          - envs.log_rights[:, :, 2:lanes + 2])
        amps[:, :, :lanes, k] = val * scale[..., None]
        if k < nb - 1:
            carries[:, :, :lanes] = col_transfer(carries[:, :, :lanes],
                                                 at(top, k), at(row, k),
                                                 at(bot, k))
    return amps, safe


def _pair_corr_frame(tps_f, config_f, occ_s, sites, chi: int,
                     trunc: TruncParams, stacks=None):
    """The walker tables [nc, Ly_f, Lx_f - 1, Lx_f - 1] of a Jordan-Wigner
    state in one frame: tps_f / config_f the (possibly transposed) state
    and configurations, stacks their env stacks (built when None); occ_s
    [nc, 2N] the original configuration's row-major modes and sites
    [Ly_f, Lx_f] the original flat site of every frame position."""
    ly = tps_f.shape[0]
    tn = project(tps_f, config_f)
    if stacks is None:
        stacks = bmps.all_env_stacks(tn, chi, trunc)
    top, bot = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(top, bot, tn)
    amps, safe = _line_amplitudes(envs, top, bot, tn, tps_f[None],
                                  tps_f[None])
    pair, sa, holes = _bond_states(config_f)
    rdt = tps_f.real.dtype if tps_f.is_complex() else tps_f.dtype
    return _assemble(amps, _pair_coefficients(occ_s, sites, sa, rdt), pair,
                     holes, safe)


def tj_singlet_pair_corr_row(tps, config, chi: int, trunc: TruncParams,
                             stacks=None):
    """<Delta^dag_{(y,i)} Delta_{(y,k)}> estimator tables [nc, Ly, Lx-1,
    Lx-1] of a Jordan-Wigner t-J state (horizontal bonds at columns i and k
    of one row); stacks: optional env stacks of project(tps, config)."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    sites = torch.arange(ly * lx, device=config.device).reshape(ly, lx)
    return _pair_corr_frame(tps, config, _occ_vector(config), sites, chi,
                            trunc, stacks)


def tj_singlet_pair_corr_col(tps, config, chi: int, trunc: TruncParams,
                             stacks_t=None):
    """The same for vertical bond pairs in one column: [nc, Lx, Ly-1,
    Ly-1], entry (x, i, k) pairing ((i,x),(i+1,x)) with ((k,x),(k+1,x)),
    on the transposed frame (stacks_t: optional env stacks of its
    projection); the operator signs stay in row-major mode order."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    sites = torch.arange(ly * lx, device=config.device).reshape(ly, lx).T
    return _pair_corr_frame(transpose_tps(tps), config.transpose(1, 2),
                            _occ_vector(config), sites, chi, trunc, stacks_t)


def _inverse_phase(m):
    ph = _phase(m)
    return ph.conj() if ph.is_complex() else ph


def _graded_lines(tps, config, frame):
    """(lines [nc, nl, L], sites [nl, L] in snake mode order, occ_s [nc, 2N]
    in snake mode order) of a graded state's row or column frame."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    if d != 3:
        raise ValueError("the t-J pair correlator needs the t-J basis (0 "
                         f"empty, 1 up, 2 down), got d = {d}")
    pos, order = _snake_positions(ly, lx, config.device)
    occ = _occ_vector(config, order)
    if frame == "row":
        return config, pos, occ
    return config.transpose(1, 2), pos.T, occ


def tj_singlet_pair_corr_graded(tps, config, space, chi: int,
                                trunc: TruncParams, frame: str = "row",
                                chunk: int = 256):
    """<Delta^dag Delta> tables of a Z2-graded t-J state by batched full
    recomputes (the oracle of the env-shared walkers): every replaced
    configuration of every (line, pair bond a, hole bond b, channel) goes
    through :func:`~peps_tpu_torch.fermion.vmc.log_abs_psi_fermion`, chunk
    configurations a call. frame "row": [nc, Ly, Lx-1, Lx-1]; "col":
    [nc, Lx, Ly-1, Ly-1]."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    nc = config.shape[0]
    lines, sites, occ = _graded_lines(tps, config, frame)
    nl, nb = lines.shape[1], lines.shape[2] - 1
    dev = config.device
    flat = torch.arange(ly * lx, device=dev).reshape(ly, lx)
    flat = flat if frame == "row" else flat.T
    a1, a2 = flat[:, :-1, None, None], flat[:, 1:, None, None]
    b1, b2 = flat[:, None, :-1, None], flat[:, None, 1:, None]
    ch = torch.arange(2, device=dev)
    shape = (nc, nl, nb, nb, 2)
    cfg = config.flatten(1)[:, None, None, None, None, :].expand(
        *shape, ly * lx).clone()

    def idx(*ts):
        return torch.stack([t.expand(shape) for t in ts], -1)

    cfg.scatter_(-1, idx(a1, a2), 0)
    # channel 0 creates (up, dn) = (1, 2), channel 1 (dn, up)
    cfg.scatter_(-1, idx(b1, b2), torch.stack(
        [(1 + ch).expand(shape), (2 - ch).expand(shape)], -1))
    cfg = cfg.reshape(-1, ly, lx)
    parts = [log_abs_psi_fermion(tps, cfg[s:s + chunk], space, chi, trunc)
             for s in range(0, cfg.shape[0], chunk)]
    la = torch.cat([p[0] for p in parts]).reshape(shape)
    mant = torch.cat([p[1] for p in parts]).reshape(shape)
    log0, mant0 = log_abs_psi_fermion(tps, config, space, chi, trunc)
    inv = _inverse_phase(mant0).reshape(nc, 1, 1, 1, 1)
    ratio = _phase(mant) * inv * torch.exp(torch.clamp(
        la - log0.reshape(nc, 1, 1, 1, 1), max=60.0)).to(mant.dtype)
    pair, sa, holes = _bond_states(lines)
    rdt = la.dtype
    coefs = _pair_coefficients(occ, sites, sa, rdt)[..., 0, :]
    i = torch.arange(nb, device=dev)
    valid = pair[..., :, None] & holes[..., None, :] \
        & ((i[:, None] - i[None, :]).abs() > 1)
    val = coefs * ratio
    return torch.where(valid[..., None], val, torch.zeros_like(val)).sum(-1)


def tj_singlet_pair_corr_graded_rowshared(tps, config, space, chi: int,
                                          trunc: TruncParams,
                                          shared: GradedEnvShared | None
                                          = None):
    """Env-shared <Delta^dag Delta> walker of a graded t-J state, in-row
    horizontal bond pairs: [nc, Ly, Lx-1, Lx-1]. Delta moves a parity-even
    pair on snake-adjacent sites, so the only dressing flip is on each
    replaced bond's snake-second site (flag 1: the right site on even rows,
    the left on odd); the rest keeps its dressing. shared: the
    configurations' GradedEnvShared (built when None)."""
    ly = tps.shape[0]
    config = config.long()
    lines, sites, occ = _graded_lines(tps, config, "row")
    if shared is None:
        shared = graded_env_shared(tps, config, space, chi, trunc)
    net, stacks, cands = shared.net, shared.stacks, shared.cands
    top, bot = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(top, bot, net)
    even = (torch.arange(ly, device=net.device) % 2 == 0).reshape(
        1, ly, 1, 1, 1, 1, 1, 1)
    flag0, flag1 = cands[:, :, :, :, 0], cands[:, :, :, :, 1]
    amps, safe = _line_amplitudes(envs, top, bot, net,
                                  torch.where(even, flag0, flag1),
                                  torch.where(even, flag1, flag0))
    pair, sa, holes = _bond_states(lines)
    rdt = net.real.dtype if net.is_complex() else net.dtype
    return _assemble(amps, _pair_coefficients(occ, sites, sa, rdt), pair,
                     holes, safe)


def _modified_rows(net, net_flip, cands):
    """The two rows of every vertical bond (y, x)-(y+1, x) with the bond
    replaced, for every column x and start state pair of _START: (rows_a,
    rows_b) [nc, Ly-1, Lx (x), 3, Lx (column), u, l, d, r]. The snake
    interval between the two sites (the columns right of x for even y, left
    of x for odd y) takes the prefix-flipped rows, column x the candidates:
    flag 0 on row y, flag 1 on row y+1."""
    ly, lx = net.shape[1], net.shape[2]
    dev = net.device
    y = torch.arange(ly - 1, device=dev)[:, None, None]
    x = torch.arange(lx, device=dev)[:, None]
    col = torch.arange(lx, device=dev)[None, :]
    region = torch.where(y % 2 == 0, col > x, col < x)     # [y, x, col]
    region = region[None, :, :, :, None, None, None, None]
    at_x = (col == x)[None, None, :, None, :, None, None, None, None]

    def rows(plain, flipped, cand):
        base = torch.where(region, flipped[:, :, None], plain[:, :, None])
        return torch.where(at_x, cand[:, :, :, :, None], base[:, :, :, None])

    first = torch.as_tensor([s for s, _ in _START], device=dev)
    second = torch.as_tensor([s for _, s in _START], device=dev)
    ca = cands[:, :ly - 1, :, :, 0].index_select(3, first)
    cb = cands[:, 1:, :, :, 1].index_select(3, second)
    return (rows(net[:, :ly - 1], net_flip[:, :ly - 1], ca),
            rows(net[:, 1:], net_flip[:, 1:], cb))


def tj_singlet_pair_corr_graded_colshared(tps, config, space, chi: int,
                                          trunc: TruncParams,
                                          shared: GradedEnvShared | None
                                          = None):
    """Env-shared <Delta^dag Delta> walker of a graded t-J state for
    vertical bond pairs in one column: [nc, Lx, Ly-1, Ly-1].

    Replacing the vertical bond ((i,x),(i+1,x)) flips the snake prefix
    parity exactly on the interval between its sites (the rest of rows i
    and i+1) and nowhere below. A top carry that absorbed rows i, i+1 so
    modified (the start tops, three state pairs) and then plain rows
    carries the whole first bond; the excited bottoms (the bottom stack
    that absorbed the end bond's modified rows) carry the second. Per
    (column, start bond) each end bond k costs one row absorption and one
    overlap of each closure; both are batched over every (x, i) lane: one
    ``bmps.absorb_row`` and one K5 launch per k. shared: the
    configurations' GradedEnvShared (built when None)."""
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    lines, sites, occ = _graded_lines(tps, config, "col")
    nc, nb = config.shape[0], ly - 1
    if shared is None:
        shared = graded_env_shared(tps, config, space, chi, trunc)
    net, stacks = shared.net, shared.stacks
    dev, dt = net.device, net.dtype
    tiny = bmps._tiny(net)
    amps = torch.zeros(nc, lx, nb, nb, 4, dtype=dt, device=dev)
    mant0 = bmps.close_boundary(stacks.tops[:, ly])
    inv_ph0 = _inverse_phase(mant0)[:, None, None, None]
    log_abs0 = (torch.log(torch.clamp(mant0.abs(), min=tiny))
                + stacks.log_tops[:, ly])[:, None, None, None]
    if nb >= 3:
        rows_a, rows_b = _modified_rows(net, shared.net_flip, shared.cands)
        # excited bottoms of the end bonds k >= 2 (rows flipped upside
        # down: u and d swap, as bmps.flip_vertical does)
        r1 = bmps.absorb_row(stacks.bots[:, 4:, None, None],
                             rows_b[:, 2:].transpose(-4, -2), chi, trunc)
        r2 = bmps.absorb_row(r1.bmps, rows_a[:, 2:].transpose(-4, -2), chi,
                             trunc)
        ebots = r2.bmps
        log_ebots = stacks.log_bots[:, 4:, None, None] + r1.log_norm \
            + r2.log_norm
        # start tops of the start bonds i < nb - 2
        r1 = bmps.absorb_row(stacks.tops[:, :nb - 2, None, None],
                             rows_a[:, :nb - 2], chi, trunc)
        r2 = bmps.absorb_row(r1.bmps, rows_b[:, :nb - 2], chi, trunc)
        ex = r2.bmps
        lex = stacks.log_tops[:, :nb - 2, None, None] + r1.log_norm \
            + r2.log_norm
        pick = torch.as_tensor([c for c, _, _ in _CLOSE], device=dev)
        # each closure's bottom: the start-state index of its end pair
        ech = torch.as_tensor([_START.index((s1, s2))
                               for _, s1, s2 in _CLOSE], device=dev)
        for k in range(2, nb):
            lanes = k - 1
            eb = ebots[:, k - 2].index_select(2, ech)[:, None]
            mant, lov = bmps_overlap(ex[:, :lanes].index_select(3, pick), eb)
            la = torch.log(torch.clamp(mant.abs(), min=tiny)) + lov \
                + lex[:, :lanes].index_select(3, pick) \
                + log_ebots[:, k - 2].index_select(2, ech)[:, None]
            ratio = _phase(mant) * inv_ph0 * torch.exp(torch.clamp(
                la - log_abs0, max=60.0)).to(dt)
            amps[:, :, :lanes, k] = ratio.transpose(1, 2)
            if k < nb - 1:
                res = bmps.absorb_row(ex[:, :lanes],
                                      net[:, k, None, None, None], chi, trunc)
                ex[:, :lanes] = res.bmps
                lex[:, :lanes] = lex[:, :lanes] + res.log_norm
    pair, sa, holes = _bond_states(lines)
    rdt = net.real.dtype if net.is_complex() else net.dtype
    return _assemble(amps, _pair_coefficients(occ, sites, sa, rdt), pair,
                     holes)


# ---------------------------------------------------------------------------
# the support-conditioned estimator C = P(A) E[table | A]
# ---------------------------------------------------------------------------

def _uniform_source(tps, nc, generator, sweep_uniforms):
    if sweep_uniforms is not None:
        return sweep_uniforms
    from peps_tpu_torch.montecarlo.sweep import draw_uniforms
    ly, lx = tps.shape[0], tps.shape[1]
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    if generator is None:
        generator = torch.Generator(device=tps.device).manual_seed(0)
    return lambda: draw_uniforms(generator, nc, ly, lx, rdt, tps.device)


def count_adjacent(tps, space, configs, chi: int, trunc: TruncParams,
                   n_sweeps: int, generator: torch.Generator | None = None,
                   sweep_uniforms: Callable[[], tuple] | None = None,
                   hole_vals=HOLE_VALUES):
    """The counting run of the conditioned estimator: n_sweeps env-shared
    graded sweeps of the chains configs [nc, Ly, Lx] without a dress, and
    after each whether some pair of holes is Chebyshev-adjacent (event A).
    Returns (configs', indicators [n_sweeps, nc] float32); no tables, no
    energies. Uniforms as in measure()."""
    from peps_tpu_torch.fermion.sweep import mc_sweep_fermion_shared
    from peps_tpu_torch.montecarlo.jastrow import holes_adjacent
    configs = configs.to(tps.device).long()
    uniforms = _uniform_source(tps, configs.shape[0], generator,
                               sweep_uniforms)
    inds = []
    for _ in range(n_sweeps):
        configs, _ = mc_sweep_fermion_shared(tps, space, configs, chi, trunc,
                                             uniforms())
        inds.append(holes_adjacent(configs, hole_vals))
    return configs, torch.stack(inds)


def conditioned_pair_tables(tps, space, configs, chi: int,
                            trunc: TruncParams, n_warmup: int,
                            n_samples: int,
                            generator: torch.Generator | None = None,
                            sweep_uniforms: Callable[[], tuple] | None = None,
                            hole_vals=HOLE_VALUES, kappa: float = 50.0,
                            frames=("row", "col"), env_chunk: int | None = 8):
    """The conditioned run: env-shared graded sweeps under the hard hole-
    attraction dress (Chebyshev adjacency, kappa 50: an unbinding move is
    never accepted, a move inside the bound sector keeps the dress, so the
    chains sample |psi|^2 restricted to A), started from configurations in
    A. After n_warmup sweeps, per sweep the pair tables of both frames
    from one GradedEnvShared per env_chunk configurations. Returns
    (configs', {frame: [n_samples, nc, ...]}, indicators [n_samples, nc]
    of A, 1 everywhere while the conditioning holds)."""
    from peps_tpu_torch.fermion.sweep import mc_sweep_fermion_shared
    from peps_tpu_torch.montecarlo.jastrow import (hole_attraction_dress,
                                                   holes_adjacent)
    ly, lx = tps.shape[0], tps.shape[1]
    configs = configs.to(tps.device).long()
    nc = configs.shape[0]
    rdt = tps.real.dtype if tps.is_complex() else tps.dtype
    hard = hole_attraction_dress(hole_vals, ly, lx, kappa, diagonal=True,
                                 dtype=rdt, device=tps.device)
    uniforms = _uniform_source(tps, nc, generator, sweep_uniforms)
    walkers = {"row": tj_singlet_pair_corr_graded_rowshared,
               "col": tj_singlet_pair_corr_graded_colshared}
    tables = {f: [] for f in frames}
    inds = []
    for step in range(n_warmup + n_samples):
        configs, _ = mc_sweep_fermion_shared(tps, space, configs, chi, trunc,
                                             uniforms(), dress=hard)
        if step < n_warmup:
            continue
        inds.append(holes_adjacent(configs, hole_vals))
        parts = {f: [] for f in frames}
        for sl in bmps.chain_slices(nc, env_chunk):
            shared = graded_env_shared(tps, configs[sl], space, chi, trunc)
            for f in frames:
                parts[f].append(walkers[f](tps, configs[sl], space, chi,
                                           trunc, shared))
        for f in frames:
            tables[f].append(torch.cat(parts[f]))
    return (configs, {f: torch.stack(t) for f, t in tables.items()},
            torch.stack(inds))
