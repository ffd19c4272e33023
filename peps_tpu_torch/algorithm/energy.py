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

The same machinery gives the normalized ratio tables of
:func:`compute_ratio_tables` (the reference's ``RatioTables``), which the
Jastrow-dressed evaluator multiplies by the dress's ratio factors, and the
psi-consistency monitor. The two-row tables are built in one place,
:func:`_pair_tables`, for the pair pass and the ratio tables alike.

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
from peps_tpu_torch.montecarlo.jastrow import (one_site_log_ratios,
                                               two_site_log_ratios)
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


def model_kind(model) -> str | None:
    """The kind of an evaluator form, decided here for every entry point:
    "graded" (``GradedFermionModel``), "jw" (``FermionTensors``, the
    Jordan-Wigner representation) or "bosonic" (``ModelTensors``); None
    for anything else (a model not yet in its evaluator form)."""
    from peps_tpu_torch.algorithm.energy_fermion import FermionTensors
    from peps_tpu_torch.fermion.vmc import GradedFermionModel
    if isinstance(model, GradedFermionModel):
        return "graded"
    if isinstance(model, FermionTensors):
        return "jw"
    if isinstance(model, ModelTensors):
        return "bosonic"
    return None


def model_tensors(model, dtype, device, entry: str):
    """The evaluator's form of a model: ``ModelTensors`` of a bosonic
    square-lattice model, ``FermionTensors`` of a fermionic model in the
    Jordan-Wigner representation; an evaluator form (:func:`model_kind`)
    passes through. Anything else is refused."""
    from peps_tpu_torch.algorithm.energy_fermion import FermionTensors
    if model_kind(model) is not None:
        return model
    if hasattr(model, "channels_h"):
        return FermionTensors.from_model(model, dtype, device)
    if not hasattr(model, "h_h"):
        raise NotImplementedError(
            f"{entry} of a {type(model).__name__}: the port takes bosonic "
            "square-lattice models, fermionic models (FermionModel, "
            "FermionTensors) and GradedFermionModel")
    return ModelTensors.from_model(model, dtype, device)


def bosonic_model_tensors(model, dtype, device, entry: str) -> ModelTensors:
    """ModelTensors of a bosonic square-lattice model (passed through when
    it already is one), for the entries that take bosonic models only, as
    the reference's do (the Jastrow-dressed energy, the exact-sum
    measurement of the spin observables); anything else is refused."""
    if isinstance(model, ModelTensors):
        return model
    if not hasattr(model, "h_h"):
        raise NotImplementedError(
            f"{entry} of a {type(model).__name__}: it takes bosonic "
            "square-lattice models, as the reference's does (fermionic "
            "states: measure() and exact_sum_pair_corr_graded)")
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
    ratio_h: torch.Tensor | None = None   # [nc, Ly, Lx-1, d, d]


def _safe(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _ratio_table(table, cp, cq):
    """table / table[cp, cq]: amplitude ratios of every replacement pair;
    table [nc, ..., d, d] with the pairs' configurations cp, cq [nc, ...]."""
    psi_b = table.take_along_dim(cp[..., None, None], -2) \
        .take_along_dim(cq[..., None, None], -1)[..., 0, 0]
    return table / _safe(psi_b)[..., None, None]


def _ratio_energy(ratios, cp, cq, h):
    """sum over pairs of h[cp, cq, :, :] * ratios -> [nc]."""
    return (h[cp, cq] * ratios).flatten(1).sum(1)


def _table_energy(table, cp, cq, h):
    """sum over bonds of h[cp, cq, :, :] * table / table[cp, cq]; table
    [nc, ..., d, d] with the bonds' configurations cp, cq [nc, ...] -> [nc]."""
    return _ratio_energy(_ratio_table(table, cp, cq), cp, cq, h)


def _row_pass(tps, tn, config, h_bond, stacks, want_h: bool = False
              ) -> _RowPass:
    """Single-row machinery over all chains and rows at once: horizontal
    bond energies, one-site ratio tables, holes and local psi; the
    horizontal ratio table too where h_bond is set or want_h."""
    ly, lx = tps.shape[0], tps.shape[1]
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, tn)
    holes = bmps.punch_holes_row(envs, tops, bots)
    psi_loc = torch.einsum("...uldr,...uldr->...", holes, tn)
    ones = torch.einsum("nyxuldr,yxpuldr->nyxp", holes, tps)
    ratio1 = ones / _safe(psi_loc)[..., None]
    bond_e = torch.zeros_like(psi_loc[:, 0, 0])
    ratio_h = None
    if h_bond is not None or want_h:
        nn = bmps.replace_nn_site_traces(envs, tops, bots, tps[:, :lx - 1],
                                         tps[:, 1:])
        ratio_h = _ratio_table(nn, config[..., :-1], config[..., 1:])
    if h_bond is not None:
        bond_e = _ratio_energy(ratio_h, config[..., :-1], config[..., 1:],
                               h_bond)
    return _RowPass(bond_e, ratio1, holes, psi_loc, ratio_h)


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


class _PairTables(NamedTuple):
    """Ratio tables of the two-row sandwiches of every row pair (y, y+1),
    [nc, Ly-1, ..., d, d]; None where not asked for. v: (y,x)-(y+1,x),
    indexed [row1, row2]; d: (y,x)-(y+1,x+1), [row1, row2]; ad:
    (y+1,x)-(y,x+1), [row2, row1]; s5: (y+1,x)-(y,x+2), [row2, row1]."""
    v: torch.Tensor | None
    d: torch.Tensor | None
    ad: torch.Tensor | None
    s5: torch.Tensor | None


def _pair_tables(tps, tn, config, stacks, want_v: bool, want_d: bool,
                 want_ad: bool, want_s5: bool = False) -> _PairTables:
    """The normalized vertical, diagonal, anti-diagonal and sqrt5 ratio
    tables from the two-row sandwiches, batched over chains and row pairs:
    the one place that builds the K3 blocks. Every lblk/rblk and
    middle-column chain is one K3 launch with a candidate batch axis; a
    table is the product of its two blocks."""
    ly, lx = tps.shape[0], tps.shape[1]
    top, bot = stacks.tops[:, :ly - 1], stacks.bots[:, 2:]
    row1, row2 = tn[:, :ly - 1], tn[:, 1:]
    cands1, cands2 = tps[:ly - 1], tps[1:]       # [Ly-1, Lx, d, D, D, D, D]
    c1, c2 = config[:, :ly - 1], config[:, 1:]
    lefts, rights = _pair_row_envs(top, bot, row1, row2)

    def cols(t, a, b, nd):
        """Columns a..b-1 of t (trailing nd dims each), with a candidate
        axis of size 1 after the column axis."""
        return t[(..., slice(a, b)) + (slice(None),) * nd].unsqueeze(-nd - 1)

    def side(a, b):   # top, row1, row2, bot of columns a..b-1
        return (cols(top, a, b, 3), cols(row1, a, b, 4), cols(row2, a, b, 4),
                cols(bot, a, b, 3))

    def closure(l, r):
        return torch.einsum("...pABCE,...qABCE->...pq", l, r)

    out_v = out_d = out_ad = out_s5 = None
    if want_v:
        out_v = _ratio_table(_vertical_pair_table(lefts, rights, top, bot,
                                                  cands1, cands2), c1, c2)
    nb = lx - 1
    if nb > 0 and (want_d or want_ad):
        env_l, env_r = cols(lefts, 0, nb, 4), cols(rights, 2, lx + 1, 4)
        tl, r1l, r2l, bl = side(0, nb)
        tr, r1r, r2r, br = side(1, lx)
        if want_d:      # row1 @ x (p) and row2 @ x+1 (q) replaced
            lblk = pair_transfer(env_l, tl, cands1[:, :nb], r2l, bl)
            rblk = pair_transfer_right(env_r, tr, r1r, cands2[:, 1:], br)
            out_d = _ratio_table(closure(lblk, rblk), c1[..., :nb],
                                 c2[..., 1:])
        if want_ad:     # row2 @ x (q) and row1 @ x+1 (p) replaced
            lblk = pair_transfer(env_l, tl, r1l, cands2[:, :nb], bl)
            rblk = pair_transfer_right(env_r, tr, cands1[:, 1:], r2r, br)
            out_ad = _ratio_table(closure(lblk, rblk), c2[..., :nb],
                                  c1[..., 1:])
    nb2 = lx - 2
    if nb2 > 0 and want_s5:
        # lower-left (row2 @ x, q) with upper-right (row1 @ x+2, p); the
        # middle column x+1 unchanged
        tl, r1l, _, bl = side(0, nb2)
        lblk = pair_transfer(cols(lefts, 0, nb2, 4), tl, r1l,
                             cands2[:, :nb2], bl)
        lblk = pair_transfer(lblk, *side(1, nb2 + 1))
        tr, _, r2r, br = side(2, lx)
        rblk = pair_transfer_right(cols(rights, 3, lx + 1, 4), tr,
                                   cands1[:, 2:], r2r, br)
        out_s5 = _ratio_table(closure(lblk, rblk), c2[..., :nb2],
                              c1[..., 2:])
    return _PairTables(out_v, out_d, out_ad, out_s5)


def _pair_pass(tps, tn, config, h_v, h_d, h_ad, stacks, h_s5=None):
    """Vertical, diagonal, anti-diagonal and sqrt5 ((y+1,x)-(y,x+2)) bond
    energies [nc] from the ratio tables of :func:`_pair_tables`."""
    ly = tps.shape[0]
    c1, c2 = config[:, :ly - 1], config[:, 1:]
    tabs = _pair_tables(tps, tn, config, stacks, h_v is not None,
                        h_d is not None, h_ad is not None, h_s5 is not None)
    e = torch.zeros(config.shape[0], dtype=tn.real.dtype, device=tn.device)
    for ratios, cp, cq, h in (
            (tabs.v, c1, c2, h_v),
            (tabs.d, c1[..., :-1], c2[..., 1:], h_d),
            (tabs.ad, c2[..., :-1], c1[..., 1:], h_ad),
            (tabs.s5, c2[..., :-2], c1[..., 2:], h_s5)):
        if ratios is not None:
            e = e + _ratio_energy(ratios, cp, cq, h)
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
    log_abs, mant = _log_abs_psi(stacks, tn)
    return e, rp, log_abs, mant


def local_energy_and_holes(tps, config, model: ModelTensors, chi: int,
                           trunc: TruncParams,
                           with_holes: bool = True) -> EnergyHoles:
    """E_loc and O = d ln psi / dA for every chain of config [nc, Ly, Lx]."""
    e, rp, log_abs, mant = _local_energy(tps, config, model, chi, trunc)
    o = o_tensor_of(rp.holes, rp.psi_loc, config.long(), tps.shape[2]) \
        if with_holes else None
    return EnergyHoles(e, o, log_abs, mant)


# ---------------------------------------------------------------------------
# ratio tables, the Jastrow-dressed evaluator and the psi-consistency monitor
# ---------------------------------------------------------------------------

class RatioTables(NamedTuple):
    """Amplitude ratios psi(s')/psi(s) from shared environments, per chain:
    ratio1 [nc, Ly, Lx, d] (one site replaced); ratio_h [nc, Ly, Lx-1, d, d]
    (horizontal pairs); ratio_v [nc, Ly-1, Lx, d, d], ratio_d
    [nc, Ly-1, Lx-1, d, d] ((y,x)-(y+1,x+1)) and ratio_ad [nc, Ly-1, Lx-1,
    d, d] ((y+1,x)-(y,x+1), indexed [lower-left, upper-right]), each None
    unless asked for; o_tensor O = d ln psi / dA or None; psi_loc
    [nc, Ly, Lx]; log_abs_psi and psi_mant [nc]."""
    ratio1: torch.Tensor
    ratio_h: torch.Tensor
    ratio_v: torch.Tensor | None
    ratio_d: torch.Tensor | None
    ratio_ad: torch.Tensor | None
    o_tensor: torch.Tensor | None
    psi_loc: torch.Tensor
    log_abs_psi: torch.Tensor
    psi_mant: torch.Tensor
    holes: torch.Tensor | None = None   # [nc, Ly, Lx, u, l, d, r]


def _log_abs_psi(stacks, tn):
    ly = tn.shape[-6]
    mant = bmps.close_boundary(stacks.tops[:, ly])
    return torch.log(torch.clamp(mant.abs(), min=bmps._tiny(tn))) \
        + stacks.log_tops[:, ly], mant


def compute_ratio_tables(tps, config, chi: int, trunc: TruncParams,
                         need=("h",), with_holes: bool = True,
                         stacks=None) -> RatioTables:
    """Every ratio table a model needs, for config [nc, Ly, Lx]. need: a
    subset of {"h", "v", "d", "ad"}; the one-site and horizontal tables are
    always formed (single-row sandwiches, K1), the others from the two-row
    sandwiches (:func:`_pair_tables`, K3). stacks: optional env stacks of
    these configurations, shared with the caller."""
    config = config.long()
    tn = project(tps, config)
    if stacks is None:
        stacks = bmps.all_env_stacks(tn, chi, trunc)
    rp = _row_pass(tps, tn, config, None, stacks, want_h=True)
    o = o_tensor_of(rp.holes, rp.psi_loc, config, tps.shape[2]) \
        if with_holes else None
    tabs = _PairTables(None, None, None, None)
    if any(k in need for k in ("v", "d", "ad")):
        tabs = _pair_tables(tps, tn, config, stacks, "v" in need,
                            "d" in need, "ad" in need)
    log_abs, mant = _log_abs_psi(stacks, tn)
    return RatioTables(rp.ratio1, rp.ratio_h, tabs.v, tabs.d, tabs.ad, o,
                       rp.psi_loc, log_abs, mant, rp.holes)


def apply_dress_to_tables(tables: RatioTables, dress,
                          config) -> RatioTables:
    """Multiply the Jastrow ratio factors of ``dress`` into every
    replacement table of config [nc, Ly, Lx]; log|psi| gains log J."""
    ly, lx = config.shape[-2:]
    flat = torch.arange(ly * lx, device=config.device).reshape(ly, lx)

    def dressed(table, log_ratios):
        return None if table is None else \
            table * torch.exp(log_ratios).to(table.dtype).reshape(table.shape)

    def pair(table, idx1, idx2):
        if table is None:
            return None
        return dressed(table, two_site_log_ratios(dress, config,
                                                  idx1.reshape(-1),
                                                  idx2.reshape(-1)))

    return RatioTables(
        dressed(tables.ratio1, one_site_log_ratios(dress, config, ly, lx)),
        pair(tables.ratio_h, flat[:, :lx - 1], flat[:, 1:]),
        pair(tables.ratio_v, flat[:ly - 1], flat[1:]),
        pair(tables.ratio_d, flat[:ly - 1, :lx - 1], flat[1:, 1:]),
        pair(tables.ratio_ad, flat[1:, :lx - 1], flat[:ly - 1, 1:]),
        tables.o_tensor, tables.psi_loc,
        tables.log_abs_psi + dress.log_factor(config).to(
            tables.log_abs_psi.dtype),
        tables.psi_mant, tables.holes)


def local_energy_and_holes_dressed(tps, config, model, dress, chi: int,
                                   trunc: TruncParams,
                                   with_holes: bool = True) -> EnergyHoles:
    """Jastrow-dressed local energy of psi_J = exp(J) psi for config
    [nc, Ly, Lx]: h_h, h_v, h_d, h_ad and h_site through the dressed ratio
    tables. O with respect to the TPS is unchanged by the dress; log|psi|
    gains log J; dress None gives the same sum over the plain tables. A
    model with longer-range terms is refused: the reference takes the same
    five terms and leaves the others out of the sum."""
    model = bosonic_model_tensors(model, tps.dtype, tps.device,
                                  "local_energy_and_holes_dressed")
    extra = [f for f in ("h_s5a", "h_s5b", "h_tnn_h", "h_tnn_v")
             if getattr(model, f) is not None]
    if extra:
        raise ValueError("local_energy_and_holes_dressed takes h_h, h_v, "
                         f"h_d, h_ad and h_site; the model also has {extra}")
    need = ("h",) + tuple(k for k, h in (("v", model.h_v), ("d", model.h_d),
                                         ("ad", model.h_ad)) if h is not None)
    config = config.long()
    tabs = compute_ratio_tables(tps, config, chi, trunc, need, with_holes)
    if dress is not None:
        tabs = apply_dress_to_tables(tabs, dress, config)
    e = torch.zeros(config.shape[0], dtype=tabs.ratio1.real.dtype,
                    device=tps.device)
    for h, ratios, cp, cq in (
            (model.h_h, tabs.ratio_h, config[..., :-1], config[..., 1:]),
            (model.h_v, tabs.ratio_v, config[:, :-1], config[:, 1:]),
            (model.h_d, tabs.ratio_d, config[:, :-1, :-1], config[:, 1:, 1:]),
            (model.h_ad, tabs.ratio_ad, config[:, 1:, :-1],
             config[:, :-1, 1:])):
        if h is not None:
            e = e + _ratio_energy(ratios, cp, cq, h)
    if model.h_site is not None:
        e = e + (model.h_site[config] * tabs.ratio1).sum(dim=(1, 2, 3))
    return EnergyHoles(e, tabs.o_tensor, tabs.log_abs_psi, tabs.psi_mant)


def psi_consistency_check(tps, config, chi: int, trunc: TruncParams):
    """The amplitude closed from every row sandwich must agree: log|psi| of
    each row y (its row envs closed at column 0, with the top and bottom
    stacks' logs) for config [nc, Ly, Lx]. Returns (max |log psi_y -
    log psi_0| [nc], the logs [nc, Ly])."""
    ly = tps.shape[0]
    tn = project(tps, config.long())
    stacks = bmps.all_env_stacks(tn, chi, trunc)
    envs = bmps.row_envs(stacks.tops[:, :ly], stacks.bots[:, 1:], tn)
    mant = bmps.row_trace(envs, 0)
    logs = torch.log(torch.clamp(mant.abs(), min=1e-300)) \
        + envs.log_lefts[..., 0] + envs.log_rights[..., 0] \
        + stacks.log_tops[:, :ly] + stacks.log_bots[:, 1:]
    return (logs - logs[:, :1]).abs().amax(-1), logs
