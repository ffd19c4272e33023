"""VMC on graded fermionic TPS (port of ``peps_tpu/fermion/vmc.py``):
amplitudes, local energy, holes and the full-recompute MC sweep, batched
over chains (config [nc, Ly, Lx]).

The amplitude is the plain bosonic BMPS contraction of the DRESSED
projection (:mod:`peps_tpu_torch.fermion.convert`, kernel K4), in the
snake-order JW basis:

* NN string signs are SNAKE strings: horizontal bonds are JW-adjacent;
  vertical bonds carry the local Z's of the row suffix (even rows) / row
  prefix (odd rows) of both rows.
* The ratio tables come from shared environments
  (:mod:`peps_tpu_torch.fermion.tables`) by default; ``env_sharing=False``
  takes the batched full recomputes, the reference's validation path.
* The gradient holes are the reference's ``jax.grad`` of log|psi| through
  the whole contraction, here torch autograd with the dressed nets of a
  chain slice as the leaf (K1's transfers through its backward,
  :class:`~peps_tpu_torch.kernels.col_transfer.ColTransferFunction`): each
  chain's log|psi| depends only on its own net, so the gradient of their
  sum is every chain's. torch's gradient of a real function of complex
  entries is the conjugate of JAX's; the holes take the conjugate, then
  K4 undresses them (the dressing is its own inverse).
"""
from __future__ import annotations

import dataclasses

import torch

from peps_tpu_torch.algorithm.energy import EnergyHoles, o_tensor_of
from peps_tpu_torch.algorithm.energy_fermion import (FermionTensors,
                                                     _prefix_suffix,
                                                     _z_factors,
                                                     channel_energy)
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.fermion.convert import dress_tables, fermion_project
from peps_tpu_torch.fermion.peps import FermionSpace
from peps_tpu_torch.kernels.fermion_dress import fermion_dress
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.jastrow import two_site_log_ratios
from peps_tpu_torch.montecarlo.sweep import SweepStats


@dataclasses.dataclass(frozen=True)
class GradedFermionModel:
    """A fermionic model bound to a graded TPS space: ``ft`` the channel
    tables (shared with the JW path), ``space`` static."""
    ft: FermionTensors
    space: FermionSpace

    @property
    def phys_dim(self) -> int:
        return self.ft.phys_dim

    @classmethod
    def from_model(cls, model, space: FermionSpace, dtype, device=None):
        return cls(FermionTensors.from_model(model, dtype, device), space)


def _log_abs(mant, logw, like):
    tiny = torch.finfo(like.real.dtype).tiny
    return torch.log(torch.clamp(mant.abs(), min=tiny)) + logw


def amplitude_fermion(tps, config, space: FermionSpace, chi: int,
                      trunc: TruncParams):
    """(mantissa [nc], log_weight [nc]): psi = mant * exp(log_weight)."""
    return bmps.amplitude(fermion_project(tps, config.long(), space), chi,
                          trunc)


def log_abs_psi_fermion(tps, config, space, chi, trunc):
    """(log|psi| [nc], mantissa [nc])."""
    mant, logw = amplitude_fermion(tps, config, space, chi, trunc)
    return _log_abs(mant, logw, tps), mant


amplitudes_fermion = amplitude_fermion


def snake_string_signs(config, ft: FermionTensors):
    """Snake-order JW string signs per bond and channel, keyed (orient,
    string) as :func:`peps_tpu_torch.algorithm.energy_fermion.
    _string_signs`. Vertical bonds (y,x)-(y+1,x): the modes between them
    along the snake are the sites to the RIGHT in both rows (even y) or to
    the LEFT (odd y)."""
    zu, zd, zt = _z_factors(config, ft)
    ly = config.shape[-2]
    prefix, suffix = _prefix_suffix(zt)
    even = (torch.arange(ly - 1, device=config.device) % 2 == 0)[:, None]
    between_v = torch.where(even, suffix[..., :-1, :] * suffix[..., 1:, :],
                            prefix[..., :-1, :] * prefix[..., 1:, :])
    between_d = torch.where(even,
                            suffix[..., :-1, :-1] * suffix[..., 1:, 1:],
                            prefix[..., :-1, :-1] * prefix[..., 1:, 1:])
    # anti-diagonal: JW-earlier (y, x+1), later (y+1, x)
    between_ad = torch.where(even,
                             suffix[..., :-1, 1:] * suffix[..., 1:, :-1],
                             prefix[..., :-1, 1:] * prefix[..., 1:, :-1])
    ones_h = torch.ones_like(zt[..., :, 1:])
    out = {}
    if ft.spinless:
        out.update({("h", "up"): ones_h, ("v", "up"): between_v,
                    ("d", "up"): between_d, ("ad", "up"): between_ad})
    else:
        # within a site up precedes down; the JW-earlier site of a
        # horizontal pair is the left one on even rows, the right on odd
        even_h = (torch.arange(ly, device=config.device) % 2 == 0)[:, None]
        out.update({
            ("h", "up"): torch.where(even_h, zd[..., :, :-1],
                                     zd[..., :, 1:]),
            ("h", "dn"): torch.where(even_h, zu[..., :, 1:],
                                     zu[..., :, :-1]),
            ("v", "up"): zd[..., :-1, :] * between_v,
            ("v", "dn"): between_v * zu[..., 1:, :],
            ("d", "up"): zd[..., :-1, :-1] * between_d,
            ("d", "dn"): between_d * zu[..., 1:, 1:],
            ("ad", "up"): zd[..., :-1, 1:] * between_ad,
            ("ad", "dn"): between_ad * zu[..., 1:, :-1]})
    out[("h", "none")] = ones_h
    out[("v", "none")] = torch.ones_like(between_v)
    out[("d", "none")] = torch.ones_like(between_d)
    out[("ad", "none")] = torch.ones_like(between_d)
    return out


def _phase(m):
    if m.is_complex():
        return m / torch.clamp(m.abs(), min=torch.finfo(m.real.dtype).tiny)
    return torch.sign(m)


def _replaced_ratio_tables(tps, config, space, chi, trunc, log0, mant0,
                           want_diag: bool = False):
    """Every NN (and with want_diag the t2) ratio table by batched full
    recomputes: ratio[y, x, a, b] = psi(S with the bond -> (a, b)) /
    psi(S). Returns {"h", "v"[, "d", "ad"]} -> [nc, ..., d, d]."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    nc = config.shape[0]
    dev = config.device
    ab = torch.cartesian_prod(torch.arange(d, device=dev),
                              torch.arange(d, device=dev))     # [d*d, 2]
    kinds = {"h": ((0, 0), (0, 1), ly, lx - 1),
             "v": ((0, 0), (1, 0), ly - 1, lx)}
    if want_diag:
        kinds.update(d=((0, 0), (1, 1), ly - 1, lx - 1),
                     ad=((1, 0), (0, 1), ly - 1, lx - 1))
    cfgs, shapes = [], {}
    for kind, ((dy1, dx1), (dy2, dx2), ny, nx) in kinds.items():
        ys, xs = torch.meshgrid(torch.arange(ny, device=dev),
                                torch.arange(nx, device=dev), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        nbond = ys.shape[0]
        c = config[:, None, None].expand(nc, nbond, d * d, ly, lx).clone()
        bi = torch.arange(nbond, device=dev)[:, None]
        ki = torch.arange(d * d, device=dev)[None, :]
        c[:, bi, ki, (ys + dy1)[:, None], (xs + dx1)[:, None]] = ab[:, 0]
        c[:, bi, ki, (ys + dy2)[:, None], (xs + dx2)[:, None]] = ab[:, 1]
        cfgs.append(c.reshape(nc, -1, ly, lx))
        shapes[kind] = (ny, nx)
    allc = torch.cat(cfgs, 1)
    m = allc.shape[1]
    la, mant = log_abs_psi_fermion(tps, allc.reshape(-1, ly, lx), space, chi,
                                   trunc)
    la, mant = la.reshape(nc, m), mant.reshape(nc, m)
    ph0 = _phase(mant0)
    inv = ph0.conj() if ph0.is_complex() else ph0
    ratios = _phase(mant) * inv[:, None] \
        * torch.exp(torch.clamp(la - log0[:, None], max=60.0)).to(mant.dtype)
    out, off = {}, 0
    for kind, (ny, nx) in shapes.items():
        n = ny * nx * d * d
        out[kind] = ratios[:, off:off + n].reshape(nc, ny, nx, d, d)
        off += n
    return out


def _holes(tps, config, space, chi, trunc, net):
    """(undressed holes [nc, Ly, Lx, D, D, D, D] = d log|psi| / d A at the
    configuration's entries in JAX's convention, the top env stacks
    (detached) and their logs): autograd of the summed log|psi| with the
    dressed nets as the leaf, conjugated, then undressed by K4."""
    ly = tps.shape[0]
    leaf = net.detach().requires_grad_(True)
    with torch.enable_grad():
        tops, log_tops = bmps.all_top_envs(leaf, chi, trunc)
        mant = bmps.close_boundary(tops[:, ly])
        la = _log_abs(mant, log_tops[:, ly], tps)
        (grad,) = torch.autograd.grad(la.sum(), leaf)
    if grad.is_complex():
        grad = torch.conj_physical(grad)
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    wide = grad.unsqueeze(3).expand(-1, -1, -1, d, *grad.shape[3:])
    holes = fermion_dress(wide, config, dress_tables(space, ly, lx),
                          select_config=True, f0=0, nf=1)[:, :, :, 0, 0]
    return holes, tops.detach(), log_tops.detach()


def graded_energy_and_holes(tps, config, model: GradedFermionModel,
                            chi: int, trunc: TruncParams,
                            with_holes: bool = True,
                            env_sharing: bool = True, dress=None,
                            shared=None):
    """(e_loc [nc], holes [nc, Ly, Lx, D^4] or None, log|psi| [nc],
    mantissa [nc]) of the graded model for config [nc, Ly, Lx]; the holes
    are O at the configuration's entries (psi_loc = 1 for K2). shared:
    optional GradedEnvShared of these configurations (its nets, stacks and
    candidates serve the shared-environment tables)."""
    from peps_tpu_torch.fermion.tables import fermion_ratio_tables

    ft, space = model.ft, model.space
    ly, lx = tps.shape[0], tps.shape[1]
    config = config.long()
    want_diag = ft.has_diag and lx > 1 and ly > 1
    if shared is not None:
        net, net_flip = shared.net, shared.net_flip
        stacks, cands = shared.stacks, shared.cands
    else:
        both = fermion_project(tps, config, space, flags=(0, 1))
        net, net_flip = both[:, 0], both[:, 1]
        stacks = cands = None
    holes = None
    if with_holes:
        holes, tops, log_tops = _holes(tps, config, space, chi, trunc, net)
        if env_sharing and stacks is None:
            ftops, flog = bmps.all_top_envs(bmps.flip_vertical(net), chi,
                                            trunc)
            stacks = bmps.EnvStacks(tops, torch.flip(ftops, [-5]), log_tops,
                                    torch.flip(flog, [-1]))
    if env_sharing:
        tabs = fermion_ratio_tables(tps, config, space, chi, trunc,
                                    want_diag, (net, net_flip), stacks,
                                    cands)
        ratios = {"h": tabs.ratio_h, "v": tabs.ratio_v}
        if want_diag:
            ratios.update(d=tabs.ratio_d, ad=tabs.ratio_ad)
        log0, mant0 = tabs.log_abs_psi, tabs.psi_mant
    else:
        mant0, logw = bmps.amplitude(net, chi, trunc)
        log0 = _log_abs(mant0, logw, tps)
        ratios = _replaced_ratio_tables(tps, config, space, chi, trunc, log0,
                                        mant0, want_diag)
    if dress is not None:
        flat = torch.arange(ly * lx, device=config.device).reshape(ly, lx)
        ends = {"h": (flat[:, :lx - 1], flat[:, 1:]),
                "v": (flat[:ly - 1], flat[1:]),
                "d": (flat[:ly - 1, :lx - 1], flat[1:, 1:]),
                "ad": (flat[1:, :lx - 1], flat[:ly - 1, 1:])}
        for kind, table in ratios.items():
            i1, i2 = ends[kind]
            lr = two_site_log_ratios(dress, config, i1.reshape(-1),
                                     i2.reshape(-1))
            ratios[kind] = table * torch.exp(lr).reshape(table.shape) \
                .to(table.dtype)
        log0 = log0 + dress.log_factor(config).to(log0.dtype)
    e = channel_energy(config, ft, ratios, snake_string_signs(config, ft))
    if e is None:
        e = torch.zeros(config.shape[0], dtype=tps.dtype, device=tps.device)
    if ft.h_site is not None:
        e = e + ft.h_site[config, config].flatten(1).sum(1)
    return e, holes, log0, mant0


def local_energy_and_holes_graded(tps, config, model: GradedFermionModel,
                                  chi: int, trunc: TruncParams,
                                  with_holes: bool = True,
                                  env_sharing: bool = True,
                                  dress=None) -> EnergyHoles:
    """E_loc(S) and the O tensor [nc, Ly, Lx, d, D, D, D, D] of a graded
    fermionic TPS, the interface of the bosonic and JW evaluators.
    env_sharing: the shared-environment tables (default) or the batched
    full recomputes; dress: optional JastrowDress (the ratios take its
    factor, log|psi| gains log J, O is unchanged)."""
    e, holes, log0, mant0 = graded_energy_and_holes(
        tps, config, model, chi, trunc, with_holes, env_sharing, dress)
    o = None
    if holes is not None:
        ones = torch.ones(holes.shape[:3], dtype=holes.dtype,
                          device=holes.device)
        o = o_tensor_of(holes, ones, config.long(), tps.shape[2])
    return EnergyHoles(e, o, log0, mant0)


def mc_bonds(ly: int, lx: int):
    """The full-recompute sweep's bond order: (y, x, vertical) for every
    horizontal, then every vertical NN bond."""
    return ([(y, x, 0) for y in range(ly) for x in range(lx - 1)]
            + [(y, x, 1) for y in range(ly - 1) for x in range(lx)])


def mc_sweep_fermion(tps, space: FermionSpace, config, chi: int,
                     trunc: TruncParams, uniforms=None,
                     generator: torch.Generator | None = None):
    """One Metropolis sweep over all NN bonds (exchange moves) with full
    amplitude recomputes of every chain, in :func:`mc_bonds` order, one
    uniform per bond (uniforms [nc, n_bonds] or drawn from generator).
    Returns (config', log|psi'| [nc], SweepStats of per-chain counts)."""
    ly, lx = config.shape[-2:]
    nc = config.shape[0]
    config = config.long().clone()
    bonds = mc_bonds(ly, lx)
    if uniforms is None:
        rdt = tps.real.dtype if tps.is_complex() else tps.dtype
        uniforms = torch.rand(nc, len(bonds), generator=generator, dtype=rdt,
                              device=tps.device)
    log0, _ = log_abs_psi_fermion(tps, config, space, chi, trunc)
    acc = torch.zeros(nc, dtype=torch.int64, device=tps.device)
    tri = torch.zeros_like(acc)
    for k, (y, x, vert) in enumerate(bonds):
        y2, x2 = y + vert, x + 1 - vert
        s1, s2 = config[:, y, x].clone(), config[:, y2, x2].clone()
        cand = config.clone()
        cand[:, y, x], cand[:, y2, x2] = s2, s1
        log1, _ = log_abs_psi_fermion(tps, cand, space, chi, trunc)
        ratio2 = torch.exp(2.0 * (log1 - log0))
        differs = s1 != s2
        accept = differs & (uniforms[:, k] < torch.clamp(ratio2, max=1.0))
        config = torch.where(accept[:, None, None], cand, config)
        log0 = torch.where(accept, log1, log0)
        acc = acc + accept
        tri = tri + differs
    return config, log0, SweepStats(acc, tri)


def ensure_validity_fermion(tps, configs, generator: torch.Generator,
                            space: FermionSpace, chi: int,
                            trunc: TruncParams):
    """Replace zero-amplitude chains with copies of random healthy chains
    (the bosonic ``engine.ensure_validity`` on graded amplitudes). Returns
    (configs, number rescued tensor); no host sync."""
    mant, _ = amplitude_fermion(tps, configs, space, chi, trunc)
    valid = mant != 0
    n_valid = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    u = torch.rand(configs.shape[0], generator=generator,
                   device=configs.device, dtype=torch.float64)
    donors = (u * torch.clamp(n_valid, min=1)).long()
    rescued = torch.where(valid[:, None, None], configs,
                          configs[order[donors]])
    return rescued, configs.shape[0] - n_valid


def normalize_state_order1_fermion(tps, configs, space: FermionSpace,
                                   chi: int, trunc: TruncParams):
    """Rescale the TPS so that the largest sampled |psi| is O(1)."""
    mant, logw = amplitude_fermion(tps, configs, space, chi, trunc)
    log_abs = torch.log(torch.clamp(mant.abs(), min=1e-300)) + logw
    return tps * torch.exp(-log_abs.max() / (tps.shape[0] * tps.shape[1]))

