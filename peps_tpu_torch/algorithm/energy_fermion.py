"""Local energy and holes of fermionic models in the Jordan-Wigner
representation (port of ``peps_tpu/algorithm/energy_fermion.py``).

The state is a plain bosonic TPS in the JW basis with row-major mode order
(see :mod:`peps_tpu_torch.models.fermion`). The JW strings are diagonal in
the occupation basis, so a hop is the bosonic amplitude-ratio table of its
bond times a +-1 string sign read off the current configuration, and the
gradient O tensor is the bosonic one. The ratio tables come from
:func:`~peps_tpu_torch.algorithm.energy.compute_ratio_tables` (K1 for the
single-row tables, K3 for the two-row ones). Every function is batched
over a leading chain axis: config [nc, Ly, Lx].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from peps_tpu_torch.algorithm.energy import (EnergyHoles, RatioTables,
                                             compute_ratio_tables)
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.linalg import TruncParams

_KEYS = ("none", "up", "dn")


@dataclasses.dataclass(frozen=True)
class FermionTensors:
    """Channel tables grouped by string type (channels with equal string
    specs are summed), as tensors; any table may be None. Diagonal (d)
    tables act on ((y,x), (y+1,x+1)), anti-diagonal (ad) tables on
    ((y+1,x), (y,x+1)). The occupation tables n_up / n_dn are kept at the
    state's real dtype."""
    n_up: torch.Tensor
    n_dn: torch.Tensor
    h_h_none: torch.Tensor | None
    h_h_up: torch.Tensor | None
    h_h_dn: torch.Tensor | None
    h_v_none: torch.Tensor | None
    h_v_up: torch.Tensor | None
    h_v_dn: torch.Tensor | None
    h_site: torch.Tensor | None
    spinless: bool
    h_d_none: torch.Tensor | None = None
    h_d_up: torch.Tensor | None = None
    h_d_dn: torch.Tensor | None = None
    h_ad_none: torch.Tensor | None = None
    h_ad_up: torch.Tensor | None = None
    h_ad_dn: torch.Tensor | None = None

    @property
    def phys_dim(self) -> int:
        return self.n_up.shape[0]

    @property
    def has_diag(self) -> bool:
        return any(getattr(self, f"h_{o}_{k}") is not None
                   for o in ("d", "ad") for k in _KEYS)

    def channels(self, orient: str):
        """((string, table), ...) of one orientation ("h", "v", "d",
        "ad"), tables that are None left out."""
        return tuple((k, getattr(self, f"h_{orient}_{k}")) for k in _KEYS
                     if getattr(self, f"h_{orient}_{k}") is not None)

    @classmethod
    def from_model(cls, model, dtype, device=None):
        device = resolve_device(device)

        def group(channels):
            out = dict.fromkeys(_KEYS)
            for ch in channels:
                cur = out[ch.string]
                out[ch.string] = ch.h if cur is None else cur + ch.h
            return {k: None if v is None else torch.as_tensor(
                np.asarray(v), dtype=dtype, device=device)
                for k, v in out.items()}

        gh, gv = group(model.channels_h), group(model.channels_v)
        gd = group(getattr(model, "channels_d", ()))
        gad = group(getattr(model, "channels_ad", ()))
        rdt = torch.zeros((), dtype=dtype).real.dtype
        occ = {k: torch.as_tensor(np.asarray(getattr(model, k)), dtype=rdt,
                                  device=device) for k in ("n_up", "n_dn")}
        h_site = None if model.h_site is None else torch.as_tensor(
            np.asarray(model.h_site), dtype=dtype, device=device)
        return cls(occ["n_up"], occ["n_dn"], gh["none"], gh["up"], gh["dn"],
                   gv["none"], gv["up"], gv["dn"], h_site,
                   bool(model.spinless), gd["none"], gd["up"], gd["dn"],
                   gad["none"], gad["up"], gad["dn"])


def _z_factors(config, ft: FermionTensors):
    """(zu, zd, zt) [..., Ly, Lx]: (-1)^n_up, (-1)^n_dn and the site's
    total string factor (zu for a spinless model)."""
    zu = 1.0 - 2.0 * ft.n_up[config]
    zd = 1.0 - 2.0 * ft.n_dn[config]
    return zu, zd, (zu if ft.spinless else zu * zd)


def _prefix_suffix(zt):
    """prefix[..., y, x] = prod_{x' < x} zt[..., y, x'] and suffix[..., y,
    x] = prod_{x' > x} zt[..., y, x']."""
    ones = torch.ones_like(zt[..., :1])
    prefix = torch.cat([ones, torch.cumprod(zt, -1)[..., :-1]], -1)
    rev = torch.flip(torch.cumprod(torch.flip(zt, [-1]), -1), [-1])
    suffix = torch.cat([rev[..., 1:], ones], -1)
    return prefix, suffix


def _string_signs(config, ft: FermionTensors):
    """Per-bond JW string signs in row-major mode order, keyed (orient,
    string): [..., Ly, Lx-1] for "h", [..., Ly-1, Lx] for "v" and
    [..., Ly-1, Lx-1] for "d" and "ad"."""
    zu, zd, zt = _z_factors(config, ft)
    prefix, suffix = _prefix_suffix(zt)
    between_v = suffix[..., :-1, :] * prefix[..., 1:, :]
    between_d = suffix[..., :-1, :-1] * prefix[..., 1:, 1:]
    # anti-diagonal bond: JW-earlier site (y, x+1), later (y+1, x)
    between_ad = suffix[..., :-1, 1:] * prefix[..., 1:, :-1]
    ones_h = torch.ones_like(zt[..., :, 1:])
    out = {}
    if ft.spinless:
        out.update({("h", "up"): ones_h, ("v", "up"): between_v,
                    ("d", "up"): between_d, ("ad", "up"): between_ad})
    else:
        out.update({
            ("h", "up"): zd[..., :, :-1], ("h", "dn"): zu[..., :, 1:],
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


def bond_pairs(config):
    """The (first, second) site configurations of every bond orientation,
    in the ratio tables' index order: {"h", "v", "d", "ad"} -> (c1, c2)."""
    return {"h": (config[..., :, :-1], config[..., :, 1:]),
            "v": (config[..., :-1, :], config[..., 1:, :]),
            "d": (config[..., :-1, :-1], config[..., 1:, 1:]),
            "ad": (config[..., 1:, :-1], config[..., :-1, 1:])}


def channel_energy(config, ft: FermionTensors, ratios: dict, signs: dict):
    """sum over bonds and channels of sign * sum_{a,b} h[c1, c2, a, b] *
    ratio[a, b]; ratios {"h", "v", "d", "ad"} -> [nc, ..., d, d] (an
    orientation without a table is skipped) -> [nc]."""
    pairs = bond_pairs(config)
    e = None
    for orient, table in ratios.items():
        if table is None:
            continue
        c1, c2 = pairs[orient]
        for key, h in ft.channels(orient):
            contrib = (h[c1, c2] * table).sum((-1, -2))
            term = (signs[(orient, key)] * contrib).flatten(1).sum(1)
            e = term if e is None else e + term
    return e


def jw_tables_and_energy(tps, config, ft: FermionTensors, chi: int,
                         trunc: TruncParams, with_holes: bool = True,
                         stacks=None):
    """(e_loc [nc], RatioTables) of the JW model ft; stacks: optional env
    stacks of these configurations."""
    config = config.long()
    ly, lx = tps.shape[0], tps.shape[1]
    diag = ft.has_diag and lx > 1 and ly > 1
    need = ("h", "v", "d", "ad") if diag else ("h", "v")
    tabs = compute_ratio_tables(tps, config, chi, trunc, need=need,
                                with_holes=with_holes, stacks=stacks)
    ratios = {"h": tabs.ratio_h, "v": tabs.ratio_v}
    if diag:
        ratios.update(d=tabs.ratio_d, ad=tabs.ratio_ad)
    e = channel_energy(config, ft, ratios, _string_signs(config, ft))
    if e is None:
        e = torch.zeros(config.shape[0], dtype=tps.dtype, device=tps.device)
    if ft.h_site is not None:
        e = e + (ft.h_site[config] * tabs.ratio1).sum(dim=(1, 2, 3))
    return e, tabs


def local_energy_and_holes_fermion(tps, config, ft: FermionTensors,
                                   chi: int, trunc: TruncParams,
                                   with_holes: bool = True) -> EnergyHoles:
    """E_loc and the bosonic O tensor of the JW model ft for every chain of
    config [nc, Ly, Lx]."""
    e, tabs = jw_tables_and_energy(tps, config, ft, chi, trunc, with_holes)
    return EnergyHoles(e, tabs.o_tensor, tabs.log_abs_psi, tabs.psi_mant)

