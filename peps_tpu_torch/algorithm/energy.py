"""Local energy and gradient holes (port of the main-path part of
``peps_tpu/algorithm/energy.py``).

Full amplitude-ratio tables per bond from shared row environments,
contracted against the model's coupling tensors. Covered: horizontal NN
bonds and one-site terms from single-row sandwiches (``_row_pass``), and
vertical NN bonds through the transposed frame (``_bond_pass``, the
reference's ``only_v`` route). Diagonal, sqrt5 and third-neighbour terms
(``_pair_pass``, ``_tnn_row_pass``) come with ROADMAP queue 1, item 9.

Every function is batched over a leading chain axis: config [nc, Ly, Lx].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.device import resolve_device
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


def _bond_energy(nn, config, h_bond):
    """sum over in-row bonds of h[c1, c2, :, :] * nn / nn[c1, c2];
    nn [nc, Ly, Lx-1, d, d] -> [nc]."""
    c1, c2 = config[:, :, :-1], config[:, :, 1:]
    psi_b = torch.gather(
        torch.gather(nn, 3, c1[..., None, None].expand(*c1.shape, 1,
                                                       nn.shape[-1])),
        4, c2[..., None, None]).squeeze(-1).squeeze(-1)
    ratios = nn / _safe(psi_b)[..., None, None]
    return (h_bond[c1, c2] * ratios).sum(dim=(1, 2, 3, 4))


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
        bond_e = _bond_energy(nn, config, h_bond)
    return _RowPass(bond_e, ratio1, holes, psi_loc)


def _bond_pass(tps, tn, config, h_bond, stacks):
    """In-row NN bond energies only (the transposed-frame vertical bonds)."""
    ly, lx = tps.shape[0], tps.shape[1]
    tops, bots = stacks.tops[:, :ly], stacks.bots[:, 1:]
    envs = bmps.row_envs(tops, bots, tn)
    nn = bmps.replace_nn_site_traces(envs, tops, bots, tps[:, :lx - 1],
                                     tps[:, 1:])
    return _bond_energy(nn, config, h_bond)


def o_tensor_of(holes, psi_loc, config, d):
    """O = d ln psi / dA: holes / psi scattered by the one-hot config,
    [nc, Ly, Lx, d, D, D, D, D] (the reference's O build, energy.py:112-116)."""
    sel = torch.nn.functional.one_hot(config, d).to(holes.dtype)
    return (holes / _safe(psi_loc)[..., None, None, None, None])[:, :, :, None] \
        * sel[..., None, None, None, None]


def _check_model(model: ModelTensors):
    for name in ("h_d", "h_ad", "h_s5a", "h_s5b", "h_tnn_h", "h_tnn_v"):
        if getattr(model, name) is not None:
            raise NotImplementedError(
                f"{name} terms (pair/TNN passes): ROADMAP queue 1, item 9")


def _local_energy(tps, config, model: ModelTensors, chi: int,
                  trunc: TruncParams, stacks=None, stacks_t=None):
    """(e_loc [nc], _RowPass, log_abs_psi [nc], mant [nc]) for config
    [nc, Ly, Lx]. stacks / stacks_t: optional env stacks of these
    configurations in the normal / transposed frame (the latter is read
    only for vertical bonds), so that a caller shares them with other
    passes over the same configurations."""
    _check_model(model)
    ly = tps.shape[0]
    config = config.long()
    tn = project(tps, config)
    if stacks is None:
        stacks = bmps.all_env_stacks(tn, chi, trunc)
    rp = _row_pass(tps, tn, config, model.h_h, stacks)
    e = rp.bond_e
    if model.h_site is not None:
        e = e + (model.h_site[config] * rp.ratio1).sum(dim=(1, 2, 3))
    if model.h_v is not None:
        tps_t = transpose_tps(tps)
        cfg_t = config.transpose(1, 2)
        tn_t = project(tps_t, cfg_t)
        if stacks_t is None:
            stacks_t = bmps.all_env_stacks(tn_t, chi, trunc)
        e = e + _bond_pass(tps_t, tn_t, cfg_t, model.h_v, stacks_t)
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
