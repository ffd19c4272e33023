"""Local energy and holes on the torus through the coarse-graining
contractor (port of ``peps_tpu/algorithm/energy_pbc.py``).

One autograd pass through :func:`~peps_tpu_torch.contraction.pbc.
punch_all_holes_pbc` gives the holes (hence O and every one-site ratio) of
every chain; the two-site replacement amplitudes are full recomputes of
the contraction, batched over (chain, bond, candidate pair) in one call,
as the reference's are over (bond, candidate pair) with vmap. The torus is
bosonic only, as the reference's.
"""
from __future__ import annotations

import torch

from peps_tpu_torch.algorithm.energy import (EnergyHoles, ModelTensors,
                                             o_tensor_of)
from peps_tpu_torch.contraction.pbc import (TestMatrix, contract_pbc,
                                            punch_all_holes_pbc)
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project


def pbc_bonds(ly: int, lx: int, kind: str) -> torch.Tensor:
    """The torus bonds [Ly*Lx, 4] (y1, x1, y2, x2) of a term: "h", "v",
    "d" (down-right) or "ad" (the anti-diagonal, from (y+1, x) to
    (y, x+1)), in the reference's order."""
    rows = []
    for y in range(ly):
        for x in range(lx):
            rows.append({"h": (y, x, y, (x + 1) % lx),
                         "v": (y, x, (y + 1) % ly, x),
                         "d": (y, x, (y + 1) % ly, (x + 1) % lx),
                         "ad": ((y + 1) % ly, x, y, (x + 1) % lx)}[kind])
    return torch.tensor(rows, dtype=torch.int64)


def _bond_tables_pbc(tps, tn, bonds, chi: int, trunc: TruncParams,
                     test_matrix: TestMatrix | None = None):
    """Amplitude tables [nc, Nb, d, d] of the two-site replacements on the
    bonds [Nb, 4]: entry (p, q) is the mantissa of tn with site 1 set to
    tps[y1, x1, p] and site 2 to tps[y2, x2, q], brought to the largest
    log-weight of its bond (ratios within a bond cancel the shared scale;
    the largest finite one, so that a non-finite entry does not take its
    bond's other entries with it). Every (chain, bond, p, q) network goes
    through one contraction."""
    nc, ly, lx = tn.shape[:3]
    d = tps.shape[2]
    nb = bonds.shape[0]
    y1, x1, y2, x2 = bonds.to(tn.device).unbind(1)
    ib = torch.arange(nb, device=tn.device)
    # [Nb, Ly, Lx, nc, p, q, ...]: bond and site axes first, so that one
    # advanced index sets site 1 (over p) and site 2 (over q) of each bond
    net = tn.permute(1, 2, 0, 3, 4, 5, 6)[None, :, :, :, None, None] \
        .expand(nb, ly, lx, nc, d, d, *tn.shape[3:]).clone()
    net[ib, y1, x1] = tps[y1, x1][:, None, :, None]
    net[ib, y2, x2] = tps[y2, x2][:, None, None, :]
    net = net.permute(3, 0, 4, 5, 1, 2, 6, 7, 8, 9)
    mant, logw = contract_pbc(net, chi, trunc, test_matrix=test_matrix)
    lw = torch.where(torch.isfinite(logw), logw,
                     torch.full_like(logw, float("-inf")))
    lmax = lw.reshape(nc, nb, d * d).amax(-1)[..., None, None]
    return mant * torch.exp(logw - lmax).to(mant.dtype)


def pbc_energy_and_holes(tps: torch.Tensor, config: torch.Tensor,
                         model: ModelTensors, chi: int, trunc: TruncParams,
                         with_holes: bool = True,
                         test_matrix: TestMatrix | None = None):
    """(E_loc [nc], holes [nc, Ly, Lx, u, l, d, r] or None, mantissa [nc],
    log|psi| [nc]) of configurations [nc, Ly, Lx] of a torus TPS
    [Ly, Lx, d, D, D, D, D] (real; the holes are autograd of a real
    mantissa). One-site terms from the holes, two-site terms (h_h, h_v,
    h_d, h_ad on the torus bonds) from the batched recomputes. Without
    holes and one-site terms the network is only contracted (the reference
    punches the holes all the same). The holes are returned with
    with_holes; O is holes / mantissa at the configuration."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    config = config.long()
    tn = project(tps, config)
    holes = None
    if with_holes or model.h_site is not None:
        holes, mant, logw = punch_all_holes_pbc(tn, chi, trunc,
                                                test_matrix=test_matrix)
    else:
        with torch.no_grad():
            mant, logw = contract_pbc(tn, chi, trunc,
                                      test_matrix=test_matrix)
    safe_mant = torch.where(mant == 0, torch.ones_like(mant), mant)
    rdt = tn.real.dtype if tn.is_complex() else tn.dtype
    e = torch.zeros(config.shape[0], dtype=rdt, device=tn.device)
    if model.h_site is not None:
        ratio1 = torch.einsum("nyxuldr,yxpuldr->nyxp", holes, tps) \
            / safe_mant[:, None, None, None]
        e = e + (model.h_site[config] * ratio1).sum((1, 2, 3))
    for name, kind in (("h_h", "h"), ("h_v", "v"), ("h_d", "d"),
                       ("h_ad", "ad")):
        h = getattr(model, name)
        if h is None:
            continue
        bonds = pbc_bonds(ly, lx, kind).to(tn.device)
        tables = _bond_tables_pbc(tps, tn, bonds, chi, trunc, test_matrix)
        c1 = config[:, bonds[:, 0], bonds[:, 1]]
        c2 = config[:, bonds[:, 2], bonds[:, 3]]
        psi_b = torch.gather(tables.reshape(*tables.shape[:2], d * d), 2,
                             (c1 * d + c2)[..., None])[..., 0]
        safe_b = torch.where(psi_b == 0, torch.ones_like(psi_b), psi_b)
        # an entry the Hamiltonian does not reach adds nothing, also where
        # its amplitude is not finite (a replaced pair whose exact
        # amplitude vanishes, so that its Grams are round-off, can fail
        # every Cholesky jitter in float32; ROADMAP section 3)
        hb = h[c1, c2]
        e = e + torch.where(hb != 0, hb * tables / safe_b[..., None, None],
                            torch.zeros_like(tables)).sum((1, 2, 3))
    log_abs = torch.log(torch.clamp(mant.abs(), min=torch.finfo(rdt).tiny)) \
        + logw
    return e, holes if with_holes else None, mant, log_abs


def local_energy_and_holes_pbc(tps: torch.Tensor, config: torch.Tensor,
                               model: ModelTensors, chi: int,
                               trunc: TruncParams, with_holes: bool = True,
                               test_matrix: TestMatrix | None = None
                               ) -> EnergyHoles:
    """E_loc, O, log|psi| and the mantissa of torus configurations
    [nc, Ly, Lx] (see :func:`pbc_energy_and_holes`)."""
    config = config.long()
    e, holes, mant, log_abs = pbc_energy_and_holes(
        tps, config, model, chi, trunc, with_holes, test_matrix)
    o_tensor = None
    if with_holes:
        o_tensor = o_tensor_of(holes, mant[:, None, None].expand(
            config.shape), config, tps.shape[2])
    return EnergyHoles(e, o_tensor, log_abs, mant)
