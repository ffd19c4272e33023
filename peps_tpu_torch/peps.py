"""Gamma/Lambda PEPS and OBC simple update (port of ``peps_tpu/peps.py``).

Layouts as in the JAX package: gammas [Ly, Lx, d, D, D, D, D] with site axes
(p, u, l, d, r); lam_v [Ly+1, Lx, D] (rows 0 and Ly are boundary bonds =
onehot(0)); lam_h [Ly, Lx+1, D]. Trotter gates go in the same checkerboard
schedule: even, then odd horizontal bonds, then the two vertical
sublattices through the transposed lattice, each group one batched
QR -> gate -> SVD step. Batched QR/SVD run in ``torch.linalg``. On the
torus (:func:`product_peps_pbc`: lam_v and lam_h [Ly, Lx, D], every bond
real) the groups are the site-disjoint ring-bond groups of
:func:`_pbc_bond_groups`, the wrap bonds in a third group on odd rings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.lattice import boundary_mask
from peps_tpu_torch.linalg import (TruncParams, blq, expm_taylor,
                                   safe_inverse, truncated_svd)


class PEPS(NamedTuple):
    """gammas [Ly, Lx, d, D, D, D, D]; lam_v [Ly+1, Lx, D]; lam_h [Ly, Lx+1, D]."""
    gammas: torch.Tensor
    lam_v: torch.Tensor
    lam_h: torch.Tensor

    @property
    def ly(self):
        return self.gammas.shape[0]

    @property
    def lx(self):
        return self.gammas.shape[1]

    @property
    def phys_dim(self):
        return self.gammas.shape[2]

    @property
    def bond_dim(self):
        return self.gammas.shape[3]


def product_peps(ly: int, lx: int, bond_dim: int, occupancy, phys_dim: int,
                 dtype=torch.float32, device=None) -> PEPS:
    """Product-state PEPS |occupancy>; occupancy [Ly, Lx] of basis indices.
    device None: the current CUDA device (see :mod:`peps_tpu_torch.device`)."""
    device = resolve_device(device)
    occ = torch.as_tensor(np.asarray(occupancy), device=device).long()
    g = torch.zeros((ly, lx, phys_dim) + (bond_dim,) * 4, dtype=dtype,
                    device=device)
    g[:, :, :, 0, 0, 0, 0] = torch.nn.functional.one_hot(occ, phys_dim).to(dtype)
    lam_v = torch.zeros((ly + 1, lx, bond_dim), dtype=dtype, device=device)
    lam_h = torch.zeros((ly, lx + 1, bond_dim), dtype=dtype, device=device)
    lam_v[..., 0] = 1.0
    lam_h[..., 0] = 1.0
    return PEPS(g, lam_v, lam_h)


def to_tps(peps: PEPS) -> torch.Tensor:
    """Absorb sqrt(lambda) of every bond into the site tensors."""
    g, lam_v, lam_h = peps
    ly, lx = g.shape[:2]
    su, sd = torch.sqrt(lam_v[:ly]), torch.sqrt(lam_v[1:])
    sl, sr = torch.sqrt(lam_h[:, :lx]), torch.sqrt(lam_h[:, 1:])
    a = torch.einsum("yxpuldr,yxu,yxl,yxd,yxr->yxpuldr", g, su, sl, sd, sr)
    mask = torch.as_tensor(boundary_mask(ly, lx, g.shape[2], g.shape[3]),
                           dtype=a.dtype, device=a.device)
    return a * mask


def product_peps_pbc(ly: int, lx: int, bond_dim: int, occupancy,
                     phys_dim: int, dtype=torch.float32, device=None) -> PEPS:
    """Product-state PEPS |occupancy> on the torus: lam_v [Ly, Lx, D]
    (lam_v[y, x] the bond above site (y, x), row 0's wrapping to the
    bottom) and lam_h [Ly, Lx, D] (the bond left of (y, x)); the layout
    tells the torus from the OBC state (lam_v has Ly rows, not Ly + 1)."""
    device = resolve_device(device)
    occ = torch.as_tensor(np.asarray(occupancy), device=device).long()
    g = torch.zeros((ly, lx, phys_dim) + (bond_dim,) * 4, dtype=dtype,
                    device=device)
    g[:, :, :, 0, 0, 0, 0] = torch.nn.functional.one_hot(
        occ, phys_dim).to(dtype)
    lam = torch.zeros((ly, lx, bond_dim), dtype=dtype, device=device)
    lam[..., 0] = 1.0
    return PEPS(g, lam, lam.clone())


def is_pbc(peps: PEPS) -> bool:
    """True iff the state has the torus lambda layout."""
    return peps.lam_v.shape[0] == peps.gammas.shape[0]


def to_tps_pbc(peps: PEPS) -> torch.Tensor:
    """Absorb sqrt(lambda) of every torus bond into the site tensors (no
    boundary mask: every bond is real)."""
    g, lam_v, lam_h = peps
    su, sl = torch.sqrt(lam_v), torch.sqrt(lam_h)
    sd = torch.roll(su, -1, dims=0)      # the bond below is above (y+1)%Ly
    sr = torch.roll(sl, -1, dims=1)      # the bond right is left of (x+1)%Lx
    return torch.einsum("yxpuldr,yxu,yxl,yxd,yxr->yxpuldr", g, su, sl, sd, sr)


def _transpose_peps(peps: PEPS) -> PEPS:
    """Reflect across the main diagonal: (y,x)->(x,y), u<->l, d<->r."""
    return PEPS(peps.gammas.permute(1, 0, 2, 4, 3, 6, 5),
                peps.lam_h.permute(1, 0, 2), peps.lam_v.permute(1, 0, 2))


class GateMetrics(NamedTuple):
    bond_energy: torch.Tensor
    trunc_err: torch.Tensor
    log_norm: torch.Tensor


def _apply_gate_batch(gA, gB, lu_a, ll_a, ld_a, lu_b, ld_b, lr_b, lam_mid,
                      gate, h_bond, trunc: TruncParams):
    """Two-site gate on a batch of horizontal bonds (QR -> theta -> gate ->
    truncated SVD -> split -> lambda^-1). gA/gB [N, d, D, D, D, D] (A left),
    l*_ [N, D], gate/h_bond [N, d, d, d, d]. Returns (gA', gB', lam', metrics)."""
    n, d, D = gA.shape[0], gA.shape[1], gA.shape[3]
    k = min(D ** 3, d * D)
    a = torch.einsum("npuldr,nu,nl,nd->npuldr", gA, lu_a, ll_a, ld_a)
    b = torch.einsum("npuldr,nu,nd,nr->npuldr", gB, lu_b, ld_b, lr_b)

    a_mat = a.permute(0, 2, 3, 4, 1, 5).reshape(n, D ** 3, d * D)
    qa, ra = torch.linalg.qr(a_mat, mode="reduced")
    ra = ra.reshape(n, k, d, D)
    b_mat = b.permute(0, 1, 3, 2, 4, 5).reshape(n, d * D, D ** 3)
    rb_mat, qb = blq(b_mat)
    rb = rb_mat.reshape(n, d, D, k)

    theta = torch.einsum("napr,nr,nqrb->napqb", ra, lam_mid, rb)
    theta_g = torch.einsum("nPQpq,napqb->naPQb", gate, theta)
    hth = torch.einsum("nPQpq,napqb->naPQb", h_bond, theta_g)
    num = torch.einsum("napqb,napqb->n", theta_g.conj(), hth)
    den = torch.einsum("napqb,napqb->n", theta_g.conj(), theta_g)
    rdt = den.real.dtype
    bond_e = num.real / torch.clamp(den.real, min=torch.finfo(rdt).tiny)

    u, s, vh, errs = truncated_svd(theta_g.reshape(n, k * d, d * k), trunc)
    norm = torch.linalg.vector_norm(s, dim=1)
    lam_new = s / torch.clamp(norm[:, None], min=torch.finfo(s.dtype).tiny)

    ga = torch.einsum("nik,nkPr->niPr", qa, u.reshape(n, k, d, D))
    ga = ga.reshape(n, D, D, D, d, D).permute(0, 4, 1, 2, 3, 5)
    ga = torch.einsum("npuldr,nu,nl,nd->npuldr", ga, safe_inverse(lu_a),
                      safe_inverse(ll_a), safe_inverse(ld_a))
    gb = torch.einsum("nmQk,nki->nmQi", vh.reshape(n, D, d, k), qb)
    gb = gb.reshape(n, D, d, D, D, D).permute(0, 2, 3, 1, 4, 5)
    gb = torch.einsum("npuldr,nu,nd,nr->npuldr", gb, safe_inverse(lu_b),
                      safe_inverse(ld_b), safe_inverse(lr_b))
    return ga, gb, lam_new, GateMetrics(bond_e, errs.max(),
                                        torch.log(norm).sum())


def _gather_h_bonds(peps: PEPS, xs):
    """Batch inputs for horizontal bonds (y, x)-(y, x+1), x in xs."""
    g, lam_v, lam_h = peps
    ly = g.shape[0]
    D = g.shape[3]
    xs = torch.as_tensor(xs, device=g.device)
    gA = g[:, xs].reshape(-1, *g.shape[2:])
    gB = g[:, xs + 1].reshape(-1, *g.shape[2:])
    lu_a = lam_v[:ly, xs].reshape(-1, D)
    ld_a = lam_v[1:, xs].reshape(-1, D)
    ll_a = lam_h[:, xs].reshape(-1, D)
    lam_mid = lam_h[:, xs + 1].reshape(-1, D)
    lu_b = lam_v[:ly, xs + 1].reshape(-1, D)
    ld_b = lam_v[1:, xs + 1].reshape(-1, D)
    lr_b = lam_h[:, xs + 2].reshape(-1, D)
    return gA, gB, lu_a, ll_a, ld_a, lu_b, ld_b, lr_b, lam_mid


def _apply_h_sublattice(peps: PEPS, xs, gate, h_bond, trunc: TruncParams):
    """Gates on all horizontal bonds starting at the (site-disjoint) columns
    xs; gate/h_bond [Ly, Lx-1, d, d, d, d]."""
    g, lam_v, lam_h = peps
    ly, d = g.shape[0], g.shape[2]
    xs_t = torch.as_tensor(xs, device=g.device)
    gate_b = gate[:, xs_t].reshape(-1, d, d, d, d)
    h_b = h_bond[:, xs_t].reshape(-1, d, d, d, d)
    ga, gb, lam_new, metrics = _apply_gate_batch(
        *_gather_h_bonds(peps, xs), gate_b, h_b, trunc)
    nb = len(xs)
    g = g.clone()
    lam_h = lam_h.clone()
    g[:, xs_t] = ga.reshape(ly, nb, *g.shape[2:])
    g[:, xs_t + 1] = gb.reshape(ly, nb, *g.shape[2:])
    # the singular values are real; a complex state keeps complex lambdas
    lam_h[:, xs_t + 1] = lam_new.reshape(ly, nb, -1).to(lam_h.dtype)
    return PEPS(g, lam_v, lam_h), metrics


def _pbc_bond_groups(l: int) -> list:
    """Site-disjoint groups of the ring bonds (x, (x+1)%l): two on an even
    ring, and on an odd ring a third holding the wrap bond alone (an odd
    cycle is not 2-colourable)."""
    if l < 2:
        return []
    if l % 2 == 0:
        groups = [tuple(range(0, l, 2)), tuple(range(1, l, 2))]
    else:
        groups = [tuple(range(0, l - 1, 2)), tuple(range(1, l - 1, 2)),
                  (l - 1,)]
    return [g for g in groups if g]


def _gather_h_bonds_pbc(peps: PEPS, xs):
    """Batch inputs for the torus bonds (y, x)-(y, (x+1)%Lx), x in xs."""
    g, lam_v, lam_h = peps
    lx, D = g.shape[1], g.shape[3]
    xs = torch.as_tensor(xs, device=g.device)
    x1, x2 = (xs + 1) % lx, (xs + 2) % lx
    lam_v_dn = torch.roll(lam_v, -1, dims=0)     # the bond below each site
    gA = g[:, xs].reshape(-1, *g.shape[2:])
    gB = g[:, x1].reshape(-1, *g.shape[2:])
    return (gA, gB, lam_v[:, xs].reshape(-1, D), lam_h[:, xs].reshape(-1, D),
            lam_v_dn[:, xs].reshape(-1, D), lam_v[:, x1].reshape(-1, D),
            lam_v_dn[:, x1].reshape(-1, D), lam_h[:, x2].reshape(-1, D),
            lam_h[:, x1].reshape(-1, D))


def _apply_h_sublattice_pbc(peps: PEPS, xs, gate, h_bond, trunc: TruncParams):
    """Gates on the torus bonds of one site-disjoint ring group xs
    (:func:`_pbc_bond_groups`); gate/h_bond [Ly, Lx, d, d, d, d], bond x
    joining (y, x) and (y, (x+1)%Lx)."""
    g, lam_v, lam_h = peps
    ly, lx, d = g.shape[0], g.shape[1], g.shape[2]
    xs_t = torch.as_tensor(xs, device=g.device)
    x1 = (xs_t + 1) % lx
    gate_b = gate[:, xs_t].reshape(-1, d, d, d, d)
    h_b = h_bond[:, xs_t].reshape(-1, d, d, d, d)
    ga, gb, lam_new, metrics = _apply_gate_batch(
        *_gather_h_bonds_pbc(peps, xs), gate_b, h_b, trunc)
    nb = len(xs)
    g = g.clone()
    lam_h = lam_h.clone()
    g[:, xs_t] = ga.reshape(ly, nb, *g.shape[2:])
    g[:, x1] = gb.reshape(ly, nb, *g.shape[2:])
    lam_h[:, x1] = lam_new.reshape(ly, nb, -1).to(lam_h.dtype)
    return PEPS(g, lam_v, lam_h), metrics


def simple_update_sweep_pbc(peps: PEPS, gate_h, gate_v, h_bond_h, h_bond_v,
                            trunc: TruncParams):
    """One torus sweep: the ring-bond groups of every row, then (through
    the transposed lattice) of every column; gate_v/h_bond_v in the
    transposed frame [Lx, Ly, ...]. Returns (peps', (e_sum, log_norm, max
    trunc_err))."""
    rdt = peps.gammas.real.dtype
    dev = peps.gammas.device
    e_sum = torch.zeros((), dtype=rdt, device=dev)
    log_norm = torch.zeros((), dtype=rdt, device=dev)
    terr = torch.zeros((), dtype=rdt, device=dev)
    for frame, (gate, hb) in enumerate(((gate_h, h_bond_h),
                                        (gate_v, h_bond_v))):
        if frame == 1:
            peps = _transpose_peps(peps)
        for xs in _pbc_bond_groups(peps.lx):
            peps, m = _apply_h_sublattice_pbc(peps, xs, gate, hb, trunc)
            e_sum = e_sum + m.bond_energy.sum()
            log_norm = log_norm + m.log_norm
            terr = torch.maximum(terr, m.trunc_err)
    return _transpose_peps(peps), (e_sum, log_norm, terr)


def simple_update_sweep(peps: PEPS, gate_h, gate_v, h_bond_h, h_bond_v,
                        trunc: TruncParams):
    """One checkerboard sweep; gate_v/h_bond_v in the transposed frame
    [Lx, Ly-1, ...]. Returns (peps', (e_sum, log_norm, max trunc_err))."""
    rdt = peps.gammas.real.dtype
    dev = peps.gammas.device
    e_sum = torch.zeros((), dtype=rdt, device=dev)
    log_norm = torch.zeros((), dtype=rdt, device=dev)
    terr = torch.zeros((), dtype=rdt, device=dev)
    for frame, (gate, hb) in enumerate(((gate_h, h_bond_h),
                                        (gate_v, h_bond_v))):
        if frame == 1:
            peps = _transpose_peps(peps)
        lx = peps.lx
        for xs in (tuple(range(0, lx - 1, 2)), tuple(range(1, lx - 1, 2))):
            if not xs:
                continue
            peps, m = _apply_h_sublattice(peps, xs, gate, hb, trunc)
            e_sum = e_sum + m.bond_energy.sum()
            log_norm = log_norm + m.log_norm
            terr = torch.maximum(terr, m.trunc_err)
    return _transpose_peps(peps), (e_sum, log_norm, terr)


@dataclasses.dataclass(frozen=True)
class SimpleUpdateParams:
    """The reference's fields and defaults. energy_abs_tol > 0 turns on
    the energy-stall stop (see :func:`simple_update`); lambda_rel_tol is
    carried but unused, as in the reference."""
    steps: int
    tau: float
    trunc: TruncParams
    energy_abs_tol: float = 0.0
    lambda_rel_tol: float = 0.0
    patience: int = 5
    min_steps: int = 10


class SimpleUpdateResult(NamedTuple):
    peps: PEPS
    estimated_e0: float
    estimated_en: float
    executed_steps: int
    converged: bool
    energy_history: list


def run_with_stall_stop(peps, params: SimpleUpdateParams, one_step,
                        step_observer: Callable | None, tau: float):
    """The step loop of the simple updates: one_step(peps) -> (peps, e0,
    log_norm, trunc_err) as tensors. Reads the scalars back to the host once
    per step, calls step_observer(step=, e0=, en=, trunc_err=) and stops
    once |e0 - e0_prev| < energy_abs_tol for ``patience`` steps in a row,
    counting from ``min_steps`` (energy_abs_tol 0: never). Returns the
    SimpleUpdateResult, executed_steps the last step run."""
    history, e_prev, stall, converged = [], None, 0, False
    step, en = 0, float("nan")
    for step in range(1, params.steps + 1):
        peps, e0_t, log_norm, terr = one_step(peps)
        e0, en = float(e0_t), -float(log_norm) / tau
        history.append(e0)
        if step_observer is not None:
            step_observer(step=step, e0=e0, en=en, trunc_err=float(terr))
        if params.energy_abs_tol > 0 and e_prev is not None \
                and step >= params.min_steps:
            if abs(e0 - e_prev) < params.energy_abs_tol:
                stall += 1
                if stall >= params.patience:
                    converged = True
                    break
            else:
                stall = 0
        e_prev = e0
    return SimpleUpdateResult(peps, history[-1] if history else float("nan"),
                              en, step, converged, history)


def simple_update(peps: PEPS, h_bond_h, h_bond_v, params: SimpleUpdateParams,
                  step_observer: Callable | None = None
                  ) -> SimpleUpdateResult:
    """Imaginary-time evolution. h_bond_h: [d,d,d,d] uniform or per bond
    [Ly, Lx-1, d,d,d,d] (OBC) / [Ly, Lx, ...] (torus, bond x wrapping to
    (x+1)%Lx); h_bond_v: [d,d,d,d] or [Ly-1, Lx, ...] / [Ly, Lx, ...]
    (numpy arrays or tensors; :func:`fold_site_into_bonds` absorbs a
    one-site term on the open lattice). A torus state
    (:func:`product_peps_pbc`, told by its lambda layout) takes the torus
    sweep. step_observer(step=, e0=, en=, trunc_err=) is called after each
    step; the energy-stall stop is the reference's
    (``SimpleUpdateParams``)."""
    d, ly, lx = peps.phys_dim, peps.ly, peps.lx
    pbc = is_pbc(peps)
    nhx, nvy = (lx, ly) if pbc else (lx - 1, ly - 1)
    dt, dev = peps.gammas.dtype, peps.gammas.device
    hh, hv = (torch.as_tensor(h if isinstance(h, torch.Tensor)
                              else np.asarray(h), dtype=dt, device=dev)
              for h in (h_bond_h, h_bond_v))
    if hh.ndim == 4:
        hh = hh.expand(ly, nhx, d, d, d, d)
    if hv.ndim == 4:
        hv = hv.expand(nvy, lx, d, d, d, d)
    tau = params.tau
    gate_h = expm_taylor(-tau * hh.reshape(-1, d * d, d * d)) \
        .reshape(ly, nhx, d, d, d, d)
    gate_v = expm_taylor(-tau * hv.reshape(-1, d * d, d * d)) \
        .reshape(nvy, lx, d, d, d, d)
    hv_t = hv.permute(1, 0, 2, 3, 4, 5)
    gate_v_t = gate_v.permute(1, 0, 2, 3, 4, 5)
    sweep = simple_update_sweep_pbc if pbc else simple_update_sweep

    def one_step(p):
        p, (e0, log_norm, terr) = sweep(
            p, gate_h, gate_v_t, hh, hv_t, params.trunc)
        return p, e0, log_norm, terr

    return run_with_stall_stop(peps, params, one_step, step_observer, tau)


def fold_site_into_bonds(h_bond_h, h_bond_v, h_site, ly: int, lx: int):
    """Fold a uniform one-site term exactly into per-bond Hamiltonians (OBC):
    numpy arrays h_h [Ly, Lx-1, d,d,d,d] and h_v [Ly-1, Lx, d,d,d,d] whose
    bond sum is the sum of the bond terms plus h_site on every site. Each
    site (y, x) gives h_site / z(y, x) to each of its z(y, x) bonds, so the
    fold is exact on any rectangle."""
    hs = np.asarray(h_site)
    hb_h, hb_v = np.asarray(h_bond_h), np.asarray(h_bond_v)
    d = hs.shape[0]
    eye = np.eye(d)
    yy, xx = np.indices((ly, lx))
    z = ((yy > 0).astype(int) + (yy < ly - 1) + (xx > 0) + (xx < lx - 1))
    dt = np.result_type(hb_h, hb_v, hs)

    def fold(hb, z1, z2):
        left = np.einsum("ac,bd->abcd", hs, eye)
        right = np.einsum("ac,bd->abcd", eye, hs)
        return (hb + left / z1[..., None, None, None, None]
                + right / z2[..., None, None, None, None]).astype(dt)

    return (fold(hb_h, z[:, :-1], z[:, 1:]),
            fold(hb_v, z[:-1, :], z[1:, :]))
