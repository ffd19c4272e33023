"""Fermionic (Z2-graded) PEPS and the fermionic simple update (port of
``peps_tpu/fermion/peps.py``).

Representation: the bosonic port's dense Gamma/Lambda tensors
([Ly, Lx, d, D, D, D, D], axes p,u,l,d,r) plus a static ``FermionSpace``
(physical parities and a fixed even/odd split of every virtual bond,
D = d_even + d_odd). Site tensors are parity-even; odd occupations are made
even by routing the cumulative parity through the virtual bonds along the
snake path (:func:`product_fermion_peps`). The optional ``U1Charges``
resolve every bond into particle-number flux sectors, so a truncation keeps
the particle number exactly.

The update is the reference's checkerboard of two-site projections; the
pairs of one sublattice group are one batch through the graded algebra
(:mod:`peps_tpu_torch.fermion.graded`, batched over the leading axis where
the reference maps with ``vmap``) and one batched ``torch.linalg`` SVD or
QR per flux sector. ``qr_reduce`` (default) takes the reference's
QR-QR-gate-SVD reduction: the same singular spectrum at a much smaller SVD.
State semantics, signs included: :mod:`peps_tpu_torch.fermion.exact`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.fermion.exact import snake_order
from peps_tpu_torch.fermion.graded import (GT, charged_svd_truncated,
                                           gcontract, graded_svd_truncated,
                                           gtranspose, operator_gt,
                                           parity_mask, sector_lq, sector_qr,
                                           split_parity)
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.lattice import boundary_mask
from peps_tpu_torch.linalg import expm_taylor
from peps_tpu_torch.peps import (PEPS, SimpleUpdateParams, SimpleUpdateResult,
                                 fold_site_into_bonds, run_with_stall_stop,
                                 to_tps)


@dataclasses.dataclass(frozen=True)
class FermionSpace:
    """Static graded structure: physical parities + bond parity split."""
    phys_parity: tuple      # len d, 0/1
    d_even: int
    d_odd: int

    @property
    def bond_dim(self):
        return self.d_even + self.d_odd

    @property
    def bond_parity(self):
        return split_parity(self.d_even, self.d_odd)


def space_for_model(model, bond_dim: int) -> FermionSpace:
    """Default space: parity from n_up + n_dn; even/odd split D/2 each."""
    d = model.phys_dim
    pp = tuple(int(model.n_up[i] + model.n_dn[i]) % 2 for i in range(d))
    de = (bond_dim + 1) // 2
    return FermionSpace(pp, de, bond_dim - de)


# ---------------------------------------------------------------------------
# optional U(1) particle-number resolution: a static charge layout per bond
# and static per-site covariance constants kappa
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class U1Charges:
    """phys_charge[s]: particle number of local state s; bond_charge: the
    static per-slot charge layout (q % 2 equals the bond parity layout);
    keep: ((q, count), ...) in layout order; kappa[y][x]: the per-site
    covariance constants fixed by the initial occupancy's snake routing."""
    phys_charge: tuple
    bond_charge: tuple
    keep: tuple
    kappa: tuple

    @property
    def keep_counts(self):
        return tuple(c for _, c in self.keep)

    @property
    def sector_charges(self):
        return tuple(q for q, _ in self.keep)


def u1_bond_layout(space: FermionSpace):
    """The default static charge layout of the space's parity split: two
    even slots at q = 0, the other even slots alternating q = +2 / -2, the
    odd slots split between q = +1 and q = -1."""
    de, do = space.d_even, space.d_odd
    n0 = min(de, 2)
    n_p2 = (de - n0 + 1) // 2
    ext = [2] * n_p2 + [-2] * (de - n0 - n_p2)
    even_charges = (0,) * n0 + tuple(ext)
    c_plus = (do + 1) // 2
    charges = even_charges + (1,) * c_plus + (-1,) * (do - c_plus)
    keep = [(0, n0)]
    if ext.count(2):
        keep.append((2, ext.count(2)))
    if ext.count(-2):
        keep.append((-2, ext.count(-2)))
    keep.append((1, c_plus))
    if do - c_plus:
        keep.append((-1, do - c_plus))
    return charges, tuple(keep)


def _route_legs(order, k, y, x):
    """(incoming leg, outgoing leg) of the snake path at its k-th site."""
    leg_in = leg_out = None
    if k > 0:
        py, px = order[k - 1]
        leg_in = "u" if py == y - 1 else ("l" if px == x - 1 else "r")
    if k + 1 < len(order):
        ny, nx = order[k + 1]
        leg_out = "d" if ny == y + 1 else ("r" if nx == x + 1 else "l")
    return leg_in, leg_out


def u1_charges_for(model, space: FermionSpace, occupancy) -> U1Charges:
    """The static U(1) metadata of an initial occupancy: per-site kappa from
    the snake charge routing of :func:`product_fermion_peps` (routed slot =
    first odd slot, charge +1), so that the product state is exactly
    U(1)-covariant with these constants."""
    d = model.phys_dim
    qp = tuple(int(model.n_up[i] + model.n_dn[i]) for i in range(d))
    charges, keep = u1_bond_layout(space)
    occ = np.asarray(occupancy)
    ly, lx = occ.shape
    pp = space.phys_parity
    order = snake_order(ly, lx)
    sgn = {"u": -1, "l": -1, "d": 1, "r": 1}    # primal legs count +
    kappa = np.zeros((ly, lx), dtype=np.int64)
    c = 0
    for k, (y, x) in enumerate(order):
        n_s = int(occ[y, x])
        c_new = (c + pp[n_s]) % 2
        kap = qp[n_s]
        leg_in, leg_out = _route_legs(order, k, y, x)
        if leg_in is not None:
            kap += sgn[leg_in] * c
        if leg_out is not None:
            kap += sgn[leg_out] * c_new
        kappa[y, x] = kap
        c = c_new
    return U1Charges(qp, charges, keep, tuple(map(tuple, kappa.tolist())))


def _group_flux(groups, signs):
    """Signed charge sum over a fused group (row-major): flat int array of
    length prod(dims)."""
    qs = [np.asarray(q) for q in groups]
    tot = np.zeros([len(q) for q in qs], dtype=np.int64)
    for ax, (q, s) in enumerate(zip(qs, signs)):
        shape = [1] * len(qs)
        shape[ax] = len(q)
        tot = tot + s * q.reshape(shape)
    return tot.reshape(-1)


def _u1_bond_masks(charges: U1Charges, space: FermionSpace, orient: str,
                   ly: int, lx: int):
    """Per-bond row / column flux-sector masks of the full pair SVD,
    (row_masks [Ny, Nx, S, R], col_masks [Ny, Nx, S, C]) numpy. Sector q:
    rows with A's flux kappaA - q, columns with B's flux q + kappaB."""
    qp, qb = charges.phys_charge, charges.bond_charge
    g0 = _group_flux([qp, qb, qb, qb], [1, -1, -1, 1])
    h0 = _group_flux([qp, qb, qb, qb], [1, -1, 1, 1])
    kap = np.asarray(charges.kappa)
    if orient == "h":
        ka, kb = kap[:, :lx - 1], kap[:, 1:]
    else:
        ka, kb = kap[:ly - 1], kap[1:]
    secs = np.asarray(charges.sector_charges)
    row_masks = (g0[None, None, None, :]
                 == (ka[:, :, None] - secs[None, None, :])[..., None])
    col_masks = (h0[None, None, None, :]
                 == (kb[:, :, None] + secs[None, None, :])[..., None])
    return row_masks.astype(np.float64), col_masks.astype(np.float64)


class _ReducedLayout(NamedTuple):
    """Static metadata of the QR-reduced pair projection; inner bonds laid
    out sector-major (flux values for U(1), parities for Z2 only)."""
    cols_a: tuple        # per-sector col indices into (p, r_cut) fused
    rows_b: tuple        # per-sector row indices into (p, l_cut) fused
    sec_a: tuple         # sector flux values, A-side inner bond
    sec_b: tuple         # sector flux values, B-side inner bond
    pk_a: tuple          # inner-bond parities (per slot)
    pk_b: tuple
    svd_rm: tuple        # [S][d*Ka] static 0/1 row masks, core SVD
    svd_cm: tuple        # [S][d*Kb] static 0/1 col masks
    keep: tuple          # per-sector kept counts (sum = D)
    pbn: tuple           # new-bond parity layout
    a0: tuple            # spectator-group flux, A rows (u,l,d)/(u,l,r)
    d0: tuple            # spectator-group flux, B cols (u,d,r)/(l,d,r)


def _reduced_layout(space: FermionSpace,
                    charges: U1Charges | None) -> _ReducedLayout:
    """The static sector layout shared by both bond orientations."""
    pp = np.asarray(space.phys_parity)
    pb = np.asarray(space.bond_parity)
    if charges is None:
        qp, qb, mod = pp, pb, 2
        keep = (space.d_even, space.d_odd)
        pbn = split_parity(space.d_even, space.d_odd)
        sec_new = (0, 1)
    else:
        qp = np.asarray(charges.phys_charge)
        qb = np.asarray(charges.bond_charge)
        mod = 0
        keep = charges.keep_counts
        pbn = tuple(q % 2 for q in charges.bond_charge)
        sec_new = charges.sector_charges

    def red(x):
        return x % 2 if mod else x

    c0 = red(_group_flux([tuple(qp), tuple(qb)], [1, 1]))
    b0 = red(_group_flux([tuple(qp), tuple(qb)], [1, -1]))
    sec_a = tuple(sorted(set(c0.tolist())))
    sec_b = tuple(sorted(set(b0.tolist())))
    cols_a = tuple(tuple(np.where(c0 == t)[0].tolist()) for t in sec_a)
    rows_b = tuple(tuple(np.where(b0 == s)[0].tolist()) for s in sec_b)
    qk_a = np.concatenate([np.full(len(c), t, dtype=np.int64)
                           for t, c in zip(sec_a, cols_a)])
    qk_b = np.concatenate([np.full(len(r), -s, dtype=np.int64)
                           for s, r in zip(sec_b, rows_b)])
    pk_a = tuple((qk_a % 2).tolist())
    pk_b = tuple((qk_b % 2).tolist())
    rf = red(_group_flux([tuple(qp), tuple(qk_a)], [1, -1]))
    cf = red(_group_flux([tuple(qp), tuple(qk_b)], [1, 1]))
    svd_rm = tuple(tuple((rf == red(np.asarray(-q))).astype(np.float64)
                         .tolist()) for q in sec_new)
    svd_cm = tuple(tuple((cf == red(np.asarray(q))).astype(np.float64)
                         .tolist()) for q in sec_new)
    a0 = red(_group_flux([tuple(qb)] * 3, [-1, -1, 1]))
    d0 = red(_group_flux([tuple(qb)] * 3, [-1, 1, 1]))
    return _ReducedLayout(cols_a, rows_b, sec_a, sec_b, pk_a, pk_b,
                          svd_rm, svd_cm, keep, pbn,
                          tuple(a0.tolist()), tuple(d0.tolist()))


def _reduced_qr_masks(layout: _ReducedLayout, charges: U1Charges | None,
                      orient: str, ly: int, lx: int):
    """Row masks of the A-side sector QR and column masks of the B-side
    sector LQ: static [T/S, D^3] for Z2 only, per bond [Ny, Nx, T/S, D^3]
    for U(1). numpy."""
    a0, d0 = np.asarray(layout.a0), np.asarray(layout.d0)
    if charges is None:
        qr_rm = np.stack([(a0 % 2 == t % 2) for t in layout.sec_a])
        lq_cm = np.stack([(d0 % 2 == s % 2) for s in layout.sec_b])
        return qr_rm.astype(np.float64), lq_cm.astype(np.float64)
    kap = np.asarray(charges.kappa)
    if orient == "h":
        ka, kb = kap[:, :lx - 1], kap[:, 1:]
    else:
        ka, kb = kap[:ly - 1], kap[1:]
    secs_a, secs_b = np.asarray(layout.sec_a), np.asarray(layout.sec_b)
    qr_rm = (a0[None, None, None, :]
             == (ka[:, :, None] - secs_a[None, None, :])[..., None])
    lq_cm = (d0[None, None, None, :]
             == (kb[:, :, None] - secs_b[None, None, :])[..., None])
    return qr_rm.astype(np.float64), lq_cm.astype(np.float64)


def _sign_vec(parity, like):
    return torch.as_tensor(1.0 - 2.0 * np.asarray(parity, np.float64),
                           dtype=like.dtype, device=like.device)


def _bond_energy_diag(th: GT, h_bond, space: FermionSpace):
    """Mean-field bond energy <theta_g|h|theta_g> / <.|.> per pair (the
    simple update's diagnostic estimate)."""
    pp = space.phys_parity
    hh = operator_gt(h_bond.to(th.data.dtype), pp, pp, pp, pp)
    hth = gcontract(hh, (2, 3), th, (0, 1))
    n = th.nb
    num = (th.data.conj() * hth.data).flatten(n).sum(-1)
    den = (th.data.conj() * th.data).flatten(n).sum(-1)
    return num.real / torch.clamp(den.real,
                                  min=torch.finfo(den.real.dtype).tiny)


def _reduced_project(At: GT, Bt: GT, gate, h_bond, space: FermionSpace,
                     layout: _ReducedLayout, qr_rm, lq_cm):
    """QR-reduced tail of the graded pair projection, batched over pairs.
    At: A sites (row legs... | p, cut); Bt: B sites (p, cut | col legs...);
    lam_mid already absorbed into At's cut. Returns (ga_t (row legs...,
    PA', new), gb_t (new, PB', col legs...), lam_new, bond_e, trunc_err,
    log_norm), each batched."""
    pp, pb = space.phys_parity, space.bond_parity
    d, D = len(pp), space.bond_dim
    ka = sum(len(c) for c in layout.cols_a)
    kb = sum(len(r) for r in layout.rows_b)
    n = At.data.shape[0]

    q_a, r_a = sector_qr(At.data.reshape(n, D ** 3, d * D), layout.cols_a,
                         qr_rm)
    RA = GT((_sign_vec(layout.pk_a, r_a)[:, None] * r_a).reshape(n, ka, d, D),
            (layout.pk_a, pp, pb), (True, False, False))
    QA = GT(q_a.reshape(n, D, D, D, ka), (pb, pb, pb, layout.pk_a),
            At.dual[:3] + (False,))
    l_b, q_b = sector_lq(Bt.data.reshape(n, d * D, D ** 3), layout.rows_b,
                         lq_cm)
    LB = GT(l_b.reshape(n, d, D, kb), (pp, pb, layout.pk_b),
            (False, True, False))
    QB = GT((_sign_vec(layout.pk_b, q_b)[:, None] * q_b)
            .reshape(n, kb, D, D, D), (layout.pk_b, pb, pb, pb),
            (True,) + Bt.dual[2:])

    theta = gcontract(RA, (2,), LB, (1,))        # (k_a, pA, pB, k_b)
    G = operator_gt(gate.to(r_a.dtype), pp, pp, pp, pp)
    th = gcontract(G, (2, 3), theta, (1, 2))     # (PA', PB', k_a, k_b)
    bond_e = _bond_energy_diag(th, h_bond, space)
    tht = gtranspose(th, (0, 2, 1, 3))           # (PA', k_a | PB', k_b)
    mat = tht.data.reshape(n, d * ka, d * kb)
    rm = torch.as_tensor(np.asarray(layout.svd_rm), device=mat.device)
    cm = torch.as_tensor(np.asarray(layout.svd_cm), device=mat.device)
    u, s, vt, terr = charged_svd_truncated(mat, rm, cm, layout.keep)
    norm = torch.linalg.vector_norm(s, dim=-1)
    lam_new = s / torch.clamp(norm, min=torch.finfo(s.dtype).tiny)[:, None]
    pbn = layout.pbn
    U = GT(u.reshape(n, d, ka, len(pbn)), (pp, layout.pk_a, pbn),
           (False, True, False))
    ga_t = gcontract(QA, (3,), U, (1,))          # (rows..., PA', new)
    V = GT((_sign_vec(pbn, vt)[:, None] * vt).reshape(n, len(pbn), d, kb),
           (pbn, pp, layout.pk_b), (True, False, False))
    gb_t = gcontract(V, (2,), QB, (0,))          # (new, PB', cols...)
    return ga_t, gb_t, lam_new, bond_e, terr, torch.log(norm)


def product_fermion_peps(ly: int, lx: int, space: FermionSpace, occupancy,
                         dtype=torch.float64, device=None) -> PEPS:
    """The product state |occupancy> as an even graded PEPS: the cumulative
    occupation parity is routed through the virtual bonds along the snake
    path, so every site tensor stays parity-even. Needs an even total
    parity, and d_odd >= 1 where a prefix parity is odd. device None: the
    current CUDA device."""
    occ = np.asarray(occupancy)
    d = len(space.phys_parity)
    D = space.bond_dim
    pp = space.phys_parity
    total = sum(pp[int(occ[y, x])] for y in range(ly) for x in range(lx)) % 2
    assert total == 0, "product_fermion_peps needs even total parity"
    odd_slot = space.d_even          # first odd index of the bond layout
    g = np.zeros((ly, lx, d, D, D, D, D))
    lam_v = np.zeros((ly + 1, lx, D))
    lam_h = np.zeros((ly, lx + 1, D))
    lam_v[:, :, 0] = 1.0
    lam_h[:, :, 0] = 1.0
    order = snake_order(ly, lx)
    c = 0
    for k, (y, x) in enumerate(order):
        n_s = int(occ[y, x])
        c_new = (c + pp[n_s]) % 2
        idx = {"u": 0, "l": 0, "d": 0, "r": 0}
        leg_in, leg_out = _route_legs(order, k, y, x)
        if leg_in is not None and c:
            assert space.d_odd >= 1, "need d_odd >= 1 for parity routing"
            idx[leg_in] = odd_slot
        if leg_out is not None and c_new:
            assert space.d_odd >= 1, "need d_odd >= 1 for parity routing"
            idx[leg_out] = odd_slot
            # the path bond's Schmidt weight sits at the routed slot
            if leg_out == "d":
                lam_v[y + 1, x, 0], lam_v[y + 1, x, odd_slot] = 0.0, 1.0
            elif leg_out == "r":
                lam_h[y, x + 1, 0], lam_h[y, x + 1, odd_slot] = 0.0, 1.0
            else:       # "l": the bond between (y, x-1) and (y, x)
                lam_h[y, x, 0], lam_h[y, x, odd_slot] = 0.0, 1.0
        g[y, x, n_s, idx["u"], idx["l"], idx["d"], idx["r"]] = 1.0
        c = c_new
    device = resolve_device(device)
    return PEPS(*(torch.as_tensor(a, dtype=dtype, device=device)
                  for a in (g, lam_v, lam_h)))


def to_tps_fermion(peps: PEPS) -> torch.Tensor:
    """Absorb sqrt(lambda) into the sites: the lambdas are parity-neutral
    positive diagonals, so this is the bosonic ToTPS, sign-free."""
    return to_tps(peps)


# ---------------------------------------------------------------------------
# graded pair projections, batched over the pairs of a sublattice group
# ---------------------------------------------------------------------------

def _fused_parity(groups):
    """Row-major XOR fuse of a list of parity tuples."""
    ps = [np.asarray(p) for p in groups]
    tot = np.zeros([len(p) for p in ps], dtype=np.int64)
    for ax, p in enumerate(ps):
        shape = [1] * len(ps)
        shape[ax] = len(p)
        tot = tot + p.reshape(shape)
    return tuple((tot % 2).reshape(-1).tolist())


def _svd_split(th_data, space: FermionSpace, u1=None):
    """Blockwise truncated SVD of the gated pairs [n, P_A', legsA...,
    P_B', legsB...] (3 virtual legs a group), with the pairing sign of the
    new bond absorbed into vt. u1: optional (row_masks [n, S, R], col_masks
    [n, S, C], keep_counts, bond parity) for the flux-resolved SVD."""
    pp, pb = space.phys_parity, space.bond_parity
    d, D = len(pp), space.bond_dim
    n = th_data.shape[0]
    mat = th_data.reshape(n, d * D ** 3, d * D ** 3)
    if u1 is None:
        gp = _fused_parity([pp, pb, pb, pb])
        u, s, vt, terr, pbn = graded_svd_truncated(mat, gp, gp,
                                                   space.d_even, space.d_odd)
    else:
        row_masks, col_masks, keep_counts, pbn = u1
        u, s, vt, terr = charged_svd_truncated(mat, row_masks, col_masks,
                                               keep_counts)
    norm = torch.linalg.vector_norm(s, dim=-1)
    lam_new = s / torch.clamp(norm, min=torch.finfo(s.dtype).tiny)[:, None]
    vt = _sign_vec(pbn, vt)[:, None] * vt
    return (u.reshape(n, d, D, D, D, D), vt.reshape(n, D, d, D, D, D),
            lam_new, terr, torch.log(norm), pbn)


def _safe_inverse_rows(x, tol: float = 1e-10):
    """Elementwise pseudo-inverse of each bond vector x [n, D], the cutoff
    relative to that vector's max |x| (the reference's lambda^-1 guard,
    mapped over bonds)."""
    ax = x.abs()
    cutoff = tol * torch.clamp(ax.amax(-1, keepdim=True),
                               min=torch.finfo(ax.dtype).tiny)
    keep = ax > cutoff
    return torch.where(keep, 1.0 / torch.where(keep, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _absorb(g, legs, lams):
    """g [n, p, u, l, d, r] times the bond vectors lams [n, D] on ``legs``
    (a subset of "uldr")."""
    spec = "npuldr," + ",".join("n" + c for c in legs) + "->npuldr"
    return torch.einsum(spec, g, *lams)


def _release(g, legs, lams):
    return _absorb(g, legs, [_safe_inverse_rows(lam) for lam in lams])


_DUALS = (False, True, True, False, False)


def _pair_h(a, b, lams, gate, h_bond, space: FermionSpace, u1=None,
            reduced=None):
    """Graded two-site projection of horizontal pairs: a the LEFT sites,
    b the RIGHT ones [n, p, u, l, d, r]; lams (lu_a, ll_a, ld_a, lu_b,
    ld_b, lr_b, lam_mid) [n, D]; gate/h_bond [n, d, d, d, d] in the (A',
    B', A, B) graded layout. Returns (a', b', lam', bond_e, trunc_err,
    log_norm)."""
    lu_a, ll_a, ld_a, lu_b, ld_b, lr_b, lam_mid = lams
    pp, pb = space.phys_parity, space.bond_parity
    par5 = (pp, pb, pb, pb, pb)
    A = GT(_absorb(a, "uldr", (lu_a, ll_a, ld_a, lam_mid)), par5, _DUALS)
    B = GT(_absorb(b, "udr", (lu_b, ld_b, lr_b)), par5, _DUALS)
    if reduced is not None:
        layout, qr_rm, lq_cm = reduced
        ga_t, gb_t, lam_new, be, terr, ln = _reduced_project(
            gtranspose(A, (1, 2, 3, 0, 4)), gtranspose(B, (0, 2, 1, 3, 4)),
            gate, h_bond, space, layout, qr_rm, lq_cm)
        ga = gtranspose(ga_t, (3, 0, 1, 2, 4)).data    # p,u,l,d,r_new
        gb = gtranspose(gb_t, (1, 2, 0, 3, 4)).data    # p,u,l_new,d,r
    else:
        theta = gcontract(A, (4,), B, (2,))            # pA uA lA dA | pB uB dB rB
        G = operator_gt(gate.to(a.dtype), pp, pp, pp, pp)
        th = gcontract(G, (2, 3), theta, (0, 4))       # PA' PB' uA lA dA uB dB rB
        be = _bond_energy_diag(th, h_bond, space)
        th = gtranspose(th, (0, 2, 3, 4, 1, 5, 6, 7))
        ga, vt5, lam_new, terr, ln, pbn = _svd_split(th.data, space, u1)
        gb = gtranspose(GT(vt5, (pbn, pp, pb, pb, pb),
                           (True, False, True, False, False)),
                        (1, 2, 0, 3, 4)).data
    ga = _release(ga, "uld", (lu_a, ll_a, ld_a))
    gb = _release(gb, "udr", (lu_b, ld_b, lr_b))
    return ga, gb, lam_new, be, terr, ln


def _pair_v(a, b, lams, gate, h_bond, space: FermionSpace, u1=None,
            reduced=None):
    """Graded two-site projection of vertical pairs: a the UPPER sites
    (earlier in snake order), b the LOWER ones; lams (lu_a, ll_a, lr_a,
    ll_b, ld_b, lr_b, lam_mid) [n, D]."""
    lu_a, ll_a, lr_a, ll_b, ld_b, lr_b, lam_mid = lams
    pp, pb = space.phys_parity, space.bond_parity
    par5 = (pp, pb, pb, pb, pb)
    A = GT(_absorb(a, "uldr", (lu_a, ll_a, lam_mid, lr_a)), par5, _DUALS)
    B = GT(_absorb(b, "ldr", (ll_b, ld_b, lr_b)), par5, _DUALS)
    if reduced is not None:
        layout, qr_rm, lq_cm = reduced
        ga_t, gb_t, lam_new, be, terr, ln = _reduced_project(
            gtranspose(A, (1, 2, 4, 0, 3)), B, gate, h_bond, space, layout,
            qr_rm, lq_cm)
        ga = gtranspose(ga_t, (3, 0, 1, 4, 2)).data    # p,u,l,d_new,r
        gb = gtranspose(gb_t, (1, 0, 2, 3, 4)).data    # p,u_new,l,d,r
    else:
        theta = gcontract(A, (3,), B, (1,))            # pA uA lA rA | pB lB dB rB
        G = operator_gt(gate.to(a.dtype), pp, pp, pp, pp)
        th = gcontract(G, (2, 3), theta, (0, 4))
        be = _bond_energy_diag(th, h_bond, space)
        th = gtranspose(th, (0, 2, 3, 4, 1, 5, 6, 7))
        u5, vt5, lam_new, terr, ln, pbn = _svd_split(th.data, space, u1)
        ga = gtranspose(GT(u5, (pp, pb, pb, pb, pbn),
                           (False, True, True, False, False)),
                        (0, 1, 2, 4, 3)).data
        gb = gtranspose(GT(vt5, (pbn, pp, pb, pb, pb),
                           (True, False, True, False, False)),
                        (1, 0, 2, 3, 4)).data
    ga = _release(ga, "ulr", (lu_a, ll_a, lr_a))
    gb = _release(gb, "ldr", (ll_b, ld_b, lr_b))
    return ga, gb, lam_new, be, terr, ln


def _bond_rows(masks, idx, axis):
    """The per-bond masks [Ny, Nx, ...] of the bonds idx along axis (1 for
    horizontal groups, 0 for vertical), flattened to [n, ...]; static
    masks (no bond axes) pass through."""
    if masks is None or np.asarray(masks).ndim == 2:
        return masks
    m = np.take(np.asarray(masks), idx, axis=axis)
    return m.reshape(-1, *m.shape[2:])


def _apply_h_sublattice(peps: PEPS, xs, gate, h_bond, space: FermionSpace,
                        u1_masks=None, u1_meta=None, reduced=None):
    """Batched graded update of the site-disjoint horizontal bonds
    (y, x)-(y, x+1), x in xs, all rows. gate/h_bond [Ly, Lx-1, d,d,d,d];
    u1_masks: optional per-bond flux masks, u1_meta (keep_counts, bond
    parity); reduced: optional (_ReducedLayout, qr_rm, lq_cm) for the
    QR-reduced projection, which takes precedence."""
    g, lam_v, lam_h = peps
    ly, d, D = g.shape[0], g.shape[2], g.shape[3]
    xs_t = torch.as_tensor(xs, device=g.device)
    lams = (lam_v[:ly, xs_t], lam_h[:, xs_t], lam_v[1:, xs_t],
            lam_v[:ly, xs_t + 1], lam_v[1:, xs_t + 1], lam_h[:, xs_t + 2],
            lam_h[:, xs_t + 1])
    lams = tuple(lam.reshape(-1, D) for lam in lams)
    gate_b = gate[:, xs_t].reshape(-1, d, d, d, d)
    h_b = h_bond[:, xs_t].reshape(-1, d, d, d, d)
    u1 = red = None
    if reduced is not None:
        layout, qr_rm, lq_cm = reduced
        red = (layout, _bond_rows(qr_rm, xs, 1), _bond_rows(lq_cm, xs, 1))
    elif u1_masks is not None:
        u1 = (_bond_rows(u1_masks[0], xs, 1), _bond_rows(u1_masks[1], xs, 1),
              *u1_meta)
    ga, gb, lam_new, be, terr, ln = _pair_h(
        g[:, xs_t].reshape(-1, *g.shape[2:]),
        g[:, xs_t + 1].reshape(-1, *g.shape[2:]), lams, gate_b, h_b, space,
        u1, red)
    nb = len(xs)
    g, lam_h = g.clone(), lam_h.clone()
    g[:, xs_t] = ga.reshape(ly, nb, *g.shape[2:]).to(g.dtype)
    g[:, xs_t + 1] = gb.reshape(ly, nb, *g.shape[2:]).to(g.dtype)
    lam_h[:, xs_t + 1] = lam_new.reshape(ly, nb, -1).to(lam_h.dtype)
    return PEPS(g, lam_v, lam_h), be.sum(), terr.max(), ln.sum()


def _apply_v_sublattice(peps: PEPS, ys, gate, h_bond, space: FermionSpace,
                        u1_masks=None, u1_meta=None, reduced=None):
    """Batched graded update of the vertical bonds (y, x)-(y+1, x), y in
    ys, all columns."""
    g, lam_v, lam_h = peps
    lx, d, D = g.shape[1], g.shape[2], g.shape[3]
    ys_t = torch.as_tensor(ys, device=g.device)
    lams = (lam_v[ys_t], lam_h[ys_t][:, :lx], lam_h[ys_t][:, 1:],
            lam_h[ys_t + 1][:, :lx], lam_v[ys_t + 2], lam_h[ys_t + 1][:, 1:],
            lam_v[ys_t + 1])
    lams = tuple(lam.reshape(-1, D) for lam in lams)
    gate_b = gate[ys_t].reshape(-1, d, d, d, d)
    h_b = h_bond[ys_t].reshape(-1, d, d, d, d)
    u1 = red = None
    if reduced is not None:
        layout, qr_rm, lq_cm = reduced
        red = (layout, _bond_rows(qr_rm, ys, 0), _bond_rows(lq_cm, ys, 0))
    elif u1_masks is not None:
        u1 = (_bond_rows(u1_masks[0], ys, 0), _bond_rows(u1_masks[1], ys, 0),
              *u1_meta)
    ga, gb, lam_new, be, terr, ln = _pair_v(
        g[ys_t].reshape(-1, *g.shape[2:]),
        g[ys_t + 1].reshape(-1, *g.shape[2:]), lams, gate_b, h_b, space,
        u1, red)
    ny = len(ys)
    g, lam_v = g.clone(), lam_v.clone()
    g[ys_t] = ga.reshape(ny, lx, *g.shape[2:]).to(g.dtype)
    g[ys_t + 1] = gb.reshape(ny, lx, *g.shape[2:]).to(g.dtype)
    lam_v[ys_t + 1] = lam_new.reshape(ny, lx, -1).to(lam_v.dtype)
    return PEPS(g, lam_v, lam_h), be.sum(), terr.max(), ln.sum()


def fermion_sweep(peps: PEPS, gate_h, gate_v, h_h, h_v, space: FermionSpace,
                  u1_h=None, u1_v=None, u1_meta=None, reduced_h=None,
                  reduced_v=None):
    """One checkerboard sweep over all horizontal then vertical bonds.
    Returns (peps', (bond energy sum, log norm, max truncation error))."""
    ly, lx = peps.ly, peps.lx
    rdt = peps.gammas.real.dtype
    dev = peps.gammas.device
    e_sum = torch.zeros((), dtype=rdt, device=dev)
    log_norm = torch.zeros((), dtype=rdt, device=dev)
    terr = torch.zeros((), dtype=rdt, device=dev)
    groups = [(_apply_h_sublattice, xs, gate_h, h_h, u1_h, reduced_h)
              for xs in (tuple(range(0, lx - 1, 2)),
                         tuple(range(1, lx - 1, 2)))]
    groups += [(_apply_v_sublattice, ys, gate_v, h_v, u1_v, reduced_v)
               for ys in (tuple(range(0, ly - 1, 2)),
                          tuple(range(1, ly - 1, 2)))]
    for apply, idx, gate, hb, u1, red in groups:
        if not idx:
            continue
        peps, e, t, ln = apply(peps, idx, gate, hb, space, u1, u1_meta, red)
        e_sum, log_norm = e_sum + e, log_norm + ln
        terr = torch.maximum(terr, t.to(rdt))
    return peps, (e_sum, log_norm, terr)


def fermion_simple_update(peps: PEPS, model, space: FermionSpace,
                          params: SimpleUpdateParams,
                          step_observer: Callable | None = None,
                          charges: U1Charges | None = None,
                          qr_reduce: bool = True) -> SimpleUpdateResult:
    """Imaginary-time evolution of a fermionic PEPS (the reference's graded
    simple update). Gates are exp(-tau h2) of the second-quantized bond
    Hamiltonian in the graded ordered basis
    (:func:`peps_tpu_torch.fermion.gates.bond_h2`); one-site terms are
    folded into the bonds exactly. charges: optional U(1) metadata
    (:func:`u1_charges_for`); qr_reduce: the QR-reduced projection. The
    step loop and stop rule are the bosonic port's
    (:func:`peps_tpu_torch.peps.run_with_stall_stop`)."""
    from peps_tpu_torch.fermion.gates import bond_h2

    d, ly, lx = peps.phys_dim, peps.ly, peps.lx
    dt, dev = peps.gammas.dtype, peps.gammas.device
    hh, hv = bond_h2(model, "h"), bond_h2(model, "v")
    if model.h_site is not None:
        hh, hv = fold_site_into_bonds(hh, hv, model.h_site, ly, lx)
    else:
        hh = np.broadcast_to(hh, (ly, lx - 1, d, d, d, d))
        hv = np.broadcast_to(hv, (ly - 1, lx, d, d, d, d))
    hh_b = torch.as_tensor(np.array(hh), dtype=dt, device=dev)
    hv_b = torch.as_tensor(np.array(hv), dtype=dt, device=dev)
    tau = params.tau
    gate_h = expm_taylor(-tau * hh_b.reshape(-1, d * d, d * d)) \
        .reshape(ly, lx - 1, d, d, d, d)
    gate_v = expm_taylor(-tau * hv_b.reshape(-1, d * d, d * d)) \
        .reshape(ly - 1, lx, d, d, d, d)

    u1_h = u1_v = u1_meta = reduced_h = reduced_v = None
    if qr_reduce:
        layout = _reduced_layout(space, charges)
        reduced_h = (layout,) + _reduced_qr_masks(layout, charges, "h", ly,
                                                  lx)
        reduced_v = (layout,) + _reduced_qr_masks(layout, charges, "v", ly,
                                                  lx)
    elif charges is not None:
        u1_h = _u1_bond_masks(charges, space, "h", ly, lx)
        u1_v = _u1_bond_masks(charges, space, "v", ly, lx)
        u1_meta = (charges.keep_counts,
                   tuple(q % 2 for q in charges.bond_charge))
    if charges is not None:
        assert tuple(q % 2 for q in charges.bond_charge) \
            == space.bond_parity, "bond charges must refine the parity split"

    def one_step(p):
        p, (e0, log_norm, terr) = fermion_sweep(
            p, gate_h, gate_v, hh_b, hv_b, space, u1_h, u1_v, u1_meta,
            reduced_h, reduced_v)
        return p, e0, log_norm, terr

    return run_with_stall_stop(peps, params, one_step, step_observer, tau)


def expand_bond_dim_graded(tps: torch.Tensor, space: FermionSpace,
                           new_space: FermionSpace, noise: float = 0.0,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Embed a graded TPS into a larger bond space, keeping the state
    exactly: even slots 0..de-1 go to 0..de'-1, odd slots de..D-1 to
    de'..de'+do-1. noise > 0 seeds the new slots from ``generator`` (on
    the state's device) on parity-conserving entries only, boundary slots
    masked."""
    ly, lx, d = tps.shape[0], tps.shape[1], tps.shape[2]
    de, do = space.d_even, space.d_odd
    ne, no = new_space.d_even, new_space.d_odd
    assert ne >= de and no >= do, ((de, do), (ne, no))
    assert new_space.phys_parity == space.phys_parity
    dn = ne + no
    idx = torch.as_tensor(np.concatenate([np.arange(de), ne + np.arange(do)]),
                          device=tps.device)
    out = torch.zeros((ly, lx, d) + (dn,) * 4, dtype=tps.dtype,
                      device=tps.device)
    out[:, :, :, idx[:, None, None, None], idx[None, :, None, None],
        idx[None, None, :, None], idx[None, None, None, :]] = tps
    if noise > 0.0:
        assert generator is not None, "noise > 0 needs a torch.Generator"
        pb = new_space.bond_parity
        pmask = parity_mask(GT(out[0, 0], (new_space.phys_parity,)
                               + (pb,) * 4, _DUALS))
        keep_old = torch.zeros(out.shape, dtype=torch.bool,
                               device=tps.device)
        keep_old[:, :, :, idx[:, None, None, None], idx[None, :, None, None],
                 idx[None, None, :, None], idx[None, None, None, :]] = True
        if tps.is_complex():
            rdt = tps.real.dtype
            full = torch.complex(
                torch.randn(out.shape, generator=generator, dtype=rdt,
                            device=generator.device),
                torch.randn(out.shape, generator=generator, dtype=rdt,
                            device=generator.device)).to(tps.device)
        else:
            full = torch.randn(out.shape, generator=generator,
                               dtype=tps.dtype,
                               device=generator.device).to(tps.device)
        rdt = tps.real.dtype
        bmask = torch.as_tensor(boundary_mask(ly, lx, d, dn), dtype=rdt,
                                device=tps.device)
        out = out + torch.where(keep_old, torch.zeros_like(full),
                                full * noise) \
            * torch.as_tensor(pmask, dtype=rdt, device=tps.device) * bmask
    return out
