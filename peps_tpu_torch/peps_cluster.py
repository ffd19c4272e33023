"""Three-site L-cluster simple update for NNN and triangular models (port of
``peps_tpu/peps_cluster.py``).

One batched kernel updates the canonical L-shaped cluster

    A=(y,x) --h-- B=(y,x+1)
                   |v
                  C=(y+1,x+1)

(QR on A, LQ on C, the 3-site gate, two truncated SVDs, lambda^-1), over
the four site-disjoint plaquette sublattices (stride 2 in both axes), each
one batched call of ``torch.linalg`` (cuSOLVER on the card). The other
cluster orientations are the canonical one on a reflected lattice:
anti-diagonal clusters on the horizontally flipped one, lower triangles on
the transposed one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from peps_tpu_torch.linalg import (TruncParams, blq, expm_taylor,
                                   safe_inverse, truncated_svd)
from peps_tpu_torch.peps import (PEPS, SimpleUpdateParams, SimpleUpdateResult,
                                 _transpose_peps, run_with_stall_stop,
                                 simple_update_sweep)


def flip_horizontal(peps: PEPS) -> PEPS:
    """Mirror x -> Lx-1-x (site legs l <-> r)."""
    return PEPS(peps.gammas.flip(1).permute(0, 1, 2, 3, 6, 5, 4),
                peps.lam_v.flip(1), peps.lam_h.flip(1))


def _apply_cluster_batch(gA, gB, gC, lu_a, ll_a, ld_a, lu_b, lr_b, ll_c,
                         ld_c, lr_c, lam_ab, lam_bc, gate3,
                         trunc: TruncParams):
    """3-site gate on a batch of canonical L-clusters. g* [N, d, D, D, D, D];
    the external lambdas of A (u, l, d), B (u, r) and C (l, d, r) and the
    internal bonds lam_ab, lam_bc [N, D]; gate3 [N, d, d, d, d, d, d] =
    <A'B'C'|G|ABC>. Returns (gA', gB', gC', lam_ab', lam_bc', max trunc
    error)."""
    n, d, D = gA.shape[0], gA.shape[1], gA.shape[3]
    k = min(D ** 3, d * D)
    a = torch.einsum("npuldr,nu,nl,nd->npuldr", gA, lu_a, ll_a, ld_a)
    b = torch.einsum("npuldr,nu,nr->npuldr", gB, lu_b, lr_b)
    c = torch.einsum("npuldr,nl,nd,nr->npuldr", gC, ll_c, ld_c, lr_c)

    # A: rows (u, l, d), cols (p, r = internal); C: rows (p, u = internal)
    qa, ra = torch.linalg.qr(a.permute(0, 2, 3, 4, 1, 5)
                             .reshape(n, D ** 3, d * D), mode="reduced")
    ra = ra.reshape(n, k, d, D)                       # (kA, pA, r)
    lc, qc = blq(c.reshape(n, d * D, D ** 3))
    lc = lc.reshape(n, d, D, k)                       # (pC, u, kC)

    # b axes (q = pB, t = uB, l, w = dB, f = rB): l meets A's r, w C's u
    th = torch.einsum("nkpr,nr,nqtrwf->nkpqtwf", ra, lam_ab, b)
    th = torch.einsum("nkpqtwf,nw,nswc->nkpqtfsc", th, lam_bc, lc)
    thg = torch.einsum("nPQSpqs,nkpqtfsc->nkPQtfSc", gate3, th)
    # thg axes: (kA, PA, PB, uB, rB, PC, kC)

    u1, s1, v1, err1 = truncated_svd(thg.reshape(n, k * d, d * D * D * d * k),
                                     trunc)
    nrm1 = torch.linalg.vector_norm(s1, dim=1)
    lam_ab_new = s1 / torch.clamp(nrm1[:, None], min=torch.finfo(s1.dtype).tiny)
    ga = torch.einsum("nik,nkPm->niPm", qa, u1.reshape(n, k, d, D))
    ga = ga.reshape(n, D, D, D, d, D).permute(0, 4, 1, 2, 3, 5)
    ga = torch.einsum("npuldr,nu,nl,nd->npuldr", ga, safe_inverse(lu_a),
                      safe_inverse(ll_a), safe_inverse(ld_a))

    th2 = (lam_ab_new[:, :, None] * v1).reshape(n, D * d * D * D, d * k)
    u2, s2, v2, err2 = truncated_svd(th2, trunc)       # rows (ab, PB, uB, rB)
    nrm2 = torch.linalg.vector_norm(s2, dim=1)
    lam_bc_new = s2 / torch.clamp(nrm2[:, None], min=torch.finfo(s2.dtype).tiny)
    gb = u2.reshape(n, D, d, D, D, D).permute(0, 2, 3, 1, 5, 4)
    gb = torch.einsum("npuldr,nl,nu,nr->npuldr", gb,
                      safe_inverse(lam_ab_new), safe_inverse(lu_b),
                      safe_inverse(lr_b))
    gc = torch.einsum("nmsk,nki->nmsi", v2.reshape(n, D, d, k), qc)
    gc = gc.reshape(n, D, d, D, D, D).permute(0, 2, 1, 3, 4, 5)
    gc = torch.einsum("npuldr,nl,nd,nr->npuldr", gc, safe_inverse(ll_c),
                      safe_inverse(ld_c), safe_inverse(lr_c))
    return ga, gb, gc, lam_ab_new, lam_bc_new, \
        torch.maximum(err1.max(), err2.max())


def _gather_clusters(peps: PEPS, ys, xs):
    """Batch inputs of the clusters anchored at plaquettes (y, x), y in ys,
    x in xs (cartesian product). Returns (yy, xx, args)."""
    g, lam_v, lam_h = peps
    yy, xx = torch.meshgrid(torch.as_tensor(ys, device=g.device),
                            torch.as_tensor(xs, device=g.device),
                            indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    args = (g[yy, xx], g[yy, xx + 1], g[yy + 1, xx + 1],
            lam_v[yy, xx], lam_h[yy, xx], lam_v[yy + 1, xx],
            lam_v[yy, xx + 1], lam_h[yy, xx + 2],
            lam_h[yy + 1, xx + 1], lam_v[yy + 2, xx + 1],
            lam_h[yy + 1, xx + 2],
            lam_h[yy, xx + 1], lam_v[yy + 1, xx + 1])
    return yy, xx, args


def apply_cluster_gates(peps: PEPS, gate3_all: torch.Tensor,
                        trunc: TruncParams):
    """Per-plaquette 3-site gates gate3_all [Ly-1, Lx-1, d, d, d, d, d, d]
    over the four site-disjoint sublattices, each one batched call (the
    gates must be the identity where no update is wanted). Returns
    (peps', max trunc error)."""
    ly, lx = peps.ly, peps.lx
    max_err = torch.zeros((), dtype=peps.gammas.real.dtype,
                          device=peps.gammas.device)
    for y0 in (0, 1):
        for x0 in (0, 1):
            ys, xs = tuple(range(y0, ly - 1, 2)), tuple(range(x0, lx - 1, 2))
            if not ys or not xs:
                continue
            yy, xx, args = _gather_clusters(peps, ys, xs)
            ga, gb, gc, lab, lbc, err = _apply_cluster_batch(
                *args, gate3_all[yy, xx], trunc)
            g, lam_v, lam_h = (t.clone() for t in peps)
            g[yy, xx], g[yy, xx + 1], g[yy + 1, xx + 1] = ga, gb, gc
            lam_h[yy, xx + 1] = lab.to(lam_h.dtype)
            lam_v[yy + 1, xx + 1] = lbc.to(lam_v.dtype)
            peps = PEPS(g, lam_v, lam_h)
            max_err = torch.maximum(max_err, err)
    return peps, max_err


def _pair_to_cluster_gate(h_pair, sites, d: int) -> np.ndarray:
    """A two-site operator h[p', q', p, q] on cluster sites (i, j) (0 = A,
    1 = B, 2 = C) as a 3-site operator [d] * 6, the identity on the third
    site."""
    h = np.asarray(h_pair).reshape(d, d, d, d)
    i, j = sites
    new, old = ["R"] * 3, ["r"] * 3
    new[i], new[j], old[i], old[j] = "P", "Q", "p", "q"
    return np.einsum(f"PQpq,Rr->{''.join(new)}{''.join(old)}", h,
                     np.eye(d, dtype=h.dtype))


def nnn_cluster_hamiltonians(model, ly: int, lx: int, dtype, device):
    """Per-plaquette 3-site Hamiltonians of the diagonal term h_d on
    (A, C): [Ly-1, Lx-1] + [d] * 6 (the NN terms take the pair kernel)."""
    d = model.phys_dim
    h3 = torch.as_tensor(_pair_to_cluster_gate(model.h_d, (0, 2), d),
                         dtype=dtype, device=device)
    return h3.expand((ly - 1, lx - 1) + (d,) * 6)


def make_cluster_gates(h3_all: torch.Tensor, tau: float, d: int):
    """exp(-tau h3) per plaquette, [Ly-1, Lx-1] + [d] * 6."""
    mats = h3_all.reshape(-1, d ** 3, d ** 3)
    return expm_taylor(-tau * mats).reshape(h3_all.shape[:2] + (d,) * 6)


def _nn_gates(model, ly, lx, d, tau, dtype, device):
    hh = torch.as_tensor(np.asarray(model.h_h), dtype=dtype, device=device) \
        .expand(ly, lx - 1, d, d, d, d)
    hv = torch.as_tensor(np.asarray(model.h_v), dtype=dtype, device=device) \
        .expand(ly - 1, lx, d, d, d, d)
    gate_h = expm_taylor(-tau * hh.reshape(-1, d * d, d * d)) \
        .reshape(ly, lx - 1, d, d, d, d)
    gate_v = expm_taylor(-tau * hv.reshape(-1, d * d, d * d)) \
        .reshape(ly - 1, lx, d, d, d, d)
    return hh, gate_h, hv.permute(1, 0, 2, 3, 4, 5), \
        gate_v.permute(1, 0, 2, 3, 4, 5)


def _flipped_pass(peps: PEPS, gates, trunc: TruncParams):
    """Clusters of the horizontally flipped lattice: there the
    anti-diagonal is the canonical cluster's (A, C) diagonal."""
    pf, err = apply_cluster_gates(flip_horizontal(peps), gates.flip(1), trunc)
    return flip_horizontal(pf), err


def simple_update_nnn(peps: PEPS, model, params: SimpleUpdateParams,
                      step_observer: Callable | None = None
                      ) -> SimpleUpdateResult:
    """Simple update of a model with NN and diagonal terms: each step is
    the NN checkerboard sweep, then h_d on the canonical clusters, then
    h_ad on the flipped ones. step_observer(step=, e0=, en=, trunc_err=) is
    called after each step. e0 is the NN sweep's bond-energy estimate, as
    in the reference: the diagonal terms are not in it. It stops on the
    energy stall of :func:`peps.simple_update`."""
    ly, lx, d = peps.ly, peps.lx, peps.phys_dim
    dt, dev = peps.gammas.dtype, peps.gammas.device
    tau = params.tau
    hh, gate_h, hv_t, gate_v_t = _nn_gates(model, ly, lx, d, tau, dt, dev)
    gate3_d = gate3_ad = None
    if model.h_d is not None:
        gate3_d = make_cluster_gates(
            nnn_cluster_hamiltonians(model, ly, lx, dt, dev), tau, d)
    if model.h_ad is not None:
        # A and C keep their roles under the flip, so the table is the
        # diagonal's, read on the flipped lattice
        gate3_ad = make_cluster_gates(nnn_cluster_hamiltonians(
            dataclasses.replace(model, h_d=model.h_ad), ly, lx, dt, dev),
            tau, d)

    def one_step(p):
        p, (e0, log_norm, terr) = simple_update_sweep(
            p, gate_h, gate_v_t, hh, hv_t, params.trunc)
        if gate3_d is not None:
            p, err = apply_cluster_gates(p, gate3_d, params.trunc)
            terr = torch.maximum(terr, err)
        if gate3_ad is not None:
            p, err = _flipped_pass(p, gate3_ad, params.trunc)
            terr = torch.maximum(terr, err)
        return p, e0, log_norm, terr

    return run_with_stall_stop(peps, params, one_step, step_observer, tau)


def _bond_triangle_counts(ly: int, lx: int):
    """How many triangles share each NN bond: cnt_h [Ly, Lx-1], cnt_v
    [Ly-1, Lx] (at least 1). The upper triangle at (y, x) takes h-bond
    (y, x)-(y, x+1) and v-bond (y, x+1)-(y+1, x+1); the lower one v-bond
    (y, x)-(y+1, x) and h-bond (y+1, x)-(y+1, x+1)."""
    cnt_h = np.zeros((ly, lx - 1))
    cnt_v = np.zeros((ly - 1, lx))
    cnt_h[:-1] += 1
    cnt_v[:, 1:] += 1
    cnt_v[:, :-1] += 1
    cnt_h[1:] += 1
    return np.maximum(cnt_h, 1), np.maximum(cnt_v, 1)


def simple_update_triangle(peps: PEPS, model, params: SimpleUpdateParams,
                           step_observer: Callable | None = None
                           ) -> SimpleUpdateResult:
    """Triangular-lattice simple update on the square PEPS: upper triangles
    (A, B, C) take h_AB/w + h_BC/w + h_AC, lower triangles (A, D, C), on
    the transposed lattice, h_AD/w + h_DC/w; w is how many triangles share
    the NN bond. h_ad, where set, takes a pass of flipped clusters. As in
    the reference, it runs every step (no stop: converged is False) and
    its energy history holds sum(lambda) per step, no energy estimate."""
    ly, lx, d = peps.ly, peps.lx, peps.phys_dim
    dt, dev = peps.gammas.dtype, peps.gammas.device
    tau = params.tau
    h_nn, h_di = np.asarray(model.h_h), np.asarray(model.h_d)
    cnt_h, cnt_v = _bond_triangle_counts(ly, lx)

    def cluster(h, sites):
        return _pair_to_cluster_gate(h, sites, d)

    upper = np.zeros((ly - 1, lx - 1) + (d,) * 6)
    lower = np.zeros((lx - 1, ly - 1) + (d,) * 6)
    for y in range(ly - 1):
        for x in range(lx - 1):
            upper[y, x] = cluster(h_nn / cnt_h[y, x], (0, 1)) \
                + cluster(h_nn / cnt_v[y, x + 1], (1, 2)) \
                + cluster(h_di, (0, 2))
            # lower triangle (A=(y,x), D=(y+1,x), C=(y+1,x+1)) is the
            # canonical cluster at (x, y) of the transposed lattice
            lower[x, y] = cluster(h_nn / cnt_v[y, x], (0, 1)) \
                + cluster(h_nn / cnt_h[y + 1, x], (1, 2))

    def gates(h3):
        return make_cluster_gates(torch.as_tensor(np.array(h3), dtype=dt,
                                                  device=dev), tau, d)

    g_up, g_lo = gates(upper), gates(lower)
    g_ad = None
    if model.h_ad is not None:
        g_ad = gates(np.broadcast_to(cluster(model.h_ad, (0, 2)),
                                     (ly - 1, lx - 1) + (d,) * 6))

    def one_step(p):
        p, err = apply_cluster_gates(p, g_up, params.trunc)
        pt, err2 = apply_cluster_gates(_transpose_peps(p), g_lo, params.trunc)
        p, err = _transpose_peps(pt), torch.maximum(err, err2)
        if g_ad is not None:
            p, err3 = _flipped_pass(p, g_ad, params.trunc)
            err = torch.maximum(err, err3)
        return p, err

    history, step = [], 0
    for step in range(1, params.steps + 1):
        peps, terr = one_step(peps)
        history.append(float(peps.lam_h.sum() + peps.lam_v.sum()))
        if step_observer is not None:
            step_observer(step=step, e0=float("nan"), en=float("nan"),
                          trunc_err=float(terr))
    return SimpleUpdateResult(peps, float("nan"), float("nan"), step, False,
                              history)
