"""Exact coefficients of a graded fermionic PEPS, the test oracle (port of
``peps_tpu/fermion/exact.py``).

It defines what a graded PEPS means: the state

    |psi> = sum_n c(n) (f_s0^dag)^{n_s0} (f_s1^dag)^{n_s1} ... |vac>

with the sites s0, s1, ... in SNAKE (boustrophedon) order: even rows left
to right, odd rows right to left. :func:`exact_coefficients` contracts the
network site by site in snake order with the graded algebra, physical legs
kept open and ordered; the entries of the result are c(n). Exponential
cost: small lattices and tests only. The production path is the local
sign dressing of :mod:`peps_tpu_torch.fermion.convert`, held against this.
"""
from __future__ import annotations

import numpy as np
import torch

from peps_tpu_torch.fermion.graded import GT, gcontract, gtranspose


def snake_order(ly: int, lx: int):
    out = []
    for y in range(ly):
        xs = range(lx) if y % 2 == 0 else range(lx - 1, -1, -1)
        out.extend((y, x) for x in xs)
    return out


def _squeeze(t: GT, labels, drop):
    keep = [i for i, lbl in enumerate(labels) if lbl not in drop]
    if len(keep) == len(labels):
        return t, labels
    for i, lbl in enumerate(labels):
        if lbl in drop:
            assert t.shape[i] == 1 and t.parity[i] == (0,), (lbl, t.parity[i])
    data = t.data.reshape([t.shape[i] for i in keep])
    return (GT(data, tuple(t.parity[i] for i in keep),
               tuple(t.dual[i] for i in keep)), [labels[i] for i in keep])


def exact_coefficients(tps, phys_parity, bond_parity,
                       edge_index: int = 0) -> np.ndarray:
    """Contract a graded TPS [Ly, Lx, d, D, D, D, D] (axes p,u,l,d,r; arrows
    p/d/r out, u/l in; boundary bonds at ``edge_index``, which must be
    parity-even) into the coefficient tensor c[n_s0, n_s1, ...]
    (snake-ordered axes, d each), as numpy."""
    arr = torch.as_tensor(tps).detach().cpu()
    ly, lx = arr.shape[0], arr.shape[1]
    pp = tuple(int(x) for x in phys_parity)
    pb = tuple(int(x) for x in bond_parity)
    assert pb[edge_index] == 0, "boundary slot must be even"
    duals = (False, True, True, False, False)       # p,u,l,d,r
    bound = "boundary"
    e = slice(edge_index, edge_index + 1)

    def site(y, x):
        a = arr[y, x]
        if y == 0:
            a = a[:, e]
        if x == 0:
            a = a[:, :, e]
        if y == ly - 1:
            a = a[:, :, :, e]
        if x == lx - 1:
            a = a[:, :, :, :, e]
        par = (pp, (0,) if y == 0 else pb, (0,) if x == 0 else pb,
               (0,) if y == ly - 1 else pb, (0,) if x == lx - 1 else pb)
        lbl = ["p", bound if y == 0 else ("v", x),
               bound if x == 0 else ("h",),
               bound if y == ly - 1 else ("v", x),
               bound if x == lx - 1 else ("h",)]
        return GT(a, par, duals), lbl

    acc = GT(torch.ones((), dtype=arr.dtype), (), ())
    labels: list = []
    nphys = 0
    for y, x in snake_order(ly, lx):
        t, t_lbl = site(y, x)
        going_right = y % 2 == 0
        axes_acc, axes_t = [], []
        if y > 0:
            axes_acc.append(labels.index(("v", x)))
            axes_t.append(1)
        if (going_right and x > 0) or (not going_right and x < lx - 1):
            axes_acc.append(labels.index(("h",)))
            axes_t.append(2 if going_right else 4)
        res = gcontract(acc, tuple(axes_acc), t, tuple(axes_t))
        rem = [lbl for i, lbl in enumerate(labels) if i not in axes_acc]
        labels = rem + [t_lbl[i] for i in range(5) if i not in axes_t]
        p_pos = labels.index("p")
        perm = list(range(len(labels)))
        perm.remove(p_pos)
        perm.insert(nphys, p_pos)
        res = gtranspose(res, tuple(perm))
        labels = [labels[i] for i in perm]
        labels[nphys] = "P"
        nphys += 1
        acc, labels = _squeeze(res, labels, {bound})
    assert acc.ndim == nphys == ly * lx, (acc.ndim, nphys)
    return acc.data.numpy()
