"""Two-site bond Hamiltonians for fermionic models in the graded ordered
basis — the gate inputs of the fermionic simple update.

`bond_h2(model)` returns h[a', b', a, b] = <a' b'| H_bond |a b> where
|a b> = (ordered creation operators of site A's occupied species)
        (ordered creation operators of site B's occupied species) |vac>,
i.e. site A's modes precede site B's, species ordered up-then-down within a
site (matching the JW mode order of models/fermion.py and the graded
tensor-product order of peps_tpu/fermion/exact.py). Fermionic signs inside
the two-site Fock space are counted explicitly.

The port's own copy of ``peps_tpu/fermion/gates.py`` (numpy; the graded
swap runs on the port's :mod:`peps_tpu_torch.fermion.graded`).

Reference: the per-model Hamiltonian terms of `square_spinless_fermion.h`,
`square_tJ_model.h:hopping+exchange`, `square_hubbard_model.h`, as consumed
by the fermionic simple update (`test_fermion_simple_update.cpp`).
"""
from __future__ import annotations

import numpy as np

from peps_tpu_torch.models.fermion import FermionModel


def _occ_of(model, s):
    if model.spinless:
        return (int(model.n_up[s]),)
    return (int(model.n_up[s]), int(model.n_dn[s]))


def _apply_c(occ, m):
    if occ[m] == 0:
        return None
    sign = (-1) ** int(np.sum(occ[:m]))
    new = list(occ)
    new[m] = 0
    return sign, tuple(new)


def _apply_cdag(occ, m):
    if occ[m] == 1:
        return None
    sign = (-1) ** int(np.sum(occ[:m]))
    new = list(occ)
    new[m] = 1
    return sign, tuple(new)


def _apply_ops(occ, ops):
    """ops: list of ("c"|"cdag", mode), applied right-to-left."""
    sign = 1
    cur = tuple(occ)
    for kind, m in reversed(ops):
        r = _apply_c(cur, m) if kind == "c" else _apply_cdag(cur, m)
        if r is None:
            return None
        s, cur = r
        sign *= s
    return sign, cur


def _hop_amplitude(table, model, string):
    """Read the scalar hop amplitude off a channel table (same convention as
    the ED oracle): the entry <moved | h | original> for a reference
    single-particle transfer."""
    nvec = model.n_up if (string == "up" or model.spinless) else model.n_dn
    other = model.n_dn if (string == "up" or model.spinless) else model.n_up
    d = table.shape[0]
    for a in range(d):
        for b in range(d):
            for c in range(d):
                for e in range(d):
                    v = table[a, b, c, e]
                    if v == 0:
                        continue
                    if (nvec[a] - nvec[c] == 1 and nvec[b] - nvec[e] == -1
                            and other[a] == other[c] and other[b] == other[e]):
                        return v
    raise ValueError("no hop entry found in channel table")


def bond_h2(model: FermionModel, orient: str = "h") -> np.ndarray:
    """<a' b'| H_bond |a b> [d,d,d,d] in the ordered 2-site basis (site A's
    modes first). Interprets the model's channel tables exactly like the
    second-quantized ED oracle, restricted to one bond."""
    d = model.phys_dim
    ns = 1 if model.spinless else 2
    channels = model.channels_h if orient == "h" else model.channels_v
    occ_table = [_occ_of(model, s) for s in range(d)]
    occ_to_state = {o: s for s, o in enumerate(occ_table)}

    h = np.zeros((d, d, d, d))
    for a in range(d):
        for b in range(d):
            occ = occ_table[a] + occ_table[b]       # modes [A..., B...]
            for ch in channels:
                if ch.string in ("up", "dn"):
                    spidx = 0 if (ch.string == "up" or model.spinless) else 1
                    amp = _hop_amplitude(np.asarray(ch.h), model, ch.string)
                    for (ma, mb) in ((spidx, ns + spidx),
                                     (ns + spidx, spidx)):
                        r = _apply_ops(occ, [("cdag", ma), ("c", mb)])
                        if r is None:
                            continue
                        sgn, new = r
                        na = occ_to_state.get(new[:ns])
                        nb = occ_to_state.get(new[ns:])
                        if na is None or nb is None:
                            continue
                        h[na, nb, a, b] += amp * sgn
                else:
                    tab = np.asarray(ch.h)
                    for p in range(d):
                        for q in range(d):
                            v = tab[p, q, a, b]
                            if v == 0:
                                continue
                            if p == a and q == b:
                                h[p, q, a, b] += v
                                continue
                            # off-diagonal string-free channel (spin
                            # exchange): explicit 4-fermion operator,
                            # creation before annihilation per site
                            ops = []
                            for base, (snew, sold) in ((0, (p, a)),
                                                       (ns, (q, b))):
                                cd, cc = [], []
                                for spi, nvec in ((0, model.n_up),
                                                  (1, model.n_dn)):
                                    dn_ = int(nvec[snew]) - int(nvec[sold])
                                    if dn_ == 1:
                                        cd.append(("cdag", base + spi))
                                    elif dn_ == -1:
                                        cc.append(("c", base + spi))
                                ops.extend(cd + cc)
                            r = _apply_ops(occ, ops)
                            if r is None:
                                continue
                            sgn, new = r
                            na = occ_to_state.get(new[:ns])
                            nb = occ_to_state.get(new[ns:])
                            if na is None or nb is None:
                                continue
                            h[na, nb, a, b] += v * sgn
    return h


def swap_gate_sites(h2: np.ndarray, phys_parity) -> np.ndarray:
    """Graded swap of the two sites of a 4-leg gate: h[a',b',a,b] ->
    h[b',a',b,a] x Koszul signs — the gate in (B,A) juxtaposition."""
    import torch

    from peps_tpu_torch.fermion.graded import GT, gtranspose
    pp = tuple(int(x) for x in phys_parity)
    g = GT(torch.as_tensor(np.asarray(h2)), (pp, pp, pp, pp),
           (False, False, True, True))
    return gtranspose(g, (1, 0, 3, 2)).data.numpy()
