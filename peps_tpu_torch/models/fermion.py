"""Fermionic square-lattice models via Jordan-Wigner channel decomposition
(the port's own copy of ``peps_tpu/models/fermion.py``, which imports no
JAX; the tables are numpy and identical).

Reference models: `square_spinless_fermion.h`, `square_tJ_model.h`,
`square_hubbard_model.h` (built on qlten's Z2-graded fermionic tensors).

TPU-native design (deliberate substitution, round 1): instead of graded
tensors, we work in the Jordan-Wigner spin representation with mode order
m = n_species*site + species (site = y*Lx + x row-major). Every Hamiltonian
term becomes a CHANNEL = (dense coupling table [d,d,d,d], string spec). The
crucial observation: JW string operators are DIAGONAL in the occupation
basis, so for VMC local energies the string contributes only a +-1 sign
computed from the CURRENT configuration — the existing bosonic amplitude-ratio
machinery is reused unchanged. Physics is exact (JW is a unitary mapping);
the trade-off vs graded fermionic PEPS is variational efficiency of the
ansatz at fixed D, not correctness.

String spec per channel: "none", "up" or "dn" — the species that hops. Sign
masks over lattice sites are built statically per bond orientation:
  up-hop  (i < j): modes strictly between 2i and 2j  = {i_dn} + both spins of
                   sites between
  dn-hop  (i < j): modes strictly between 2i+1, 2j+1 = both spins of sites
                   between + {j_up}
  spinless hop:    sites strictly between i and j
where "sites between" is in row-major JW order.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FermionChannel:
    h: np.ndarray          # [d, d, d, d] <s1' s2'|op|s1 s2> (no string sign)
    string: str            # "none" | "up" | "dn"


@dataclasses.dataclass(frozen=True)
class FermionModel:
    """channels_d act on the diagonal (y,x)-(y+1,x+1); channels_ad on the
    anti-diagonal with table index order ((y+1,x), (y,x+1)) — matching the
    bosonic ModelTensors h_d/h_ad conventions. NNN (t2) channels mirror the
    reference's EvaluateNNNEnergy (square_spinless_fermion.h:181,
    square_tJ_model.h:168)."""
    phys_dim: int
    n_up: np.ndarray       # [d] up-occupation of each local state
    n_dn: np.ndarray       # [d] down-occupation (zeros for spinless)
    channels_h: tuple      # horizontal NN channels
    channels_v: tuple      # vertical NN channels
    h_site: np.ndarray | None = None   # one-site term [d, d] (no string)
    spinless: bool = False
    name: str = "fermion_model"
    channels_d: tuple = ()   # diagonal NNN channels
    channels_ad: tuple = ()  # anti-diagonal NNN channels


def _hop_table(d, create, destroy, amp):
    """Two-site table for amp * (A_1^dag B_2 + B_2^dag A_1)-type hops given
    single-site create/destroy matrices (occupation basis, no signs)."""
    h = np.zeros((d, d, d, d))
    # amp * (c1^dag c2): site1 gains, site2 loses
    h += amp * np.einsum("ac,bd->abcd", create, destroy)
    h += amp * np.einsum("ac,bd->abcd", create.T, destroy.T)
    return h


def spinless_fermion(t: float = 1.0, v: float = 0.0,
                     mu: float = 0.0, t2: float = 0.0) -> FermionModel:
    """H = -t sum_<ij> (c^dag c + h.c.) - t2 sum_<<ij>> (c^dag c + h.c.)
    + V sum_<ij> n n - mu sum n.
    Reference: square_spinless_fermion.h (t2 member :120, diagonal energy
    :181-192; in-tree fixtures at t2 = -2.5, 0, 2.1)."""
    d = 2
    n = np.array([0.0, 1.0])
    cdag = np.array([[0.0, 0.0], [1.0, 0.0]])   # |1><0|
    c = cdag.T
    hop = _hop_table(d, cdag, c, -t)
    nn = v * np.einsum("a,b,ac,bd->abcd", n, n, np.eye(d), np.eye(d))
    channels = (FermionChannel(hop, "up"), FermionChannel(nn, "none"))
    diag = ()
    if t2 != 0.0:
        hop2 = _hop_table(d, cdag, c, -t2)
        diag = (FermionChannel(hop2, "up"),)
    h_site = -mu * np.diag(n) if mu != 0.0 else None
    return FermionModel(d, n, np.zeros(d), channels, channels, h_site,
                        spinless=True, name="spinless_fermion",
                        channels_d=diag, channels_ad=diag)


def _tj_ops():
    """t-J local basis: 0=empty, 1=up, 2=down (no double occupancy)."""
    d = 3
    n_up = np.array([0.0, 1.0, 0.0])
    n_dn = np.array([0.0, 0.0, 1.0])
    cdag_up = np.zeros((d, d)); cdag_up[1, 0] = 1.0
    cdag_dn = np.zeros((d, d)); cdag_dn[2, 0] = 1.0
    sz = 0.5 * (np.diag(n_up) - np.diag(n_dn))
    sp = np.zeros((d, d)); sp[1, 2] = 1.0          # S+ = |up><dn|
    return d, n_up, n_dn, cdag_up, cdag_dn, sz, sp


def tj_model(t: float = 3.0, j: float = 1.0, mu: float = 0.0,
             t2: float = 0.0, v: float = 0.0) -> FermionModel:
    """Extended t-J: -t sum_<ij>,s (c^dag c + h.c.)
    - t2 sum_<<ij>>,s (c^dag c + h.c.) + J sum_<ij> (S.S - n n / 4)
    + V sum_<ij> n n - mu N.
    Reference: square_tJ_model.h:9,99-100 (t, t2, J, V, mu),
    EvaluateNNNEnergy :168 (t2 on both diagonal directions)."""
    d, n_up, n_dn, cdag_up, cdag_dn, sz, sp = _tj_ops()
    ntot = n_up + n_dn
    eye = np.eye(d)
    hop_up = _hop_table(d, cdag_up, cdag_up.T, -t)
    hop_dn = _hop_table(d, cdag_dn, cdag_dn.T, -t)
    heis = (np.einsum("ac,bd->abcd", sz, sz)
            + 0.5 * (np.einsum("ac,bd->abcd", sp, sp.T)
                     + np.einsum("ac,bd->abcd", sp.T, sp)))
    dens = np.einsum("a,b,ac,bd->abcd", ntot, ntot, eye, eye)
    spin = j * (heis - 0.25 * dens) + v * dens
    channels = (FermionChannel(hop_up, "up"), FermionChannel(hop_dn, "dn"),
                FermionChannel(spin, "none"))
    diag = ()
    if t2 != 0.0:
        diag = (FermionChannel(_hop_table(d, cdag_up, cdag_up.T, -t2), "up"),
                FermionChannel(_hop_table(d, cdag_dn, cdag_dn.T, -t2), "dn"))
    h_site = -mu * np.diag(ntot) if mu != 0.0 else None
    return FermionModel(d, n_up, n_dn, channels, channels, h_site,
                        name="tj_model", channels_d=diag, channels_ad=diag)


def hubbard(t: float = 1.0, u: float = 8.0, mu: float = 0.0) -> FermionModel:
    """Hubbard: -t sum_sigma (c^dag c + h.c.) + U sum n_up n_dn - mu n.
    Local basis: 0=empty, 1=up, 2=down, 3=up+down (|updown> = c^dag_up
    c^dag_dn |0>). Reference: square_hubbard_model.h."""
    d = 4
    n_up = np.array([0.0, 1.0, 0.0, 1.0])
    n_dn = np.array([0.0, 0.0, 1.0, 1.0])
    # JW-basis single-site raising ops WITHOUT local parity signs (those are
    # carried by the string factors): <s'|sigma^+_up|s>
    cdag_up = np.zeros((d, d)); cdag_up[1, 0] = 1.0; cdag_up[3, 2] = 1.0
    cdag_dn = np.zeros((d, d)); cdag_dn[2, 0] = 1.0; cdag_dn[3, 1] = 1.0
    hop_up = _hop_table(d, cdag_up, cdag_up.T, -t)
    hop_dn = _hop_table(d, cdag_dn, cdag_dn.T, -t)
    channels = (FermionChannel(hop_up, "up"), FermionChannel(hop_dn, "dn"))
    h_site = u * np.diag(n_up * n_dn)
    if mu != 0.0:
        h_site = h_site - mu * np.diag(n_up + n_dn)
    return FermionModel(d, n_up, n_dn, channels, channels, h_site,
                        name="hubbard")


def hubbard_conserve_mask(d: int = 4) -> tuple:
    """Transition mask for the Suwa-Todo two-site updater conserving N_up and
    N_dn separately (reference: square_hubbard_u1u1_updater.h:30-45).
    Returns a hashable nested tuple [(d*d) x (d*d)]."""
    n_up = np.array([0, 1, 0, 1]); n_dn = np.array([0, 0, 1, 1])
    mask = np.zeros((d * d, d * d), dtype=np.int32)
    for a in range(d * d):
        a1, a2 = a // d, a % d
        for b in range(d * d):
            b1, b2 = b // d, b % d
            if (n_up[a1] + n_up[a2] == n_up[b1] + n_up[b2]
                    and n_dn[a1] + n_dn[a2] == n_dn[b1] + n_dn[b2]):
                mask[a, b] = 1
    return tuple(map(tuple, mask))


def tj_conserve_mask(d: int = 3) -> tuple:
    n_up = np.array([0, 1, 0]); n_dn = np.array([0, 0, 1])
    mask = np.zeros((d * d, d * d), dtype=np.int32)
    for a in range(d * d):
        a1, a2 = a // d, a % d
        for b in range(d * d):
            b1, b2 = b // d, b % d
            if (n_up[a1] + n_up[a2] == n_up[b1] + n_up[b2]
                    and n_dn[a1] + n_dn[a2] == n_dn[b1] + n_dn[b2]):
                mask[a, b] = 1
    return tuple(map(tuple, mask))
