"""Parity of the port's torus simple update (peps_tpu_torch.peps: the PBC
lambda layout, the ring-bond groups, the torus sweep, to_tps_pbc) and its
torus bond lists with the JAX package.

Both packages start from the same product state and evolve it with the
same gates; the lambdas are singular values (gauge-free) and are compared
directly, the energies per step too. Float64 to 1e-10 (round-off of a few
batched QR/SVD steps is 1e-15); float32 to 1e-4 (the two LAPACK paths'
float32 round-off through ten steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import lattice as j_lattice
from peps_tpu import peps as jpeps
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as jspin
from peps_tpu.tps import exact_contract_pbc as j_exact_contract_pbc
from peps_tpu_torch import lattice, peps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.tps import exact_contract_pbc, project

PBC = lattice.BoundaryCondition.PERIODIC


def neel(ly, lx):
    return np.indices((ly, lx)).sum(0) % 2


@pytest.mark.parametrize("l", [2, 3, 4, 5, 6, 7])
def test_pbc_bond_groups_match_reference(l):
    """The same site-disjoint ring groups as the reference's, covering every
    ring bond once."""
    groups = peps._pbc_bond_groups(l)
    assert groups == jpeps._pbc_bond_groups(l)
    assert sorted(x for g in groups for x in g) == list(range(l))


@pytest.mark.parametrize("ly,lx", [(2, 3), (3, 4)])
def test_pbc_nn_bonds_match_reference(ly, lx):
    for fn, jfn in ((lattice.nn_bonds_h, j_lattice.nn_bonds_h),
                    (lattice.nn_bonds_v, j_lattice.nn_bonds_v)):
        assert fn(ly, lx, PBC) == jfn(ly, lx, j_lattice.BoundaryCondition
                                      .PERIODIC)


def test_product_peps_pbc_and_to_tps_pbc():
    """The torus product state: the reference's layout, and to_tps_pbc
    contracts to amplitude 1 on its configuration and 0 elsewhere."""
    ly, lx, D = 2, 3, 3
    occ = neel(ly, lx)
    p = peps.product_peps_pbc(ly, lx, D, occ, 2, dtype=torch.float64,
                              device="cpu")
    jp = jpeps.product_peps_pbc(ly, lx, D, jnp.asarray(occ), 2,
                                dtype=jnp.float64)
    assert peps.is_pbc(p) and jpeps.is_pbc(jp)
    for a, b in zip(p, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tps = peps.to_tps_pbc(p)
    np.testing.assert_array_equal(tps.numpy(),
                                  np.asarray(jpeps.to_tps_pbc(jp)))
    amp = exact_contract_pbc(project(tps, torch.as_tensor(occ)).numpy())
    assert abs(amp - 1.0) < 1e-12
    other = project(tps, torch.as_tensor(1 - occ)).numpy()
    assert abs(exact_contract_pbc(other)) < 1e-12
    assert exact_contract_pbc(other) == j_exact_contract_pbc(other)


SU_CASES = {
    # (ly, lx, D, model name, dtype): 2x4 even rings, 3x3 odd rings (the
    # third, wrap-bond group), the TFIM with the torus site fold
    "heis_2x4_f64": (2, 4, 3, "heisenberg", "float64"),
    "heis_3x3_f64": (3, 3, 3, "heisenberg", "float64"),
    "tfim_2x4_f64": (2, 4, 2, "tfim", "float64"),
    "heis_2x4_f32": (2, 4, 3, "heisenberg", "float32"),
}


def _torus_bond(model_name, jax_side):
    """(h_bond_h, h_bond_v) of the case's model on the torus (the TFIM's
    field folded at a quarter per bond end: every site has 4 bonds)."""
    sp = jspin if jax_side else spin
    if model_name == "heisenberg":
        m = sp.heisenberg(1.0)
        return np.asarray(m.h_h), np.asarray(m.h_v)
    m = sp.transverse_field_ising(1.0, 3.0)
    d = 2
    eye = np.eye(d)
    hs = np.asarray(m.h_site)
    hb = (np.asarray(m.h_h) + np.einsum("ac,bd->abcd", hs / 4, eye)
          + np.einsum("ac,bd->abcd", eye, hs / 4))
    return hb, hb


@pytest.mark.parametrize("case", list(SU_CASES))
def test_pbc_simple_update_matches_reference(case):
    """Ten torus SU steps at tau 0.1 from a product state: the lambdas of
    every bond, the energy history and the amplitudes of to_tps_pbc (a few
    configurations, exact torus contraction) against the reference's."""
    ly, lx, D, name, dt = SU_CASES[case]
    occ = neel(ly, lx) if name == "heisenberg" else np.zeros((ly, lx), int)
    tol = 1e-10 if dt == "float64" else 1e-4
    jp = jpeps.product_peps_pbc(ly, lx, D, jnp.asarray(occ), 2,
                                dtype=getattr(jnp, dt))
    hh, hv = _torus_bond(name, True)
    jr = jpeps.simple_update(jp, hh, hv, jpeps.SimpleUpdateParams(
        steps=10, tau=0.1, trunc=JTrunc(D, 1, 1e-12)))
    p = peps.product_peps_pbc(ly, lx, D, occ, 2, dtype=getattr(torch, dt),
                              device="cpu")
    hh, hv = _torus_bond(name, False)
    r = peps.simple_update(p, hh, hv, peps.SimpleUpdateParams(
        steps=10, tau=0.1, trunc=TruncParams(D, 1, 1e-12)))
    assert r.executed_steps == jr.executed_steps == 10
    for a, b in ((r.peps.lam_h, jr.peps.lam_h), (r.peps.lam_v, jr.peps.lam_v)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < tol
    hist, jhist = np.array(r.energy_history), np.array(jr.energy_history)
    assert np.abs(hist - jhist).max() < tol * np.abs(jhist).max()
    tps = peps.to_tps_pbc(r.peps).double()
    jtps = np.asarray(jpeps.to_tps_pbc(jr.peps), dtype=np.float64)
    rng = np.random.default_rng(3)
    for cfg in rng.integers(0, 2, size=(3, ly, lx)):
        a = exact_contract_pbc(project(tps, torch.as_tensor(cfg)).numpy())
        b = j_exact_contract_pbc(jtps[np.arange(ly)[:, None],
                                      np.arange(lx)[None, :], cfg])
        assert abs(abs(a) - abs(b)) < tol * 10 * max(1.0, abs(b))


def test_obc_simple_update_unchanged_by_the_torus_dispatch():
    """An OBC state still takes the open sweep (its lambda layout has
    Ly + 1 rows) and refuses nothing."""
    p = peps.product_peps(2, 2, 2, neel(2, 2), 2, dtype=torch.float64,
                          device="cpu")
    assert not peps.is_pbc(p)
    m = spin.heisenberg(1.0)
    r = peps.simple_update(p, m.h_h, m.h_v, peps.SimpleUpdateParams(
        steps=2, tau=0.1, trunc=TruncParams(2, 1, 1e-12)))
    assert r.peps.lam_v.shape[0] == 3 and np.isfinite(r.estimated_e0)
