"""The port's graded simple update (peps_tpu_torch.fermion.peps) against
the JAX package in float64: t-J at 2x3 and 3x3, D=4, with and without the
U(1) charges and the QR-reduced projection, compared on gauge-free
quantities only (the sorted lambdas of every bond, the energy estimate of
every step and the exact coefficients of the state, within 1e-10); under
U(1) truncation the state keeps its particle number. Also the product
state, the U(1) metadata and the graded bond expansion."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.fermion import peps as jp
from peps_tpu.fermion.exact import exact_coefficients as j_exact
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import fermion as j_fermion
from peps_tpu.peps import SimpleUpdateParams as JSU
from peps_tpu_torch.fermion import peps as tp
from peps_tpu_torch.fermion.exact import exact_coefficients, snake_order
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import fermion
from peps_tpu_torch.peps import SimpleUpdateParams
from test_torch_bmps import rel

RTOL = 1e-10
OCC = {(2, 3): np.array([[1, 0, 2], [2, 1, 0]]),
       (3, 3): np.array([[1, 2, 1], [2, 0, 2], [1, 2, 0]])}


def _norm(c):
    return c / np.abs(c).max()


@pytest.mark.parametrize("shape,u1,qr", [
    ((2, 3), True, True), ((2, 3), False, True), ((2, 3), True, False),
    ((2, 3), False, False), ((3, 3), True, True), ((3, 3), False, True)])
def test_fermion_simple_update_matches_reference(shape, u1, qr):
    ly, lx = shape
    occ = OCC[shape]
    if ly * lx % 2:
        occ = occ.copy()
        occ[2, 2] = 1            # an even total parity
    jm = j_fermion.tj_model(3.0, 1.0, mu=0.3)
    m = fermion.tj_model(3.0, 1.0, mu=0.3)
    D = 4
    jsp, sp = jp.space_for_model(jm, D), tp.space_for_model(m, D)
    assert sp == tp.FermionSpace(*dataclass_fields(jsp))
    jch = jp.u1_charges_for(jm, jsp, occ) if u1 else None
    ch = tp.u1_charges_for(m, sp, occ) if u1 else None
    if u1:
        assert (ch.phys_charge, ch.bond_charge, ch.keep, ch.kappa) == \
            (jch.phys_charge, jch.bond_charge, jch.keep, jch.kappa)
    j0 = jp.product_fermion_peps(ly, lx, jsp, occ)
    p0 = tp.product_fermion_peps(ly, lx, sp, occ, device="cpu")
    for a, b in zip(p0, j0):
        assert np.array_equal(a.numpy(), np.asarray(b))
    steps = 3
    ref = jp.fermion_simple_update(j0, jm, jsp, JSU(steps, 0.1,
                                                    JTrunc(D, 1, 1e-12)),
                                   charges=jch, qr_reduce=qr)
    out = tp.fermion_simple_update(p0, m, sp, SimpleUpdateParams(
        steps, 0.1, TruncParams(D, 1, 1e-12)), charges=ch, qr_reduce=qr)
    assert out.executed_steps == ref.executed_steps == steps
    assert np.allclose(out.energy_history, ref.energy_history, rtol=RTOL,
                       atol=0)
    assert abs(out.estimated_en - ref.estimated_en) \
        < RTOL * abs(ref.estimated_en)
    for a, b in ((out.peps.lam_v, ref.peps.lam_v),
                 (out.peps.lam_h, ref.peps.lam_h)):
        assert rel(np.sort(a.numpy(), -1), np.sort(np.asarray(b), -1)) \
            < RTOL
    c = exact_coefficients(tp.to_tps_fermion(out.peps), sp.phys_parity,
                           sp.bond_parity)
    jc = np.asarray(j_exact(jp.to_tps_fermion(ref.peps), jsp.phys_parity,
                            jsp.bond_parity))
    assert rel(_norm(c), _norm(jc)) < RTOL
    if u1:
        # every coefficient outside the initial particle number is zero
        n0 = int(sum(m.n_up[s] + m.n_dn[s] for s in occ.reshape(-1)))
        ntot = np.asarray(m.n_up + m.n_dn)
        off = [abs(c[idx]) for idx in itertools.product(
            range(m.phys_dim), repeat=ly * lx)
            if int(sum(ntot[list(idx)])) != n0]
        assert max(off) < 1e-12 * np.abs(c).max()


def dataclass_fields(space):
    return space.phys_parity, space.d_even, space.d_odd


def test_expand_bond_dim_graded_keeps_the_state():
    jm = j_fermion.spinless_fermion(1.0, 0.5)
    m = fermion.spinless_fermion(1.0, 0.5)
    occ = np.array([[1, 0, 0], [0, 0, 1]])
    sp, jsp = tp.space_for_model(m, 2), jp.space_for_model(jm, 2)
    su = tp.fermion_simple_update(
        tp.product_fermion_peps(2, 3, sp, occ, device="cpu"), m, sp,
        SimpleUpdateParams(3, 0.1, TruncParams(2, 1, 1e-12)))
    tps = tp.to_tps_fermion(su.peps)
    new = tp.FermionSpace(sp.phys_parity, 2, 3)
    big = tp.expand_bond_dim_graded(tps, sp, new)
    jbig = jp.expand_bond_dim_graded(jnp.asarray(tps.numpy()), jsp,
                                     jp.FermionSpace(sp.phys_parity, 2, 3))
    assert np.array_equal(big.numpy(), np.asarray(jbig))
    c0 = exact_coefficients(tps, sp.phys_parity, sp.bond_parity)
    c1 = exact_coefficients(big, new.phys_parity, new.bond_parity)
    assert rel(c1, c0) < 1e-14
    noisy = tp.expand_bond_dim_graded(tps, sp, new, noise=1e-3,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    diff = (noisy - big).numpy()
    assert np.abs(diff).max() > 0
    # noise only on parity-conserving entries of the new slots
    pb = np.asarray(new.bond_parity)
    pp = np.asarray(new.phys_parity)
    par = (pp[:, None, None, None, None] + pb[None, :, None, None, None]
           + pb[None, None, :, None, None] + pb[None, None, None, :, None]
           + pb[None, None, None, None, :]) % 2
    assert np.all(diff[..., par == 1] == 0)
    assert len(snake_order(2, 3)) == 6


def test_graded_state_converts_from_reference():
    """convert.graded_state_from_numpy carries a JAX graded state (Gamma /
    Lambda PEPS, FermionSpace, U1Charges) across: the same space and
    charges, and the port's SU continues from it as the reference's does."""
    from peps_tpu_torch.convert import graded_state_from_numpy
    jm, m = j_fermion.tj_model(), fermion.tj_model()
    occ = OCC[(2, 3)]
    jsp = jp.space_for_model(jm, 4)
    jch = jp.u1_charges_for(jm, jsp, occ)
    params = JSU(2, 0.1, JTrunc(4, 1, 1e-12))
    jst = jp.fermion_simple_update(jp.product_fermion_peps(2, 3, jsp, occ),
                                   jm, jsp, params, charges=jch).peps
    peps, sp, ch = graded_state_from_numpy(*(np.asarray(a) for a in jst),
                                           jsp, jch, device="cpu")
    assert sp == tp.space_for_model(m, 4)
    assert ch == tp.u1_charges_for(m, sp, occ)
    ref = jp.fermion_simple_update(jst, jm, jsp, params, charges=jch)
    out = tp.fermion_simple_update(peps, m, sp, SimpleUpdateParams(
        2, 0.1, TruncParams(4, 1, 1e-12)), charges=ch)
    assert np.allclose(out.energy_history, ref.energy_history, rtol=RTOL,
                       atol=0)
    c = exact_coefficients(tp.to_tps_fermion(out.peps), sp.phys_parity,
                           sp.bond_parity)
    jc = np.asarray(j_exact(jp.to_tps_fermion(ref.peps), jsp.phys_parity,
                            jsp.bond_parity))
    assert rel(_norm(c), _norm(jc)) < RTOL
