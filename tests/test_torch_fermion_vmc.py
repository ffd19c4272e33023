"""Graded fermionic VMC (peps_tpu_torch.fermion.tables, .vmc) against the
JAX package: the env-shared ratio tables (with the t2 diagonals), E_loc and
the O tensor of t-J with t2 at 3x3, D=4, sketch compression with the
reference's blocks, in float64 and complex128, at chi = 3 (the sketch
truncates) and chi = 16 (it does not), within 1e-10 relative; the holes
come from autograd through the contraction as the reference's jax.grad.
The K1 autograd.Function wired to the plain transfer passes gradcheck, its
backward forms fit K1's launch plan at the flagship's shapes, and the
full-recompute tables (env_sharing=False) agree with the shared ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.fermion import tables as j_tables
from peps_tpu.fermion import vmc as j_vmc
from peps_tpu.fermion.peps import FermionSpace as JSpace
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import fermion as j_fermion
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.fermion import tables, vmc
from peps_tpu_torch.fermion.peps import FermionSpace
from peps_tpu_torch.kernels import col_transfer as k1
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import fermion
from peps_tpu_torch.montecarlo.jastrow import JastrowDress
from test_torch_bmps import jax_sketch_blocks, rel, t
from torch_fermion_util import hole_configs, random_graded_tps

RTOL = 1e-10
SPACE, JSPACE = FermionSpace((0, 1, 1), 2, 2), JSpace((0, 1, 1), 2, 2)
COUNTS = {0: 1, 1: 4, 2: 4}


@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def _state(cplx, nc=3):
    rng = np.random.default_rng(21 + cplx)
    return (random_graded_tps(rng, 3, 3, SPACE, cplx),
            hole_configs(rng, nc, 3, 3, COUNTS))


@pytest.mark.parametrize("cplx,chi", [(False, 3), (False, 16), (True, 3),
                                      (True, 16)])
def test_graded_energy_and_holes_match_reference(cplx, chi, jax_blocks):
    tps, cfgs = _state(cplx)
    jm = j_fermion.tj_model(3.0, 1.0, t2=0.7, mu=0.2)
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    jgm = j_vmc.GradedFermionModel.from_model(jm, JSPACE,
                                              jnp.asarray(tps).dtype)
    ref = jax.jit(jax.vmap(lambda c: j_vmc.local_energy_and_holes_graded(
        jnp.asarray(tps), c, jgm, chi, jt)))(jnp.asarray(cfgs))
    gm = vmc.GradedFermionModel.from_model(fermion.tj_model(
        3.0, 1.0, t2=0.7, mu=0.2), SPACE, t(tps).dtype, "cpu")
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    out = vmc.local_energy_and_holes_graded(t(tps), t(cfgs), gm, chi, trunc)
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < RTOL, f
    if chi == 3:
        # the tables themselves, t2 diagonals included
        jtab = jax.jit(jax.vmap(lambda c: j_tables.fermion_ratio_tables(
            jnp.asarray(tps), c, JSPACE, chi, jt, want_diag=True)))(
            jnp.asarray(cfgs))
        tab = tables.fermion_ratio_tables(t(tps), t(cfgs), SPACE, chi, trunc,
                                          want_diag=True)
        for f in ("ratio_h", "ratio_v", "ratio_d", "ratio_ad",
                  "log_abs_psi"):
            assert rel(getattr(tab, f), getattr(jtab, f)) < RTOL, f


def test_full_recompute_tables_agree_with_shared():
    """env_sharing=False (batched full recomputes) against the shared
    tables, with and without a Jastrow dress, at a chi where the sketch
    does not truncate (the holes differentiate through the sketch; an
    SVD's backward is undefined at its degenerate singular values)."""
    tps, cfgs = _state(False, 2)
    gm = vmc.GradedFermionModel.from_model(fermion.tj_model(
        3.0, 1.0, t2=0.5), SPACE, torch.float64, "cpu")
    trunc = TruncParams(16, 1, 0.0, scheme="sketch")
    rng = np.random.default_rng(4)
    v = rng.standard_normal((9, 9)) * 0.3
    v = v + v.T
    np.fill_diagonal(v, 0.0)
    for dress in (None, JastrowDress(t(v), t(np.array([1.0, 0.0, 0.0])))):
        a = vmc.local_energy_and_holes_graded(t(tps), t(cfgs), gm, 16, trunc,
                                              dress=dress)
        b = vmc.local_energy_and_holes_graded(t(tps), t(cfgs), gm, 16, trunc,
                                              env_sharing=False, dress=dress)
        for f in ("e_loc", "o_tensor", "log_abs_psi"):
            assert rel(getattr(b, f), getattr(a, f)) < 1e-10, f


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_col_transfer_function_gradcheck(dtype):
    """ColTransferFunction with the plain transfer: gradcheck (fast mode:
    the vector-Jacobian products along random directions), operands
    broadcast over the batch as in the sketch scans (a shared site, a
    size-1 batch dim); on CPU tensors its backward is the plain chain and
    launches no kernel."""
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    gen = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64) \
            .to(dtype).requires_grad_(True)

    ops = (r(2, 3, 4, 3, 2), r(3, 4, 2, 5), r(2, 3, 2, 4), r(1, 3, 2, 2, 6))
    before = (kb.col_transfer_backward.launches, k1.col_transfer.launches)
    assert torch.autograd.gradcheck(
        lambda *x: k1.ColTransferFunction.apply(*x),
        ops, fast_mode=True)
    # the backward counts kernel launches only, and the CPU launches none
    assert (kb.col_transfer_backward.launches,
            k1.col_transfer.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_backward_forms_fit_the_launch_plan(dtype):
    """Every backward of the graded holes fits the backward kernel's launch
    plan at the flagship's shapes (6x6, D=8, chi=32, eval chunk 8): the
    sketch V and W scans (the blocks in the bot slot, broadcast, no
    gradient there: one item a group) and the pair traces (env, top and
    bot broadcast over the 3 candidates: groups of 3 items); each fits a
    CTA's shared memory, fills half the card with clusters of 8 CTAs at
    8 items and the card with one CTA a group at 240 groups, and sizes
    its scratch for the clusters it launches."""
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    chi, D, losk, nc, lx = 32, 8, 40, 8, 6
    forms = {"sketch_v": ((chi, D, chi), (chi, D, chi), (D, D, D, D),
                          (chi, D, chi), (1, 1), (True, True, True, False)),
             "sketch_w": ((chi, D, losk), (chi, D, chi), (D, D, D, D),
                          (losk, D, losk), (1, 1), (True, True, True, False)),
             "pair_traces": ((chi, D, chi), (chi, D, chi), (D, D, D, D),
                             (chi, D, chi), (3, lx * (lx - 1)), (True,) * 4)}
    for name, (*shapes, (g_items, per), needs) in forms.items():
        env, top, site, bot = (torch.empty(s, device="meta", dtype=dtype)
                               for s in shapes)
        dims = k1.k1_dims(env, top, site, bot)
        plan = kb.backward_plan(dims, dtype, needs, g_items, nc * per)
        assert plan["smem_bytes"] <= k1.SMEM_PER_BLOCK, name
        assert plan["cluster"] == (8 if nc * per == nc else 1), name
        assert plan["ctas"] <= 2 * kb.H100_SMS, name
        assert plan["scratch"] == plan["clusters"] * g_items \
            * plan["item_sz"], name
