"""The graded holes at chip_smoke phase 10 (c)'s setting (t-J on 4x4,
D=4, chi=6, sketch with the reference's blocks) against the JAX package,
float64 and complex128 within 1e-10 relative. chi = 6 truncates every
boundary past the first row, so no sketch Gram the holes differentiate
through is held only by its jitter (at chi = 16 the edge rows' Grams are
rank 4 in 16, and the holes move with the summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peps_tpu.fermion import vmc as j_vmc
from peps_tpu.fermion.peps import FermionSpace as JSpace
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import fermion as j_fermion
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.fermion import vmc
from peps_tpu_torch.fermion.peps import FermionSpace
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import fermion
from test_torch_bmps import jax_sketch_blocks, rel, t
from torch_fermion_util import hole_configs, random_graded_tps


@pytest.mark.parametrize("cplx", [False, True])
def test_graded_holes_at_4x4_chi6_match_reference(cplx, monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    sp, jsp = FermionSpace((0, 1, 1), 2, 2), JSpace((0, 1, 1), 2, 2)
    rng = np.random.default_rng(96 + cplx)
    tps = random_graded_tps(rng, 4, 4, sp, cplx)
    cfgs = hole_configs(rng, 2, 4, 4, {0: 2, 1: 7, 2: 7})
    chi = 6
    jgm = j_vmc.GradedFermionModel.from_model(j_fermion.tj_model(), jsp,
                                              jnp.asarray(tps).dtype)
    ref = jax.jit(jax.vmap(lambda c: j_vmc.local_energy_and_holes_graded(
        jnp.asarray(tps), c, jgm, chi,
        JTrunc(chi, 1, 1e-12, scheme="sketch"))))(jnp.asarray(cfgs))
    gm = vmc.GradedFermionModel.from_model(fermion.tj_model(), sp,
                                           t(tps).dtype, "cpu")
    out = vmc.local_energy_and_holes_graded(
        t(tps), t(cfgs), gm, chi, TruncParams(chi, 1, 1e-12, scheme="sketch"))
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < 1e-10, f
