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
import torch

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


def test_float32_graded_holes_on_rank_deficient_grams_as_near_as_reference(
        monkeypatch):
    """Both packages' float32 graded holes and local energies, each against
    its own package's float64 ones, on a 3x3 t-J state whose sketch Grams
    are rank deficient: the port's graded simple update at D=2 (20 steps,
    tau 0.1), expanded to D=4 with noise 1e-3 (128 seeds), chi=8, the
    reference's sketch blocks, four configurations of the state's numbers
    each. The float32 map (sketch jitter 1e-5) and round-off in the pinv's
    near-null space move the holes by tens of percent from float64 in
    either package (median relative error of O about 0.4 in both), so the
    float32 results of the two packages are not compared with each other.
    The tolerance is statistical and paired: per configuration the log of
    the port's error over the reference's, whose spread from one
    configuration to the next (standard deviation about 1.1 for O, 1.2 for
    E_loc) sets the standard error of its mean over the 512. The upper
    three-sigma limit of the geometric-mean ratio must stay below 1.25, in
    O and in E_loc: a fault of the port's float32 path that makes its
    error systematically 25% larger than the reference's fails (measured
    on the CPU: 0.98, limit 1.14, for O; 0.90, limit 1.06, for E_loc). In
    float64 the packages agree within 1e-4 on the first four seeds (1e-5
    is the rank-deficient pinv's usual agreement)."""
    from peps_tpu_torch.fermion import peps as tp
    from peps_tpu_torch.peps import SimpleUpdateParams
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)
    ly = lx = 3
    m = fermion.tj_model(3.0, 1.0)
    occ = np.array([[1, 2, 1], [2, 0, 2], [1, 2, 1]])
    sp2 = tp.space_for_model(m, 2)
    su = tp.fermion_simple_update(
        tp.product_fermion_peps(ly, lx, sp2, occ, device="cpu"), m, sp2,
        SimpleUpdateParams(20, 0.1, TruncParams(2, 1, 1e-12)))
    sp4 = FermionSpace(sp2.phys_parity, 2, 2)
    jsp4 = JSpace(sp2.phys_parity, 2, 2)
    chi = 8
    jfn = {dt: jax.jit(jax.vmap(
        lambda x, c, g=j_vmc.GradedFermionModel.from_model(
            j_fermion.tj_model(3.0, 1.0), jsp4, getattr(jnp, dt)):
        j_vmc.local_energy_and_holes_graded(
            x, c, g, chi, JTrunc(chi, 1, 1e-12, scheme="sketch")),
        in_axes=(None, 0))) for dt in ("float64", "float32")}
    gms = {dt: vmc.GradedFermionModel.from_model(
        fermion.tj_model(3.0, 1.0), sp4, getattr(torch, dt), "cpu")
        for dt in ("float64", "float32")}
    errs = {"jax": [], "port": []}
    # 128 small states: one thread each op, so that the scan stays quick
    # where other test processes share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _scan_float32_holes(jfn, su, sp2, sp4, gms, occ, chi, errs)
    finally:
        torch.set_num_threads(threads)
    d = np.log(np.array(errs["port"], dtype=np.float64)
               / np.array(errs["jax"], dtype=np.float64))
    upper = d.mean(0) + 3 * d.std(0, ddof=1) / np.sqrt(len(d))
    assert np.all(upper < np.log(1.25)), np.exp(upper)


def _scan_float32_holes(jfn, su, sp2, sp4, gms, occ, chi, errs):
    """Each package's float32 and float64 holes and E_loc over 128 seeds
    of the expanded state, four configurations a seed; appends (O error,
    E_loc error) of float32 against float64 per configuration to
    errs["jax"] and errs["port"]."""
    from peps_tpu_torch.fermion import peps as tp
    ly, lx = occ.shape
    for seed in range(1, 129):
        tps = tp.expand_bond_dim_graded(
            tp.to_tps_fermion(su.peps), sp2, sp4, 1e-3,
            torch.Generator().manual_seed(seed)).numpy()
        rng = np.random.default_rng(seed)
        cfgs = np.stack([rng.permutation(occ.reshape(-1)).reshape(ly, lx)
                         for _ in range(4)]).astype(np.int32)
        res = {}
        for dt in ("float64", "float32"):
            x = tps.astype(dt)
            jr = jfn[dt](jnp.asarray(x), jnp.asarray(cfgs))
            pr = vmc.local_energy_and_holes_graded(
                t(x), t(cfgs), gms[dt], chi,
                TruncParams(chi, 1, 1e-12, scheme="sketch"))
            res[dt] = {"jax": (np.asarray(jr.o_tensor).reshape(4, -1),
                               np.asarray(jr.e_loc)),
                       "port": (pr.o_tensor.numpy().reshape(4, -1),
                                pr.e_loc.numpy())}
        if seed <= 4:
            assert rel(res["float64"]["port"][0],
                       res["float64"]["jax"][0]) < 1e-4
        for pkg in ("jax", "port"):
            (o32, e32), (o64, e64) = res["float32"][pkg], res["float64"][pkg]
            for i in range(4):
                errs[pkg].append((rel(o32[i], o64[i]),
                                  abs(e32[i] - e64[i]) / abs(e64[i])))
