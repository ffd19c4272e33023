"""complex128 through the port against the JAX package, and the complex
launch plans of the kernels.

Inputs are made with numpy from a seed (a complex TPS is a + i b of two
real draws) and go through both packages; the sketch takes the reference's
Gaussian blocks. Local energies, holes, ratio tables, K2's plain build, the
evaluator's energy, gradient and SR buffers are gauge-free contractions:
1e-10 relative. The SR solve is held on identical inputs (the reference's
buffers handed to both solvers): 1e-10. The kernels' complex bodies run
only on the card (tests/test_torch_cuda_kernels.py); here their plans,
launch meta and entry routing are checked, in Python.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm import energy as j_energy
from peps_tpu.algorithm.mc_evaluator import MCParams as JMC
from peps_tpu.algorithm.mc_evaluator import mc_energy_grad as j_grad
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.montecarlo.sweep import UpdateRule as JRule
from peps_tpu.optimizer import optimizer as j_opt
from peps_tpu.optimizer.cg import CGParams as JCG
from peps_tpu_torch.algorithm import energy
from peps_tpu_torch.algorithm.exact_sum import (all_configs,
                                                exact_sum_evaluation)
from peps_tpu_torch.algorithm.mc_evaluator import MCParams, mc_energy_grad
from peps_tpu_torch.contraction import bmps as tb
from peps_tpu_torch.kernels import centered_o as k2
from peps_tpu_torch.kernels import col_transfer as k1
from peps_tpu_torch.kernels import pair_transfer as k3
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.optimizer import optimizer as t_opt
from peps_tpu_torch.optimizer.cg import CGParams
from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps,
                                 simple_update, to_tps)
from test_torch_bmps import jax_sketch_blocks, rel
from test_torch_eval_chunk import one_thread, replayed_uniforms  # noqa: F401
from test_torch_energy import _jax_center_scale
from test_torch_sweep import neel_like_configs, random_tps

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-10
C128 = torch.complex128



@pytest.fixture
def jax_blocks(monkeypatch):
    monkeypatch.setattr(tb, "sketch_blocks", jax_sketch_blocks)


def complex_tps(rng, ly, lx, d, D):
    return random_tps(rng, ly, lx, d, D) + 1j * random_tps(rng, ly, lx, d, D)


def _setup(ly=3, lx=3, D=2, nc=3, seed=17):
    rng = np.random.default_rng(seed)
    return complex_tps(rng, ly, lx, 2, D), neel_like_configs(rng, nc, ly, lx)


@pytest.mark.parametrize("scheme", ["sketch", "svd"])
def test_local_energy_and_holes_complex(scheme, jax_blocks):
    a, cfgs = _setup()
    chi = 4
    jm = j_energy.ModelTensors.from_model(j_spin.heisenberg(), jnp.complex128)
    ref = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes(
        jnp.asarray(a), c, jm, chi,
        JTrunc(chi, 1, 1e-12, scheme=scheme))))(jnp.asarray(cfgs))
    mt = energy.ModelTensors.from_model(spin.heisenberg(), C128, "cpu")
    out = energy.local_energy_and_holes(
        torch.as_tensor(a), torch.as_tensor(cfgs), mt, chi,
        TruncParams(chi, 1, 1e-12, scheme=scheme))
    assert out.e_loc.dtype == C128 and out.o_tensor.dtype == C128
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < RTOL, f


def test_pair_pass_and_ratio_tables_complex(jax_blocks):
    """J1-J2 local energies (the two-row pair pass, K3's plain version) and
    every ratio table at chi = 3 on 3x3, D=3, where the compression
    truncates."""
    a, cfgs = _setup(D=3, seed=11)
    chi = 3
    jt = JTrunc(chi, 1, 1e-12, scheme="sketch")
    pt = TruncParams(chi, 1, 1e-12, scheme="sketch")
    jm = j_energy.ModelTensors.from_model(j_spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4),
                                          jnp.complex128)
    ref = jax.jit(jax.vmap(lambda c: j_energy.local_energy_and_holes(
        jnp.asarray(a), c, jm, chi, jt)))(jnp.asarray(cfgs))
    mt = energy.ModelTensors.from_model(spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4),
                                        C128, "cpu")
    out = energy.local_energy_and_holes(torch.as_tensor(a),
                                        torch.as_tensor(cfgs), mt, chi, pt)
    assert rel(out.e_loc, ref.e_loc) < RTOL
    assert rel(out.o_tensor, ref.o_tensor) < RTOL
    need = ("h", "v", "d", "ad")
    ref = jax.jit(jax.vmap(lambda c: j_energy.compute_ratio_tables(
        jnp.asarray(a), c, chi, jt, need)))(jnp.asarray(cfgs))
    out = energy.compute_ratio_tables(torch.as_tensor(a),
                                      torch.as_tensor(cfgs), chi, pt, need)
    for f in ("ratio1", "ratio_h", "ratio_v", "ratio_d", "ratio_ad",
              "o_tensor", "psi_loc", "log_abs_psi"):
        assert rel(getattr(out, f), getattr(ref, f)) < RTOL, f


def test_centered_o_plain_complex():
    """K2's plain version: no conjugate, psi = 0 taken as 1."""
    rng = np.random.default_rng(6)
    ns, sites, k, d = 6, 5, 16, 3
    holes = rng.standard_normal((ns, sites, k)) \
        + 1j * rng.standard_normal((ns, sites, k))
    psi = rng.standard_normal((ns, sites)) + 1j * rng.standard_normal(
        (ns, sites))
    psi[2] = 0.0                                   # a whole psi = 0 row
    cfg = rng.integers(0, d, (ns, sites))
    ref = _jax_center_scale(jnp.asarray(holes), jnp.asarray(psi),
                            jnp.asarray(cfg), d)
    out = k2.centered_o(torch.as_tensor(holes), torch.as_tensor(psi),
                        torch.as_tensor(cfg), d)
    assert out.dtype == C128
    assert rel(out, ref) < RTOL


def _mc(jax_only=False):
    a, cfgs = _setup(nc=4, seed=9)
    nc, ly, lx = cfgs.shape
    key = jax.random.PRNGKey(13)
    jm = j_energy.ModelTensors.from_model(j_spin.heisenberg(), jnp.complex128)
    ref, j_cfgs, _, _ = j_grad(
        jnp.asarray(a), jnp.asarray(cfgs), key, jm, 4,
        JTrunc(4, 1, 1e-12, scheme="sketch"), JRule("exchange"),
        JMC(num_samples=2, nchains=nc), with_sr_buffers=True)
    if jax_only:
        return a, ref
    it = iter(replayed_uniforms(key, nc, ly, lx, 2))
    mt = energy.ModelTensors.from_model(spin.heisenberg(), C128, "cpu")
    ev, out_cfgs, _ = mc_energy_grad(
        torch.as_tensor(a), torch.as_tensor(cfgs), mt, 4,
        TruncParams(4, 1, 1e-12, scheme="sketch"),
        MCParams(num_samples=2, nchains=nc), lambda: next(it),
        with_sr_buffers=True)
    return ev, ref, out_cfgs, j_cfgs


def test_mc_energy_grad_complex(jax_blocks):
    """The complex gradient is conj(a)^T eps with no factor 2 (the real
    one's 2 Re is for a real state), as the reference's."""
    ev, ref, out_cfgs, j_cfgs = _mc()
    assert np.array_equal(out_cfgs.numpy(), np.asarray(j_cfgs))
    assert ev.gradient.dtype == C128
    assert abs(float(ev.energy) - float(ref.energy)) \
        < RTOL * abs(float(ref.energy))
    assert rel(ev.gradient, ref.gradient) < RTOL
    assert rel(ev.o_samples, ref.o_samples) < RTOL
    assert rel(ev.e_samples, ref.e_samples) < RTOL
    assert rel(ev.gradient.reshape(-1), ev.o_samples.mH @ ev.e_samples) \
        < 1e-14


def test_sr_solve_complex(jax_blocks):
    """One SR-CG solve of (A^H A + shift) x = g on the reference's complex
    evaluation, in both packages."""
    a, ref = _mc(jax_only=True)
    shape = a.shape
    nat_ref, _ = j_opt.sr_natural_gradient(
        ref, j_opt.SRParams(JCG(50, 1e-12), diag_shift=1e-2), shape,
        jnp.complex128)
    ev = t_opt.Evaluation(*(None if x is None else torch.as_tensor(
        np.array(x)) for x in ref[:6]))
    nat, res = t_opt.sr_natural_gradient(
        ev, t_opt.SRParams(CGParams(50, 1e-12), diag_shift=1e-2), shape)
    assert nat.dtype == C128
    assert rel(nat, nat_ref) < RTOL


def test_complex_sr_descends():
    """tests/test_optimizer.py's complex SR test through the port's
    exact-sum evaluator: 2x3 Heisenberg, D=3, from the port's simple-update
    state in complex128, SR-CG at lr 0.2, to within 0.5% of the exact
    ground energy. The reference runs 25 iterations; 12 reach that (the
    port's ninth is within 0.3%) at half the time."""
    from tests.ed_oracle import ground_energy
    ly, lx, D, chi = 2, 3, 3, 16
    model = spin.heisenberg(1.0)
    occ = np.fromfunction(lambda y, x: (y + x) % 2, (ly, lx), dtype=int)
    res = simple_update(
        product_peps(ly, lx, D, occ, 2, dtype=C128, device="cpu"),
        model.h_h, model.h_v, SimpleUpdateParams(60, 0.1,
                                                 TruncParams(D, 1, 1e-12)))
    a = to_tps(res.peps)
    a = a / a.abs().max()
    mt = energy.ModelTensors.from_model(model, C128, "cpu")
    configs = torch.as_tensor(all_configs(ly, lx, 2))
    tp = TruncParams(chi, 1, 0.0)
    out = t_opt.iterative_optimize(
        a, lambda s, step: exact_sum_evaluation(s, configs, mt, chi, tp,
                                                with_sr_buffers=True),
        t_opt.OptimizerParams(12, t_opt.SRParams(CGParams(200, 1e-8),
                                                 diag_shift=1e-3), lr=0.2))
    e_ed = ground_energy(j_spin.heisenberg(1.0), ly, lx)
    assert out.state.dtype == C128
    assert out.lowest_energy < e_ed + 5e-3 * abs(e_ed)


# -- the complex bodies' launch plans, meta and entries (Python) ------------

K1_MAIN = (32, 8, 32, 8, 32, 8, 8, 32)        # chi 32, D 8: the pair traces
K1_SKETCH = (32, 8, 40, 8, 32, 8, 8, 40)      # the sketch's w step
K3_MAIN = (32, 8, 8, 32, 8, 32, 8, 8, 8, 8, 32)
K3_UNPLANNABLE = (48, 12, 12, 48, 12, 48, 12, 12, 12, 12, 48)


@pytest.mark.parametrize("dtype", [torch.complex64, C128])
def test_complex_plans_fit_the_main_path(dtype):
    item = 8 if dtype == torch.complex64 else 16
    for dims in (K1_MAIN, K1_SKETCH):
        p = k1.col_transfer_launch_plan(dims, dtype, 3584)
        assert p["smem_bytes"] == k1._complex_layout(
            dims, p["ta"], p["kc"], dtype)["smem_bytes"]
        assert p["smem_bytes"] <= k1.SMEM_PER_BLOCK
        assert p["mode"] == "item" and p["ctas"] == 3584
        # step 3's output tiles in registers: 32 complex64 values a thread
        # (two 4 x 4 tiles), 16 complex128 (a warp's 32 x 16 MMA tile)
        assert p["ta"] * dims[6] * dims[7] <= (32 if item == 8 else 16) \
            * k1.THREADS
    p = k3.pair_transfer_plan(K3_MAIN, dtype, 3136)
    assert p["body"] == ("simt_cx4x4_c64" if item == 8
                         else "zmma_m16n8k8_c128")
    assert p["smem_bytes"] == k3._layout(K3_MAIN, p["ta"], p["kc"],
                                         dtype)["smem_bytes"]
    assert p["smem_bytes"] <= k3.SMEM_PER_BLOCK
    # step 4's tile in registers: 16 complex outputs a thread
    assert p["ta"] * 8 * 8 * 32 <= 16 * k3.THREADS and p["ta"] >= 2
    p = k2.centered_o_plan(32, 64, 8 ** 4, 2, dtype)
    assert p["col_chunks"] * p["cols_per_cta"] >= 8 ** 4
    assert p["smem_bytes"] == 8 * 2 * 32 * item
    assert p["ctas"] == 64 * 128


@pytest.mark.parametrize("dtype", [torch.complex64, C128])
def test_complex_plans_raise_where_nothing_fits(dtype):
    with pytest.raises(RuntimeError, match="no pair_transfer plan"):
        k3.pair_transfer_plan(K3_UNPLANNABLE, dtype)
    with pytest.raises(RuntimeError, match="no col_transfer plan"):
        k1.col_transfer_launch_plan((64, 24, 64, 24, 64, 24, 24, 64), dtype)
    with pytest.raises(TypeError):
        k1.col_transfer_launch_plan(K1_MAIN, torch.int32)


def test_complex_meta_counts_complex_elements():
    """Strides in the launch meta are the tensors' own (complex elements),
    also for the right form's transposed views; the plan rides after the
    sizes."""
    x = torch.zeros(4, 6, 3, 5, dtype=C128)
    top = torch.zeros(4, 6, 2, 6, dtype=C128).transpose(-3, -1)
    site = torch.zeros(1, 2, 3, 2, 2, dtype=C128)
    bot = torch.zeros(5, 2, 7, dtype=C128)
    batch, meta = k1.launch_meta(x, top, site, bot)
    meta = list(meta)
    assert tuple(batch) == (4,)
    dims = k1.k1_dims(x, top, site, bot)
    plan = k1.col_transfer_launch_plan(dims, C128, 4, 132)
    n = len(k1.PLAN_KEYS)
    assert meta[-n:] == k1.plan_values(plan)
    assert meta[-n - 8:-n] == dims
    # env strides (batch, a, l, c) then top's (a, u, A): element counts
    assert meta[4:11] == [0, 0, 0] + list(x.stride())
    assert meta[11:18] == [0, 0, 0] + list(top.stride())
    ops = (torch.zeros(2, 6, 2, 2, 5, dtype=torch.complex64),
           torch.zeros(2, 6, 2, 6, dtype=torch.complex64),
           torch.zeros(2, 2, 2, 2, dtype=torch.complex64),
           torch.zeros(2, 2, 2, 2, dtype=torch.complex64),
           torch.zeros(2, 5, 2, 5, dtype=torch.complex64))
    _, meta = k3.launch_meta(*ops)
    plan = k3.pair_transfer_plan(k3.pair_dims(*ops), torch.complex64, 2)
    assert list(meta)[k3.META_INTS:] == [plan[k] for k in k3.PLAN_KEYS]
    assert list(meta)[4:12] == [0, 0, 0] + list(ops[0].stride())


@pytest.mark.parametrize("module", [k1, k2, k3])
def test_entries_by_dtype(module):
    """Every wrapper picks its C entry by dtype and refuses the others."""
    names = {dt: module.entry_name(dt) for dt in
             (torch.float32, torch.float64, torch.complex64, C128)}
    assert sorted(n.rsplit("_", 1)[1] for n in names.values()) == \
        ["c128", "c64", "f32", "f64"]
    for dt in (torch.int32, torch.bfloat16, torch.float16):
        with pytest.raises(TypeError):
            module.entry_name(dt)
