"""The port's optimizer layer (peps_tpu_torch.optimizer: optimizer.py,
schedulers.py, krylov.py, and api.py) against the JAX package, in float64
unless said otherwise. Inputs come from np.random.default_rng(seed); the
loop tests drive both packages' exact-sum evaluators on the 2x3, D=3,
chi=16 Heisenberg state of tests/test_optimizer.py.

Tolerances (relative): update rules 1e-12; schedulers 1e-15; SR and dense
MinSR natural gradients 1e-10; Krylov MinSR 1e-8; loop trajectories and
spike runs 1e-9 (energies, lr and the final state); float32 MinSR within
1e-4 of float64 on the same inputs.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu import api as j_api
from peps_tpu.algorithm.energy import ModelTensors as JModelTensors
from peps_tpu.algorithm.exact_sum import sector_configs as j_sector_configs
from peps_tpu.algorithm.exact_sum import \
    exact_sum_evaluation as j_exact_evaluation
from peps_tpu.linalg import TruncParams as JTrunc
from peps_tpu.models import spin as j_spin
from peps_tpu.optimizer import krylov as j_krylov
from peps_tpu.optimizer import optimizer as jo
from peps_tpu.optimizer import schedulers as j_sched
from peps_tpu.optimizer.cg import CGParams as JCG
from peps_tpu.peps import SimpleUpdateParams as JSUParams
from peps_tpu.peps import product_peps as j_product_peps
from peps_tpu.peps import simple_update as j_simple_update
from peps_tpu.peps import to_tps as j_to_tps
from peps_tpu_torch import api
from peps_tpu_torch.algorithm.exact_sum import (exact_sum_energy_gradient,
                                                exact_sum_evaluation)
from peps_tpu_torch.lattice import boundary_mask
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.optimizer import krylov
from peps_tpu_torch.optimizer import optimizer as to
from peps_tpu_torch.optimizer import schedulers
from peps_tpu_torch.optimizer.cg import CGParams

CHI = 16
LY, LX, D = 2, 3, 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# The 2x3 exact-sum setup, built once per module
# ---------------------------------------------------------------------------

_CACHE = {}


def setup():
    """(tps numpy [2, 3, 2, 3, 3, 3, 3], configs numpy [20, 2, 3]): the
    simple-update state of tests/test_optimizer.py, scaled to max 1, plus
    0.05 Gaussian noise (seed 0) on its non-boundary entries, and the
    Sz = 0 sector that the exchange sampler keeps (a third of the
    evaluation cost of all 64 configurations). The noise matters: the
    simple-update state conserves Sz and keeps the Neel state's
    symmetries, so many amplitudes are zero up to round-off (|psi| about
    1e-29 against 0.25), where both packages' E_loc and O = holes / psi are
    round-off noise that the sqrt(w) weighting brings back to order one in
    the SR buffers."""
    if "tps" not in _CACHE:
        model = j_spin.heisenberg(1.0)
        occ = np.fromfunction(lambda y, x: (y + x) % 2, (LY, LX), dtype=int)
        peps = j_product_peps(LY, LX, D, occ, 2, dtype=jnp.float64)
        res = j_simple_update(peps, model.h_h, model.h_v,
                              JSUParams(steps=60, tau=0.1,
                                        trunc=JTrunc(D, 1, 1e-12)))
        tps = j_to_tps(res.peps)
        tps = np.array(tps / jnp.max(jnp.abs(tps)))
        mask = boundary_mask(LY, LX, 2, D)
        _CACHE["tps"] = tps + 0.05 * np.random.default_rng(0) \
            .standard_normal(tps.shape) * mask
        _CACHE["configs"] = j_sector_configs(LY, LX, {0: 3, 1: 3})
        _CACHE["jmt"] = JModelTensors.from_model(model, jnp.float64)
    return _CACHE["tps"], _CACHE["configs"]


def jax_evaluators(with_sr):
    setup()
    configs, mt = jnp.asarray(_CACHE["configs"]), _CACHE["jmt"]
    tp = JTrunc(CHI, 1, 0.0)

    def evaluate(state, step):
        return j_exact_evaluation(state, configs, mt, CHI, tp,
                                  with_sr_buffers=with_sr)

    def energy_only(state):
        return j_exact_evaluation(state, configs, mt, CHI, tp).energy

    return evaluate, energy_only


def torch_evaluators(with_sr):
    _, configs = setup()
    model, tp = spin.heisenberg(1.0), TruncParams(CHI, 1, 0.0)

    def evaluate(state, step):
        return exact_sum_evaluation(state, configs, model, CHI, tp,
                                    with_sr_buffers=with_sr)

    def energy_only(state):
        return exact_sum_energy_gradient(state, configs, model, CHI, tp,
                                         with_grad=False).energy

    return evaluate, energy_only


def one_evaluation():
    """One exact-sum evaluation with SR buffers in both packages."""
    if "ev" not in _CACHE:
        tps, _ = setup()
        _CACHE["jev"] = jax_evaluators(True)[0](jnp.asarray(tps), 0)
        _CACHE["ev"] = torch_evaluators(True)[0](torch.as_tensor(tps), 0)
    return _CACHE["jev"], _CACHE["ev"]


# ---------------------------------------------------------------------------
# Update rules, clipping and schedulers
# ---------------------------------------------------------------------------

UPDATE_CASES = {
    "sgd": ("sgd_update", lambda m: m.SGDParams()),
    "sgd_momentum": ("sgd_update", lambda m: m.SGDParams(momentum=0.9)),
    "sgd_nesterov": ("sgd_update",
                     lambda m: m.SGDParams(momentum=0.9, nesterov=True)),
    "adagrad": ("adagrad_update",
                lambda m: m.AdaGradParams(initial_accumulator=0.1)),
    "adam": ("adam_update", lambda m: m.AdamParams()),
    "adam_weight_decay": ("adam_update",
                          lambda m: m.AdamParams(weight_decay=0.01)),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_rules_match_reference(case):
    """Five successive updates from the same state and gradients."""
    fn, make = UPDATE_CASES[case]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 5))
    grads = [rng.standard_normal(x.shape) for _ in range(5)]
    js, ts = jnp.asarray(x), torch.as_tensor(x)
    jst, tst = {}, {}
    for k, g in enumerate(grads):
        lr = 0.05 * (k + 1)
        js, jst = getattr(jo, fn)(js, jnp.asarray(g), lr, jst, make(jo))
        ts, tst = getattr(to, fn)(ts, torch.as_tensor(g), lr, tst, make(to))
        assert rel(ts, js) <= 1e-12, (case, k)
    assert sorted(tst) == sorted(jst)
    for key in tst:
        assert rel(tst[key], jst[key]) <= 1e-12, key


@pytest.mark.parametrize("clip", ["value", "norm", "both"])
def test_clip_matches_reference(clip):
    rng = np.random.default_rng(2)
    g = rng.standard_normal((4, 6)) * 3.0
    kw = {"value": dict(clip_value=1.5), "norm": dict(clip_norm=2.0),
          "both": dict(clip_value=1.5, clip_norm=2.0)}[clip]
    jp = jo.OptimizerParams(1, jo.SGDParams(), **kw)
    tp = to.OptimizerParams(1, to.SGDParams(), **kw)
    out = to._clip(torch.as_tensor(g), tp)
    assert rel(out, jo._clip(jnp.asarray(g), jp)) <= 1e-12
    assert not np.allclose(out.numpy(), g)


ENERGIES = [1.0 - 0.02 * k if k < 20 else 0.6 + 0.001 * ((-1) ** k)
            for k in range(50)]


@pytest.mark.parametrize("name,args", [
    ("Constant", (0.1,)),
    ("ExponentialDecay", (0.1, 0.5, 7)),
    ("StepDecay", (0.1, 0.7, 6)),
    ("CosineAnnealing", (0.1, 40, 0.005)),
    ("Plateau", (0.1, 0.5, 4, 1e-3, 0.01)),
])
def test_schedulers_match_reference(name, args):
    """50 steps with a fixed energy sequence that improves for 20 steps,
    then stalls; Plateau keeps its state across calls and must reduce."""
    js, ts = getattr(j_sched, name)(*args), getattr(schedulers, name)(*args)
    got = [ts(k, e) for k, e in enumerate(ENERGIES)]
    ref = [js(k, e) for k, e in enumerate(ENERGIES)]
    assert np.allclose(got, ref, rtol=1e-15, atol=0)
    if name == "Plateau":
        assert min(got) < args[0]
    p = to.OptimizerParams(3, to.SGDParams(),
                           lr=getattr(schedulers, name)(*args))
    assert p.lr_at(0, 1.0) == pytest.approx(ref[0], rel=1e-15)


@pytest.mark.parametrize("case", ["adam", "sgd_momentum", "adagrad"])
def test_rollback_snapshot_is_not_changed_by_later_updates(case):
    """The loop's rollback snapshot is dict(opt_state): it shares the
    moment tensors. Three more updates must leave them bit-identical, so
    every update rule builds new tensors."""
    fn, make = UPDATE_CASES[case]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((5, 7)))
    st = {}
    for _ in range(2):
        x, st = getattr(to, fn)(x, torch.as_tensor(
            rng.standard_normal((5, 7))), 0.1, st, make(to))
    snapshot = dict(st)
    before = {k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in snapshot.items()}
    for _ in range(3):
        x, st = getattr(to, fn)(x, torch.as_tensor(
            rng.standard_normal((5, 7))), 0.1, st, make(to))
    for k, v in before.items():
        if torch.is_tensor(v):
            assert torch.equal(snapshot[k], v), k
            assert not torch.equal(st[k], v), k
        else:
            assert snapshot[k] == v
    if case == "adam":
        assert snapshot["t"] == 2 and st["t"] == 5


# ---------------------------------------------------------------------------
# Natural gradients on one exact-sum evaluation
# ---------------------------------------------------------------------------


def test_sr_normalize_update_matches_reference():
    jev, ev = one_evaluation()
    shape = ev.gradient.shape
    ref, jres = jo.sr_natural_gradient(
        jev, jo.SRParams(JCG(300, 1e-10), diag_shift=0.05,
                         normalize_update=True), shape, jnp.float64)
    got, res = to.sr_natural_gradient(
        ev, to.SRParams(CGParams(300, 1e-10), diag_shift=0.05,
                        normalize_update=True), shape)
    assert int(res.iterations) == int(jres.iterations)
    assert rel(got, ref) <= 1e-10
    # unit norm in the metric S + shift that the solve used
    nat = got.reshape(-1)
    s_norm = float((ev.o_samples @ nat).square().sum()
                   + 0.05 * nat.square().sum())
    assert s_norm == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("cutoff", [1e-8, 1e-3])
def test_minsr_dense_matches_reference(cutoff):
    jev, ev = one_evaluation()
    shape = ev.gradient.shape
    ref = jo.minsr_natural_gradient(
        jev, jo.MinSRParams(pseudo_inverse_cutoff=cutoff), shape)
    got = to.minsr_natural_gradient(
        ev, to.MinSRParams(pseudo_inverse_cutoff=cutoff), shape)
    assert rel(got, ref) <= 1e-10


def test_minsr_krylov_full_matches_reference_and_dense():
    """m = Ns (20 configurations): the Krylov path equals the reference's
    Krylov and the dense path."""
    jev, ev = one_evaluation()
    shape, ns = ev.gradient.shape, ev.o_samples.shape[0]
    got = krylov.minsr_krylov_natural_gradient(ev.o_samples, ev.e_samples,
                                               1e-8, ns, shape)
    ref = j_krylov.minsr_krylov_natural_gradient(jev.o_samples, jev.e_samples,
                                                 1e-8, ns, shape)
    dense = to.minsr_natural_gradient(ev, to.MinSRParams(), shape)
    assert rel(got, ref) <= 1e-8
    assert rel(got, dense) <= 1e-8


@pytest.mark.parametrize("m", [6, 12])
def test_minsr_krylov_partial_matches_reference(m):
    jev, ev = one_evaluation()
    shape = ev.gradient.shape
    got = krylov.minsr_krylov_natural_gradient(ev.o_samples, ev.e_samples,
                                               1e-6, m, shape)
    ref = j_krylov.minsr_krylov_natural_gradient(jev.o_samples, jev.e_samples,
                                                 1e-6, m, shape)
    assert rel(got, ref) <= 1e-8


def test_minsr_krylov_breakdown_low_rank():
    """Rank-5 A with Ns = 32 (tests/test_krylov_minsr.py's breakdown case):
    the Lanczos recurrence stops at the guard and the port's Krylov path
    equals the reference's dense and Krylov paths."""
    ns, p, r = 32, 40, 5
    rng = np.random.default_rng(7)
    a = rng.normal(size=(ns, r)) @ rng.normal(size=(r, p)) / np.sqrt(ns)
    eps = rng.normal(size=(ns,))
    got = krylov.minsr_krylov_natural_gradient(
        torch.as_tensor(a), torch.as_tensor(eps), 1e-8, ns, (p,))
    jev = jo.Evaluation(jnp.zeros(()), jnp.zeros(p), o_samples=jnp.asarray(a),
                        e_samples=jnp.asarray(eps))
    dense = jo.minsr_natural_gradient(jev, jo.MinSRParams(), (p,))
    ref = j_krylov.minsr_krylov_natural_gradient(
        jnp.asarray(a), jnp.asarray(eps), 1e-8, ns, (p,))
    assert rel(got, dense) <= 1e-8
    assert rel(got, ref) <= 1e-8


def test_lanczos_fn_apply_generic_function():
    """exp(T) b through the port's Lanczos against the dense result."""
    n = 20
    rng = np.random.default_rng(13)
    h = rng.normal(size=(n, n))
    t = (h @ h.T) / n
    b = rng.normal(size=(n,))
    lam, u = np.linalg.eigh(t)
    tt = torch.as_tensor(t)
    got = krylov.lanczos_fn_apply(lambda v: tt @ v, torch.as_tensor(b), n,
                                  torch.exp)
    assert rel(got, u @ (np.exp(lam) * (u.T @ b))) <= 1e-9


def f32_minsr_inputs():
    """Ns=32, P=4096 Gaussian O rows (0.05 standard_normal, seed 0) and
    residuals, both centered and scaled by 1/sqrt(Ns), in float32: the
    Gram has one eigenvalue at round-off level (about 1e-9 against a
    largest of 0.37)."""
    rng = np.random.default_rng(0)
    o = rng.standard_normal((32, 4096)) * 0.05
    a = ((o - o.mean(0)) / np.sqrt(32)).astype(np.float32)
    e = rng.standard_normal(32)
    eps = ((e - e.mean()) / np.sqrt(32)).astype(np.float32)
    return a, eps


def test_minsr_float32_filter_is_finite(record_property):
    """The reference's soft filter lam^5 / (lam^6 + c^6) underflows to 0/0
    in float32 on these inputs (ROADMAP, known faults of the reference);
    the port's dense and Krylov (m = Ns) paths stay finite and within 1e-4
    of the float64 result on the same inputs. Whether the reference is
    finite here depends on denormal handling, so it is recorded, not
    asserted."""
    a, eps = f32_minsr_inputs()
    p = to.MinSRParams(pseudo_inverse_cutoff=1e-8)

    def dense(x, y):
        ev = to.Evaluation(torch.zeros(()), torch.zeros(x.shape[1]),
                           o_samples=torch.as_tensor(x),
                           e_samples=torch.as_tensor(y))
        return to.minsr_natural_gradient(ev, p, (x.shape[1],)).numpy()

    ref64 = dense(a.astype(np.float64), eps.astype(np.float64))
    d32 = dense(a, eps)
    k32 = krylov.minsr_krylov_natural_gradient(
        torch.as_tensor(a), torch.as_tensor(eps), 1e-8, 32, (4096,)).numpy()
    assert d32.dtype == np.float32 and k32.dtype == np.float32
    assert np.isfinite(d32).all() and np.isfinite(k32).all()
    assert rel(d32, ref64) <= 1e-4
    assert rel(k32, ref64) <= 1e-4
    jev = jo.Evaluation(jnp.zeros(()), jnp.zeros(4096, jnp.float32),
                        o_samples=jnp.asarray(a), e_samples=jnp.asarray(eps))
    ref32 = np.asarray(jo.minsr_natural_gradient(jev, jo.MinSRParams(),
                                                 (4096,)))
    assert ref32.dtype == np.float32
    record_property("reference_float32_finite", bool(np.isfinite(ref32).all()))


# ---------------------------------------------------------------------------
# L-BFGS pieces
# ---------------------------------------------------------------------------


def test_lbfgs_direction_matches_reference():
    rng = np.random.default_rng(4)
    jm, tm = jo._LBFGSMemory(3), to._LBFGSMemory(3)
    for _ in range(4):
        s = rng.standard_normal((3, 5))
        y = s * (1.0 + rng.random((3, 5))) + 0.1 * rng.standard_normal((3, 5))
        jm.push(jnp.asarray(s), jnp.asarray(y))
        tm.push(torch.as_tensor(s), torch.as_tensor(y))
    # a pair with s.y <= 1e-12 is not kept
    s = rng.standard_normal((3, 5))
    jm.push(jnp.asarray(s), -jnp.asarray(s))
    tm.push(torch.as_tensor(s), -torch.as_tensor(s))
    assert len(tm.s) == len(jm.s) == 3
    g = rng.standard_normal((3, 5))
    assert rel(tm.direction(torch.as_tensor(g)),
               jm.direction(jnp.asarray(g))) <= 1e-12
    snap = tm.snapshot()
    tm.reset()
    assert rel(tm.direction(torch.as_tensor(g)), g) == 0.0
    tm.restore(snap)
    assert rel(tm.direction(torch.as_tensor(g)),
               jm.direction(jnp.asarray(g))) <= 1e-12


@pytest.mark.parametrize("lr", [0.01, 0.1, 1.0, 10.0, "ascent"])
def test_strong_wolfe_matches_reference(lr):
    """phi(a) = a^4 - a (tests/test_optimizer.py): the same (ok, alpha,
    n_evals) as the reference."""
    p = dict(c1=1e-4, c2=0.9, max_eval=30)

    def eval_fg(a):
        return a ** 4 - a, 4.0 * a ** 3 - 1.0, a

    dphi0 = 1.0 if lr == "ascent" else -1.0
    lr = 0.1 if lr == "ascent" else lr
    got = to._strong_wolfe(eval_fg, 0.0, dphi0, lr, to.LBFGSParams(**p))
    ref = jo._strong_wolfe(eval_fg, 0.0, dphi0, lr, jo.LBFGSParams(**p))
    assert (got[0], got[2], got[3]) == (ref[0], ref[2], ref[3])


# ---------------------------------------------------------------------------
# The loop against the reference's
# ---------------------------------------------------------------------------

LOOP_CASES = {
    "sgd_momentum": (lambda m: m.SGDParams(momentum=0.9), 0.02, {}),
    "adagrad": (lambda m: m.AdaGradParams(), 0.05, {}),
    "adam": (lambda m: m.AdamParams(), 0.02, {}),
    # CG to 1e-9: every solve ends 6-10x below its tolerance; at 1e-10 a
    # last residual sat at the threshold and the counts differed by one
    "sr": (lambda m: m.SRParams(
        (JCG if m is jo else CGParams)(200, 1e-9), diag_shift=0.05), 0.1,
        {}),
    "minsr": (lambda m: m.MinSRParams(pseudo_inverse_cutoff=1e-8), 0.1, {}),
    "minsr_krylov": (lambda m: m.MinSRParams(pseudo_inverse_cutoff=1e-8,
                                             krylov_iters=12), 0.1, {}),
    "lbfgs_fixed": (lambda m: m.LBFGSParams(line_search="fixed"), 0.02, {}),
    "lbfgs_armijo": (lambda m: m.LBFGSParams(line_search="armijo"), 0.05,
                     {}),
    "lbfgs_strong_wolfe": (lambda m: m.LBFGSParams(max_eval=6), 0.05, {}),
    "adam_decay_clip_selector": (
        lambda m: m.AdamParams(), "decay",
        {"clip_norm": 0.5, "step_selector": "selector"}),
}


def _optimizer_params(m, case, **extra):
    make, lr, kw = LOOP_CASES[case]
    sched = j_sched if m is jo else schedulers
    kw = dict(kw)
    if lr == "decay":
        lr = sched.ExponentialDecay(0.03, 0.5, 2)
    if kw.get("step_selector") == "selector":
        kw["step_selector"] = m.StepSelectorParams(candidates=(0.5, 1.0, 2.0),
                                                   every_n=3)
    return m.OptimizerParams(max_iters=4, algorithm=make(m), lr=lr, **kw,
                             **extra)


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_iterative_optimize_matches_reference(case):
    """Four iterations of each algorithm through both loops, each driven by
    its package's exact-sum evaluator: energies, lr and CG iterations per
    record agree, and the final states within 1e-9."""
    tps, _ = setup()
    sr = case.startswith(("sr", "minsr"))
    jev, jeo = jax_evaluators(sr)
    tev, teo = torch_evaluators(sr)
    ref = jo.iterative_optimize(jnp.asarray(tps), jev,
                                _optimizer_params(jo, case),
                                evaluate_energy_only=jeo)
    out = to.iterative_optimize(torch.as_tensor(tps), tev,
                                _optimizer_params(to, case),
                                evaluate_energy_only=teo)
    assert len(out.records) == len(ref.records) == 4
    for r, jr in zip(out.records, ref.records):
        assert r.energy == pytest.approx(jr.energy, rel=1e-9, abs=0)
        assert r.lr == pytest.approx(jr.lr, rel=1e-12, abs=0)
        assert r.sr_iters == jr.sr_iters
        assert r.grad_norm == pytest.approx(jr.grad_norm, rel=1e-9, abs=0)
        assert r.natural_grad_norm == pytest.approx(jr.natural_grad_norm,
                                                    rel=1e-9, abs=1e-300)
    assert rel(out.state, ref.state) <= 1e-9
    assert out.lowest_energy == pytest.approx(ref.lowest_energy, rel=1e-9)
    assert out.energies[-1] < out.energies[0]


def _spiking(evaluate, case, pkg):
    """The scripted spikes of tests/test_optimizer.py:181-254."""
    hit = {"n": 0}

    def num(x):
        return jnp.asarray(x, jnp.float64) if pkg is jo else \
            torch.tensor(x, dtype=torch.float64)

    def spiked(state, step):
        ev = evaluate(state, step)
        if case.startswith("s1"):
            if step == 3 and hit["n"] == 0:
                hit["n"] += 1
                return ev._replace(energy_error=num(10.0))
            return ev._replace(energy_error=num(0.01))
        if case.startswith("s3") and step == 4 and hit["n"] == 0:
            hit["n"] += 1
            return ev._replace(gradient=100.0 * ev.gradient)
        if case == "s4" and step == 4 and hit["n"] == 0:
            hit["n"] += 1
            return ev._replace(energy=ev.energy + 100.0)
        return ev
    return spiked


def _spike_params(m, case, log_csv=None):
    if case == "s1_rollback":
        # no retries: the spike rolls back at once, Adam's moments with it
        return m.OptimizerParams(
            max_iters=6, algorithm=m.AdamParams(), lr=0.02,
            spike=m.SpikeParams(enabled=True, threshold=5.0, max_retries=0,
                                log_csv=log_csv))
    if case == "s3_rollback":
        # no retries: the solve is rejected, the update skipped, the state
        # and CG warm start rolled back
        return m.OptimizerParams(
            max_iters=6, algorithm=m.SRParams(
                (JCG if m is jo else CGParams)(500, 1e-11), diag_shift=1e-3),
            lr=0.1, spike=m.SpikeParams(enabled=True, threshold=1e9,
                                        factor_ngrad=5.0, max_retries=0,
                                        log_csv=log_csv))
    if case == "s1":
        return m.OptimizerParams(
            max_iters=6, algorithm=m.SGDParams(), lr=0.05,
            spike=m.SpikeParams(enabled=True, threshold=5.0, max_retries=2,
                                log_csv=log_csv))
    if case == "s3":
        return m.OptimizerParams(
            max_iters=6, algorithm=m.SRParams(
                (JCG if m is jo else CGParams)(500, 1e-11), diag_shift=1e-3),
            lr=0.1, spike=m.SpikeParams(enabled=True, threshold=1e9,
                                        factor_ngrad=5.0, max_retries=2,
                                        log_csv=log_csv))
    return m.OptimizerParams(
        max_iters=8, algorithm=m.AdamParams(), lr=0.02,
        spike=m.SpikeParams(enable_rollback=True, sigma_k=3.0, ema_alpha=0.5,
                            log_csv=log_csv))


@pytest.mark.parametrize("case", ["s1", "s1_rollback", "s3", "s3_rollback",
                                  "s4"])
def test_spike_runs_match_reference(case, tmp_path):
    """S1 resample, S3 resample and S4 rollback (restoring Adam's moments),
    and S1 and S3 with no retries (rollback at once) through both loops: the same events, values within 1e-9, final states
    within 1e-9; the spike CSV holds one header and one line per event.
    The S3 run solves to 1e-11 (the reference's test: 1e-8), so that the
    natural-gradient norms it compares are converged past 1e-9."""
    tps, _ = setup()
    sr = case.startswith("s3")
    ref = jo.iterative_optimize(
        jnp.asarray(tps), _spiking(jax_evaluators(sr)[0], case, jo),
        _spike_params(jo, case))
    csv = tmp_path / "spikes.csv"
    out = to.iterative_optimize(
        torch.as_tensor(tps), _spiking(torch_evaluators(sr)[0], case, to),
        _spike_params(to, case, str(csv)))
    assert [e[:3] for e in out.spike_events] == \
        [e[:3] for e in ref.spike_events]
    want = {"s1": ("S1", "resample"), "s3": ("S3", "resample"),
            "s1_rollback": ("S1", "rollback"),
            "s3_rollback": ("S3", "rollback"),
            "s4": ("S4", "rollback")}[case]
    assert want in [e[1:3] for e in out.spike_events]
    for e, je in zip(out.spike_events, ref.spike_events):
        assert e[3] == pytest.approx(je[3], rel=1e-9)
        assert e[4] == pytest.approx(je[4], rel=1e-9)
    assert out.energies == pytest.approx(ref.energies, rel=1e-9)
    assert rel(out.state, ref.state) <= 1e-9
    lines = csv.read_text().splitlines()
    assert lines[0] == "step,signal,action,value,threshold"
    assert len(lines) == 1 + len(out.spike_events)


# ---------------------------------------------------------------------------
# Files, profiler, should_stop and the api surface
# ---------------------------------------------------------------------------


def test_checkpoints_load_with_numpy(tmp_path):
    """state_step{n}.npy holds the state the callback saw, and the
    reference's file of the same run holds the same state: either package
    reads the other's checkpoints."""
    tps, _ = setup()
    seen = {}
    kw = dict(max_iters=2, lr=0.05, checkpoint_every=1)
    out = to.iterative_optimize(
        torch.as_tensor(tps), torch_evaluators(False)[0],
        to.OptimizerParams(algorithm=to.SGDParams(),
                           checkpoint_path=str(tmp_path / "t"), **kw),
        callback=lambda rec, s: seen.setdefault(rec.step + 1, s.numpy()))
    jo.iterative_optimize(
        jnp.asarray(tps), jax_evaluators(False)[0],
        jo.OptimizerParams(algorithm=jo.SGDParams(),
                           checkpoint_path=str(tmp_path / "j"), **kw))
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == \
        ["state_step1.npy", "state_step2.npy"]
    for n in (1, 2):
        got = np.load(tmp_path / "t" / f"state_step{n}.npy")
        assert got.dtype == np.float64 and np.array_equal(got, seen[n])
        assert rel(got, np.load(tmp_path / "j" / f"state_step{n}.npy")) \
            <= 1e-9
    assert np.array_equal(seen[2], out.state.numpy())


def test_trajectory_csv_header_written_once(tmp_path):
    """Two runs into one trajectory CSV: the port writes the header once;
    the reference writes it again on every run (a known fault, ROADMAP
    section 3), so its file holds two."""
    tps, _ = setup()
    for m, tag, ev, num in ((to, "t", torch_evaluators(False)[0],
                             torch.as_tensor),
                            (jo, "j", jax_evaluators(False)[0],
                             jnp.asarray)):
        path = str(tmp_path / f"{tag}.csv")
        for _ in range(2):
            m.iterative_optimize(num(tps), ev, m.OptimizerParams(
                max_iters=2, algorithm=m.SGDParams(), lr=0.05,
                trajectory_csv=path))
    port = (tmp_path / "t.csv").read_text().splitlines()
    ref = (tmp_path / "j.csv").read_text().splitlines()
    assert port.count("step,energy,energy_error") == 1
    assert ref.count("step,energy,energy_error") == 2
    assert port[0] == "step,energy,energy_error" and len(port) == 5
    rows = [ln.split(",") for ln in port[1:]]
    jrows = [ln.split(",") for ln in ref if not ln.startswith("step,")]
    assert [r[0] for r in rows] == [r[0] for r in jrows] == \
        ["0", "1", "0", "1"]
    assert np.allclose([float(r[1]) for r in rows],
                       [float(r[1]) for r in jrows], rtol=1e-9, atol=0)


def test_jsonl_record_keys_match_reference(tmp_path):
    tps, _ = setup()
    for m, tag, ev, num in ((to, "t", torch_evaluators(False)[0],
                             torch.as_tensor),
                            (jo, "j", jax_evaluators(False)[0],
                             jnp.asarray)):
        m.iterative_optimize(num(tps), ev, m.OptimizerParams(
            max_iters=2, algorithm=m.SGDParams(), lr=0.05,
            log_path=str(tmp_path / f"{tag}.jsonl")))
    port = [json.loads(ln) for ln in
            (tmp_path / "t.jsonl").read_text().splitlines()]
    ref = [json.loads(ln) for ln in
           (tmp_path / "j.jsonl").read_text().splitlines()]
    assert len(port) == len(ref) == 2
    assert [list(r) for r in port] == [list(r) for r in ref]
    assert port[1]["energy"] == pytest.approx(ref[1]["energy"], rel=1e-9)


def test_profile_dir_writes_trace_and_should_stop(tmp_path):
    """torch.profiler over iterations [1, 5) of a run that should_stop ends
    after iteration 2: the trace is closed after the loop and written."""
    tps, _ = setup()
    out = to.iterative_optimize(
        torch.as_tensor(tps), torch_evaluators(False)[0],
        to.OptimizerParams(max_iters=6, algorithm=to.SGDParams(), lr=0.05,
                           should_stop=lambda rec: rec.step == 2,
                           profile_dir=str(tmp_path / "prof"),
                           profile_start=1, profile_stop=5))
    assert len(out.records) == 3
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["trace_steps1-3.json"]
    assert json.loads((tmp_path / "prof" / traces[0]).read_text())
    with pytest.raises(ValueError, match="profile_stop"):
        to.OptimizerParams(1, to.SGDParams(), profile_dir="x",
                           profile_start=2, profile_stop=2)


def test_api_names_are_the_references():
    assert set(api.__all__) <= set(j_api.__all__)
    for name in api.__all__:
        assert getattr(api, name) is not None
    for name in ("vmc_optimize", "measure", "MinSRParams", "LBFGSParams",
                 "AdamParams", "AdaGradParams", "OptimizerParams"):
        assert name in api.__all__
