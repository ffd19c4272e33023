"""The simple updates' result type, parameters and energy-stall stop against
the JAX package, in float64.

Both packages run the same seeded random Gamma/Lambda state with the same
tolerances; the stop must come at the reference's step with the
reference's ``converged``. The energies agree within 1e-8 (SVD
round-off carried through the steps), so each test first checks that no
step's energy change lies within 1e-6 of the tolerance: a stop decided
by round-off would test nothing.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from peps_tpu import linalg as j_linalg
from peps_tpu import peps as j_peps
from peps_tpu import peps_cluster as j_cluster
from peps_tpu.models import spin as j_spin
from peps_tpu_torch import convert, linalg, peps, peps_cluster
from peps_tpu_torch.models import spin
from test_torch_cluster_su import random_peps
from test_torch_eval_chunk import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-8


def test_params_and_result_fields_match_reference():
    mine = [(f.name, f.default) for f in dataclasses.fields(
        peps.SimpleUpdateParams)]
    ref = [(f.name, f.default) for f in dataclasses.fields(
        j_peps.SimpleUpdateParams)]
    assert mine == ref
    assert peps.SimpleUpdateResult._fields == j_peps.SimpleUpdateResult._fields
    args = dict(steps=7, tau=0.05, energy_abs_tol=1e-4, lambda_rel_tol=1e-3,
                patience=2, min_steps=3)
    p = peps.SimpleUpdateParams(trunc=linalg.TruncParams(3, 1, 1e-9), **args)
    jp = j_peps.SimpleUpdateParams(trunc=j_linalg.TruncParams(3, 1, 1e-9),
                                   **args)
    for (name, a), (_, b) in zip(
            ((f.name, getattr(p, f.name)) for f in dataclasses.fields(p)),
            ((f.name, getattr(jp, f.name)) for f in dataclasses.fields(jp))):
        if name != "trunc":
            assert a == b, name
    r = peps.SimpleUpdateResult(None, -1.0, -2.0, 4, True, [0.5])
    jr = j_peps.SimpleUpdateResult(None, -1.0, -2.0, 4, True, [0.5])
    assert tuple(r) == tuple(jr) and r.converged and r[4] is True


def _margin(history, tol):
    diffs = np.abs(np.diff(history))
    return np.min(np.abs(diffs - tol)) if diffs.size else np.inf


def _run(kind, ly, lx, D, steps, tol, patience, min_steps, seed):
    g, lam_v, lam_h = random_peps(np.random.default_rng(seed), ly, lx, 2, D)
    jstart = j_peps.PEPS(jnp.asarray(g), jnp.asarray(lam_v),
                         jnp.asarray(lam_h))
    start = convert.peps_from_numpy(g, lam_v, lam_h, "cpu")
    kw = dict(steps=steps, tau=0.1, energy_abs_tol=tol, patience=patience,
              min_steps=min_steps)
    jparams = j_peps.SimpleUpdateParams(
        trunc=j_linalg.TruncParams(D, 1, 1e-12), **kw)
    params = peps.SimpleUpdateParams(trunc=linalg.TruncParams(D, 1, 1e-12),
                                     **kw)
    seen, j_seen = [], []
    if kind == "nn":
        m, jm = spin.heisenberg(), j_spin.heisenberg()
        ref = j_peps.simple_update(jstart, jm.h_h, jm.h_v, jparams,
                                   step_observer=lambda **k: j_seen.append(k))
        out = peps.simple_update(start, m.h_h, m.h_v, params,
                                 step_observer=lambda **k: seen.append(k))
    else:
        fn, jfn = ((peps_cluster.simple_update_nnn, j_cluster.simple_update_nnn)
                   if kind == "nnn" else
                   (peps_cluster.simple_update_triangle,
                    j_cluster.simple_update_triangle))
        m = spin.j1j2_xxz(1, 1, 0.5, 0.5) if kind == "nnn" \
            else spin.triangle_heisenberg()
        jm = j_spin.j1j2_xxz(1, 1, 0.5, 0.5) if kind == "nnn" \
            else j_spin.SquareLatticeModel(2, m.h_h, m.h_v, h_d=m.h_d)
        ref = jfn(jstart, jm, jparams,
                  step_observer=lambda **k: j_seen.append(k))
        out = fn(start, m, params, step_observer=lambda **k: seen.append(k))
    return out, ref, seen, j_seen


@pytest.mark.parametrize("kind,ly,lx,D,tol", [("nn", 3, 3, 2, 2e-2),
                                              ("nnn", 3, 3, 2, 3e-2)])
def test_stall_stop_matches_reference(kind, ly, lx, D, tol):
    """The stop fires before the step cap, at the reference's step, with the
    same history and the same observer calls."""
    steps, patience, min_steps = 40, 2, 4
    out, ref, seen, j_seen = _run(kind, ly, lx, D, steps, tol, patience,
                                  min_steps, seed=ly * 10 + lx + len(kind))
    assert _margin(ref.energy_history, tol) > 1e-6
    assert ref.converged and ref.executed_steps < steps
    assert (out.executed_steps, out.converged) == \
        (ref.executed_steps, ref.converged)
    assert len(out.energy_history) == out.executed_steps
    np.testing.assert_allclose(out.energy_history, ref.energy_history,
                               rtol=RTOL)
    assert abs(out.estimated_e0 - ref.estimated_e0) \
        < RTOL * abs(ref.estimated_e0)
    assert abs(out.estimated_en - ref.estimated_en) \
        < RTOL * abs(ref.estimated_en)
    assert [s["step"] for s in seen] == [s["step"] for s in j_seen] \
        == list(range(1, out.executed_steps + 1))
    assert all(a.keys() == b.keys() for a, b in zip(seen, j_seen))
    np.testing.assert_allclose([s["e0"] for s in seen],
                               [s["e0"] for s in j_seen], rtol=RTOL)


@pytest.mark.parametrize("kind", ["nn", "nnn"])
def test_no_tolerance_runs_every_step(kind):
    """energy_abs_tol = 0: the cap, converged False, as the reference."""
    out, ref, seen, _ = _run(kind, 2, 3, 2, 3, 0.0, 1, 1, seed=4)
    assert (out.executed_steps, out.converged) == \
        (ref.executed_steps, ref.converged) == (3, False)
    assert len(seen) == 3


def test_triangle_update_never_stops():
    """simple_update_triangle keeps no stop: every step, converged False,
    the lambda-sum history and NaN energies in the observer, as the
    reference's."""
    out, ref, seen, j_seen = _run("triangle", 3, 3, 2, 3, 1.0, 1, 1, seed=6)
    assert (out.executed_steps, out.converged) == \
        (ref.executed_steps, ref.converged) == (3, False)
    np.testing.assert_allclose(out.energy_history, ref.energy_history,
                               rtol=RTOL)
    assert len(seen) == len(j_seen) == 3
    assert all(np.isnan(s["e0"]) and np.isnan(s["en"]) for s in seen)
