"""Adversarial random-state oracles for the port's graded kernels, mirroring
tests/test_graded_adversarial.py on random parity-even states far from
equilibrium (tests/torch_fermion_util.random_graded_tps), in float64 and
complex128:

1. the vertical pass of the env-shared sweep: chained shared-vs-oracle
   trajectories from starts whose first sweep can only move through
   vertical bonds (uniform rows make every horizontal exchange an
   identity);
2. the diagonal (t2) channel tables: graded local energies of a whole
   sector against the snake-ordered second-quantized ED matrix;
3. the Jastrow-dressed env-shared sweep against its oracle, chained;
4. the row-frame env-shared pair walker and 5. the column-frame one against
   the exact-coefficient mode-algebra oracle, every entry;
6. the full-space Suwa-Todo with the t-J conservation mask: no chain
   leaves the sector and the visits follow the exact sector distribution.

These consume K4's candidates and flip masks (the dressing) on the CPU
through its plain version. Uniforms come from a seeded torch generator and
go to both sides of each equivalence.
"""
import itertools

import numpy as np
import pytest
import torch

import tests.fermion_ed_oracle as FO
from peps_tpu.models import fermion as j_fermion
from peps_tpu_torch.algorithm.exact_sum import sector_configs
from peps_tpu_torch.algorithm.measure_fermion import (
    tj_singlet_pair_corr_graded_colshared,
    tj_singlet_pair_corr_graded_rowshared)
from peps_tpu_torch.fermion.exact import exact_coefficients, snake_order
from peps_tpu_torch.fermion.peps import space_for_model
from peps_tpu_torch.fermion.sweep import (mc_sweep_fermion_oracle,
                                          mc_sweep_fermion_shared)
from peps_tpu_torch.fermion.vmc import (GradedFermionModel,
                                        local_energy_and_holes_graded)
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models.fermion import spinless_fermion, tj_model
from peps_tpu_torch.montecarlo.jastrow import JastrowDress
from tests.test_pair_corr import _graded_pair_corr_oracle
from torch_fermion_util import random_graded_tps

DTYPES = {"f64": False, "c128": True}


def _state(seed, ly, lx, space, cplx):
    return torch.as_tensor(random_graded_tps(np.random.default_rng(seed), ly,
                                             lx, space, complex_=cplx))


def _chained(tps, space, occ0, chi, seeds, dress=None, sweeps=2):
    """Chains started at occ0 (one a seed), swept `sweeps` times by the
    env-shared sweep and by the full-recompute oracle on the same
    uniforms; asserts the two agree on every configuration and acceptance
    count. Returns (total acceptances, whether the first sweep moved)."""
    tp = TruncParams(chi, 1, 0.0)
    ly, lx = occ0.shape
    cfg = torch.as_tensor(np.stack([occ0] * seeds)).long()
    gen = torch.Generator().manual_seed(900)
    total, moved = 0, False
    rdt = torch.float64
    for sweep in range(sweeps):
        u = (torch.rand(seeds, ly, lx - 1, generator=gen, dtype=rdt),
             torch.rand(seeds, lx, ly - 1, generator=gen, dtype=rdt))
        c_fast, st_fast = mc_sweep_fermion_shared(tps, space, cfg, chi, tp,
                                                  uniforms=u, dress=dress)
        c_ref, st_ref = mc_sweep_fermion_oracle(tps, space, cfg, chi, tp, u,
                                                dress=dress)
        assert torch.equal(c_fast, c_ref), sweep
        assert torch.equal(st_fast.accepted, st_ref.accepted), sweep
        if sweep == 0:
            moved = bool((c_fast != cfg).any())
        cfg = c_fast
        total += int(st_fast.accepted.sum())
    return total, moved


# ---------------------------------------------------------------- 1. v-kernel


@pytest.mark.parametrize("cplx", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("which", ["spinless", "tj"])
def test_vkernel_random_state(which, cplx):
    """Uniform rows: every horizontal exchange of sweep 1 is an identity,
    so any change there is a vertical acceptance; the chained sweeps then
    mix both passes. Shared against oracle on every sweep."""
    if which == "spinless":
        model, ly, lx, D = spinless_fermion(1.0, 0.5), 3, 3, 3
        occ0 = np.array([[1, 1, 1], [0, 0, 0], [1, 1, 1]])
    else:
        model, ly, lx, D = tj_model(3.0, 1.0), 3, 2, 3
        occ0 = np.array([[1, 1], [2, 2], [0, 0]])
    space = space_for_model(model, D)
    tps = _state(13, ly, lx, space, cplx)
    total, moved = _chained(tps, space, occ0, 9, 3)
    assert total > 3, total
    assert moved, "no vertical acceptance in the first sweep"


# ------------------------------------------------- 2. diagonal (t2) channels


@pytest.mark.parametrize("cplx", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("which", ["spinless_t2", "tj_t2v"])
def test_t2_diag_tables_random_state(which, cplx):
    """E_loc(s) = (H c)[s] / c[s] for every configuration of a sector, the
    graded local energies with diagonal channels (the reference's t2
    fixture amplitudes -2.5 and +2.1) against the snake-ordered ED matrix;
    the complex value for a complex state."""
    if which == "spinless_t2":
        args, ly, lx, D = (1.0, 0.5, 0.0, -2.5), 2, 3, 3
        model = spinless_fermion(*args)
        j_model = j_fermion.spinless_fermion(*args)
        sector = {1: 2, 0: 4}
    else:
        kw, ly, lx, D = {"t2": 2.1, "v": 0.7}, 2, 3, 3
        model, j_model = tj_model(3.0, 1.0, **kw), \
            j_fermion.tj_model(3.0, 1.0, **kw)
        sector = {1: 2, 2: 2, 0: 2}
    space = space_for_model(model, D)
    tps = _state(17, ly, lx, space, cplx)
    gm = GradedFermionModel.from_model(model, space, tps.dtype, "cpu")
    configs = torch.as_tensor(sector_configs(ly, lx, sector)).long()
    e_got = local_energy_and_holes_graded(
        tps, configs, gm, 9, TruncParams(9, 1, 0.0),
        with_holes=False).e_loc.numpy()
    c = exact_coefficients(tps, space.phys_parity, space.bond_parity)
    seq = snake_order(ly, lx)
    perm = [seq.index((y, x)) for y in range(ly) for x in range(lx)]
    vv = np.transpose(np.asarray(c), perm).reshape(-1)
    hv = FO.build_fermion_hamiltonian(j_model, ly, lx,
                                      order="snake").toarray() @ vv
    d = model.phys_dim
    checked = 0
    for cfg, eg in zip(configs.numpy(), e_got):
        i = int(np.ravel_multi_index(cfg.reshape(-1), (d,) * (ly * lx)))
        if abs(vv[i]) < 1e-10 * np.abs(vv).max():
            continue
        want = hv[i] / vv[i]
        assert abs(eg - want) < 1e-7 * max(1.0, abs(want)), (cfg, eg, want)
        checked += 1
    assert checked > len(e_got) // 2


# ------------------------------------------------- 3. Jastrow-dressed sweep


@pytest.mark.parametrize("cplx", list(DTYPES.values()), ids=list(DTYPES))
def test_dressed_sweep_random_state(cplx):
    """The Jastrow-dressed env-shared sweep against its oracle, chained, on
    a random state with a random dense Jastrow matrix."""
    model, ly, lx, D = tj_model(3.0, 1.0), 3, 2, 3
    occ0 = np.array([[1, 2], [0, 0], [2, 1]])
    space = space_for_model(model, D)
    tps = _state(19, ly, lx, space, cplx)
    n = ly * lx
    v = np.random.default_rng(23).normal(size=(n, n)) * 0.5
    v = (v + v.T) / 2
    np.fill_diagonal(v, 0.0)
    nvals = np.array([float(model.n_up[i] + model.n_dn[i])
                      for i in range(model.phys_dim)])
    dress = JastrowDress(torch.as_tensor(v), torch.as_tensor(nvals))
    total, _ = _chained(tps, space, occ0, 9, 3, dress=dress)
    assert total > 3, total


# --------------------------------------------- 4./5. pair-corr walkers

PAIR_CASES = {
    "row": (2, 4, 29, [[[1, 2, 0, 0], [2, 1, 0, 0]],
                       [[0, 0, 2, 1], [1, 2, 0, 0]],
                       [[2, 0, 0, 1], [1, 2, 0, 0]]]),
    # an even particle number: a parity-even state is zero on odd ones
    "col": (4, 2, 31, [[[1, 0], [2, 0], [0, 2], [0, 1]],
                       [[0, 1], [0, 2], [2, 0], [1, 0]],
                       [[1, 2], [2, 1], [0, 2], [0, 1]]]),
}


@pytest.mark.parametrize("cplx", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("frame", ["row", "col"])
def test_paircorr_walker_random_state(frame, cplx):
    """Both env-shared graded pair walkers against the exact-coefficient
    mode-algebra oracle, every entry with |i - k| > 1 (zeros included),
    the three configurations in one batch."""
    ly, lx, seed, cfgs = PAIR_CASES[frame]
    cfgs = np.array(cfgs)
    space = space_for_model(tj_model(3.0, 1.0), 3)
    tps = _state(seed, ly, lx, space, cplx)
    c = np.asarray(exact_coefficients(tps, space.phys_parity,
                                      space.bond_parity))
    snake_pos = np.zeros((ly, lx), int)
    for p, (y, x) in enumerate(snake_order(ly, lx)):
        snake_pos[y, x] = p
    for cfg in cfgs:
        digits = tuple(int(cfg[y, x]) for (y, x) in snake_order(ly, lx))
        assert abs(c[digits]) > 1e-12 * np.abs(c).max(), cfg
    walker = (tj_singlet_pair_corr_graded_rowshared if frame == "row"
              else tj_singlet_pair_corr_graded_colshared)
    tables = walker(tps, torch.as_tensor(cfgs), space, 9,
                    TruncParams(9, 1, 0.0)).numpy()
    nb = (lx if frame == "row" else ly) - 1
    nlines = ly if frame == "row" else lx
    checked = 0
    for cfg, table in zip(cfgs, tables):
        for r, i, k in itertools.product(range(nlines), range(nb),
                                         range(nb)):
            if abs(i - k) <= 1:
                continue
            sites4 = (((r, i), (r, i + 1), (r, k), (r, k + 1))
                      if frame == "row" else
                      ((i, r), (i + 1, r), (k, r), (k + 1, r)))
            want = _graded_pair_corr_oracle(c, cfg, sites4, snake_pos)
            assert abs(table[r, i, k] - want) < 1e-6 * max(1.0, abs(want)), \
                (r, i, k, table[r, i, k], want)
            if abs(want) > 1e-10:
                checked += 1
    assert checked >= 2, "oracle zero everywhere"


# ------------------------------------- 6. masked full-space Suwa-Todo (t-J)


def test_suwa_todo_tj_mask_stationary_random_state():
    """Full-space Suwa-Todo with the t-J (N_up, N_dn) conservation mask on
    a random 2x2 state: no chain leaves the one-up-one-down sector, and
    the visit frequencies of 256 chains over 40 sweeps (after 10 warm-up
    sweeps) match |psi|^2 over the sector within 0.025."""
    from peps_tpu_torch.montecarlo.engine import ChainState, MonteCarloEngine
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    from peps_tpu_torch.tps import exact_amplitude
    ly, lx, d = 2, 2, 3
    tps = torch.as_tensor(np.random.default_rng(37).normal(
        size=(ly, lx, d, 2, 2, 2, 2)) * 0.8)
    tps[0, :, :, 1:] = 0
    tps[:, 0, :, :, 1:] = 0
    tps[ly - 1, :, :, :, :, 1:] = 0
    tps[:, lx - 1, :, :, :, :, 1:] = 0
    n_up, n_dn = np.array([0, 1, 0]), np.array([0, 0, 1])
    m = np.zeros((d * d, d * d), int)
    for a, b, c2, e in itertools.product(range(d), repeat=4):
        if (n_up[a] + n_up[b] == n_up[c2] + n_up[e]
                and n_dn[a] + n_dn[b] == n_dn[c2] + n_dn[e]):
            m[a * d + b, c2 * d + e] = 1
    rule = UpdateRule("suwa_todo",
                      conserve_mask=tuple(map(tuple, m.tolist())))
    sector = [np.array(cc).reshape(ly, lx)
              for cc in itertools.product(range(d), repeat=ly * lx)
              if n_up[list(cc)].sum() == 1 and n_dn[list(cc)].sum() == 1]
    probs = np.array([abs(exact_amplitude(tps.numpy(), cc)) ** 2
                      for cc in sector])
    probs /= probs.sum()
    c0 = torch.as_tensor(np.stack([sector[0]] * 256)).long()
    eng = MonteCarloEngine(tps, 8, TruncParams(8, 1, 0.0), rule,
                           ChainState(c0, torch.Generator().manual_seed(41)))
    eng.warm_up(10)
    counts = np.zeros(len(sector))
    lookup = {tuple(cc.ravel()): i for i, cc in enumerate(sector)}
    for _ in range(40):
        eng.step_sweep()
        for cfg in eng.state.configs.numpy():
            kk = tuple(cfg.ravel())
            assert kk in lookup, f"left the sector: {kk}"
            counts[lookup[kk]] += 1
    assert np.max(np.abs(counts / counts.sum() - probs)) < 0.025
