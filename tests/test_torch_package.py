"""The port as a package: it runs (a train step, then a measurement)
without JAX, ships its kernel sources, and its kernel wrappers never fall
back to the plain versions on a CUDA tensor."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import peps_tpu_torch
from peps_tpu_torch.kernels import centered_o as k2
from peps_tpu_torch.kernels import col_transfer as k1
from peps_tpu_torch.kernels import pair_transfer as k3

REPO = Path(__file__).resolve().parent.parent

NO_JAX_TRAIN_STEP = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
import torch
from peps_tpu_torch.algorithm.mc_evaluator import MCParams
from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.models import spin
from peps_tpu_torch.optimizer.cg import CGParams
from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
from peps_tpu_torch.peps import (SimpleUpdateParams, product_peps,
                                 simple_update, to_tps)

m = spin.heisenberg()
p0 = product_peps(2, 2, 2, np.array([[0, 1], [1, 0]]), 2,
                  dtype=torch.float64, device="cpu")
su = simple_update(p0, m.h_h, m.h_v,
                   SimpleUpdateParams(5, 0.1, TruncParams(2, 1, 1e-10)))
tps = to_tps(su.peps)
params = VMCParams(4, TruncParams(4, 1, 1e-8, scheme="sketch"),
                   MCParams(num_samples=1, num_warmup_sweeps=1, nchains=4),
                   OptimizerParams(1, SRParams(CGParams(10, 1e-6)), lr=0.05),
                   occupancy=((0, 2), (1, 2)))
res = vmc_optimize(tps, m, params, torch.Generator().manual_seed(0))
assert np.isfinite(res.energies[0]), res.energies
from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
from peps_tpu_torch.montecarlo.sweep import UpdateRule
meas = measure(res.state, m, MeasurementParams(num_samples=2,
                                               num_warmup_sweeps=1),
               4, params.trunc, UpdateRule(), res.final_configs)
assert np.isfinite(meas.stats["energy"][0]), meas.stats["energy"]
import peps_tpu_torch.api as api
import peps_tpu_torch.montecarlo.jastrow
import peps_tpu_torch.peps_cluster
nnn = api.simple_update_nnn(p0, spin.j1j2_xxz(1, 1, 0.5, 0.5),
                            SimpleUpdateParams(1, 0.1,
                                               TruncParams(2, 1, 1e-10)))
assert np.isfinite(nnn.estimated_e0)
leaked = sorted(k for k in sys.modules
                if k == "peps_tpu" or k.startswith("peps_tpu.")
                or (k.startswith("jax") and sys.modules[k] is not None))
assert not leaked, leaked
print("OK", res.energies[0])
"""


def test_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", NO_JAX_TRAIN_STEP],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


NO_JAX_FERMIONS = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
import numpy as np
import torch
import peps_tpu_torch.api as api
from peps_tpu_torch.optimizer.cg import CGParams
from peps_tpu_torch.fermion.peps import (FermionSpace, expand_bond_dim_graded,
                                         u1_charges_for)
m = api.fermion.tj_model(3.0, 1.0)
sp = api.space_for_model(m, 2)
occ = np.array([[1, 2, 1], [2, 0, 0]])
p0 = api.product_fermion_peps(2, 3, sp, occ, device="cpu")
su = api.fermion_simple_update(
    p0, m, sp, api.SimpleUpdateParams(3, 0.2, api.TruncParams(2, 1, 1e-12)),
    charges=u1_charges_for(m, sp, occ))
new = FermionSpace(sp.phys_parity, 2, 2)
tps = expand_bond_dim_graded(api.to_tps_fermion(su.peps), sp, new, 1e-3,
                             torch.Generator().manual_seed(0))
gm = api.GradedFermionModel.from_model(m, new, tps.dtype, "cpu")
params = api.VMCParams(4, api.TruncParams(4, 1, 1e-8, scheme="sketch"),
                       api.MCParams(num_samples=1, num_warmup_sweeps=1,
                                    nchains=2),
                       api.OptimizerParams(1, api.SRParams(CGParams(5, 1e-6)),
                                           lr=0.05),
                       occupancy=((0, 2), (1, 2), (2, 2)))
res = api.vmc_optimize(tps, gm, params, torch.Generator().manual_seed(0))
assert np.isfinite(res.energies[0]), res.energies
hub = api.fermion.hubbard(1.0, 4.0)
jw = api.vmc_optimize(api.random_tps(torch.Generator().manual_seed(1), 2, 2,
                                     4, 2, torch.float64, device="cpu"),
                      hub, api.VMCParams(
                          4, params.trunc, params.mc, params.optimizer,
                          api.UpdateRule("suwa_todo",
                                         api.fermion.hubbard_conserve_mask()),
                          occupancy=((1, 2), (2, 2))),
                      torch.Generator().manual_seed(0))
assert np.isfinite(jw.energies[0]), jw.energies
from peps_tpu_torch.algorithm.measure_fermion import (
    graded_env_shared, tj_singlet_pair_corr_graded_colshared,
    tj_singlet_pair_corr_graded_rowshared)
cfg = res.final_configs
shared = graded_env_shared(res.state, cfg, new, 4, params.trunc)
row = tj_singlet_pair_corr_graded_rowshared(res.state, cfg, new, 4,
                                            params.trunc, shared)
col = tj_singlet_pair_corr_graded_colshared(res.state, cfg, new, 4,
                                            params.trunc, shared)
assert row.shape == (2, 2, 2, 2) and col.shape == (2, 3, 1, 1)
assert bool(torch.isfinite(row).all() and torch.isfinite(col).all())
meas = api.measure(res.state, gm, api.MeasurementParams(
    num_samples=2, num_warmup_sweeps=1, measure_pair_corr=True), 4,
    params.trunc, api.UpdateRule(), cfg)
assert np.isfinite(meas.stats["energy"][0]), meas.stats["energy"]
assert "pair_corr_row" in meas.stats and "pair_corr_col" in meas.stats
leaked = sorted(k for k in sys.modules
                if k == "peps_tpu" or k.startswith("peps_tpu.")
                or (k.startswith("jax") and sys.modules[k] is not None))
assert not leaked, leaked
print("OK", res.energies[0], jw.energies[0])
"""


def test_fermions_run_without_jax():
    """The fermion slice through the user entry points without JAX: graded
    SU with U(1) charges, to_tps_fermion, expand_bond_dim_graded, SR on a
    GradedFermionModel, a JW Hubbard SR step with Suwa-Todo, then both
    graded pair walkers on one GradedEnvShared and a graded measure()
    with the pair correlators."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", NO_JAX_FERMIONS],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_package_imports_no_jax_module():
    for path in (REPO / "peps_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from peps_tpu." not in text and "import peps_tpu\n" not in text, path


def test_kernel_sources_ship_in_csrc():
    for name, symbols in (("col_transfer.cu", ("col_transfer_f32",
                                               "col_transfer_f64")),
                          ("centered_o.cu", ("centered_o_f32",
                                             "centered_o_f64")),
                          ("pair_transfer.cu", ("pair_transfer_f32",
                                                "pair_transfer_f64",
                                                "pair_transfer_attributes"))):
        text = (REPO / "peps_tpu_torch" / "csrc" / name).read_text()
        assert 'extern "C"' in text and all(s in text for s in symbols)
    k2_text = (REPO / "peps_tpu_torch" / "kernels" / "centered_o.py") \
        .read_text()
    assert "triton" not in k2_text.lower()


def test_tf32_is_off():
    assert peps_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrappers down
    their launch path on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(*shape, dtype=torch.float32):
    return torch.Tensor._make_subclass(_CudaLike, torch.zeros(*shape,
                                                              dtype=dtype))


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached the plain version")


def test_col_transfer_launches_or_raises_on_cuda(monkeypatch):
    monkeypatch.setattr(k1, "col_transfer_plain", _no_plain)
    env = _cuda_like(4, 2, 4)
    top = _cuda_like(4, 2, 4)
    site = _cuda_like(2, 2, 2, 2)
    before = k1.col_transfer.launches
    with pytest.raises((RuntimeError, OSError)):
        k1.col_transfer(env, top, site, _cuda_like(4, 2, 4))
    assert k1.col_transfer.launches == before
    # complex goes down the launch path too (its own entry); integers and
    # bfloat16 are refused before it
    for dtype, err in ((torch.complex64, (RuntimeError, OSError)),
                       (torch.int32, TypeError), (torch.bfloat16, TypeError)):
        with pytest.raises(err):
            k1.col_transfer(_cuda_like(4, 2, 4, dtype=dtype),
                            _cuda_like(4, 2, 4, dtype=dtype),
                            _cuda_like(2, 2, 2, 2, dtype=dtype),
                            _cuda_like(4, 2, 4, dtype=dtype))
    assert k1.col_transfer.launches == before


def test_centered_o_launches_or_raises_on_cuda(monkeypatch):
    monkeypatch.setattr(k2, "centered_o_plain", _no_plain)
    before = k2.centered_o.launches
    holes = _cuda_like(3, 4, 16)
    psi = _cuda_like(3, 4)
    cfg = _cuda_like(3, 4, dtype=torch.int64)
    with pytest.raises((RuntimeError, OSError)):
        k2.centered_o(holes, psi, cfg, 2)
    assert k2.centered_o.launches == before


def test_pair_transfer_launches_or_raises_on_cuda(monkeypatch):
    monkeypatch.setattr(k3, "pair_transfer_plain", _no_plain)
    env = _cuda_like(4, 2, 2, 4)
    top = _cuda_like(4, 2, 4)
    row = _cuda_like(2, 2, 2, 2)
    before = k3.pair_transfer.launches
    with pytest.raises((RuntimeError, OSError)):
        k3.pair_transfer(env, top, row, row, top)
    assert k3.pair_transfer.launches == before
    for c, err in ((torch.complex128, (RuntimeError, OSError)),
                   (torch.int32, TypeError), (torch.bfloat16, TypeError)):
        with pytest.raises(err):
            k3.pair_transfer(_cuda_like(4, 2, 2, 4, dtype=c),
                             _cuda_like(4, 2, 4, dtype=c),
                             _cuda_like(2, 2, 2, 2, dtype=c),
                             _cuda_like(2, 2, 2, 2, dtype=c),
                             _cuda_like(4, 2, 4, dtype=c))
    assert k3.pair_transfer.launches == before


def test_plain_versions_on_cpu_count_no_launch():
    before = (k1.col_transfer.launches, k2.centered_o.launches,
              k3.pair_transfer.launches)
    x = torch.ones(3, 2, 3, dtype=torch.float64)
    site = torch.ones(2, 2, 2, 2, dtype=torch.float64)
    k1.col_transfer(x, x, site, x)
    k2.centered_o(torch.ones(2, 1, 4, dtype=torch.float64),
                  torch.ones(2, 1, dtype=torch.float64),
                  torch.zeros(2, 1, dtype=torch.int64), 2)
    k3.pair_transfer(torch.ones(3, 2, 2, 3, dtype=torch.float64), x, site,
                     site, x)
    assert (k1.col_transfer.launches, k2.centered_o.launches,
            k3.pair_transfer.launches) == before


def test_bmps_overlap_ships_and_launches_or_raises_on_cuda(monkeypatch):
    """K5's source ships in csrc with its four C entries; a CUDA tensor
    goes down the launch path (raising here, without CUDA), never to the
    plain version, and an unknown dtype is refused; on the CPU the plain
    version runs and counts no launch."""
    from peps_tpu_torch.kernels import bmps_overlap as k5
    text = (REPO / "peps_tpu_torch" / "csrc" / "bmps_overlap.cu").read_text()
    assert 'extern "C"' in text and all(
        f"bmps_overlap_{s}" in text for s in ("f32", "f64", "c64", "c128"))
    before = k5.bmps_overlap.launches
    x = torch.ones(3, 2, 4, 2, 4, dtype=torch.float64)
    k5.bmps_overlap(x, x)
    monkeypatch.setattr(k5, "bmps_overlap_plain", _no_plain)
    with pytest.raises((RuntimeError, OSError)):
        k5.bmps_overlap(_cuda_like(3, 2, 4, 2, 4), _cuda_like(2, 4, 2, 4))
    with pytest.raises(TypeError):
        k5.bmps_overlap(_cuda_like(2, 4, 2, 4, dtype=torch.int32),
                        _cuda_like(2, 4, 2, 4, dtype=torch.int32))
    assert k5.bmps_overlap.launches == before


def test_fermion_dress_ships_and_launches_or_raises_on_cuda(monkeypatch):
    """K4's source ships in csrc with its four C entries; a CUDA tensor
    goes down the launch path (raising here, without CUDA), never to the
    plain version, and an unknown dtype is refused."""
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    text = (REPO / "peps_tpu_torch" / "csrc" / "fermion_dress.cu").read_text()
    assert 'extern "C"' in text and all(
        f"fermion_dress_{s}" in text for s in ("f32", "f64", "c64", "c128"))
    monkeypatch.setattr(k4, "fermion_dress_plain", _no_plain)
    tab = dress_tables(FermionSpace((0, 1, 1), 1, 1), 2, 2)
    cfg = _cuda_like(1, 2, 2, dtype=torch.int64)
    before = k4.fermion_dress.launches
    with pytest.raises((RuntimeError, OSError)):
        k4.fermion_dress(_cuda_like(2, 2, 3, 2, 2, 2, 2), cfg, tab)
    with pytest.raises(TypeError):
        k4.fermion_dress(_cuda_like(2, 2, 3, 2, 2, 2, 2, dtype=torch.int32),
                         cfg, tab)
    assert k4.fermion_dress.launches == before
