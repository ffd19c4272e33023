"""The port's entry points put their tensors on the current CUDA device
unless the caller asks for another: without a CUDA device, device=None
raises (no quiet CPU fallback) and device="cpu" runs on the CPU.

torch.cuda.is_available is patched to False, so the tests say the same on a
machine with a card."""
import numpy as np
import pytest
import torch

from peps_tpu_torch import convert, peps, tps
from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.models import spin
from peps_tpu_torch.montecarlo import engine


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def saved_tps(tmp_path):
    a = np.arange(2 * 2 * 2 * 16, dtype=np.float64).reshape(2, 2, 2, 2, 2, 2, 2)
    tps.save_tps(str(tmp_path / "s"), torch.as_tensor(a), tps.TPSMeta(2, 2, 2, 2))
    return str(tmp_path / "s")


def _entry_points(saved):
    """name -> call(**device_kwarg) for every entry point with device=None."""
    occ = np.array([[0, 1], [1, 0]])
    a = np.zeros((2, 2, 2, 1, 1, 1, 1))
    g = torch.Generator().manual_seed(0)
    return {
        "product_peps": lambda **kw: peps.product_peps(2, 2, 2, occ, 2, **kw),
        "ModelTensors.from_model": lambda **kw: ModelTensors.from_model(
            spin.heisenberg(), torch.float64, **kw),
        "tps_from_numpy": lambda **kw: convert.tps_from_numpy(a, **kw),
        "peps_from_numpy": lambda **kw: convert.peps_from_numpy(
            a, np.ones((3, 2, 1)), np.ones((2, 3, 1)), **kw),
        "model_tensors_from_numpy": lambda **kw:
            convert.model_tensors_from_numpy(spin.heisenberg(), **kw),
        "load_tps": lambda **kw: tps.load_tps(saved, **kw),
        "init_configs_occupancy": lambda **kw: engine.init_configs_occupancy(
            g, 3, 2, 2, {0: 2, 1: 2}, **kw),
        "init_configs_uniform": lambda **kw: engine.init_configs_uniform(
            g, 3, 2, 2, 2, **kw),
        "init_boundary": lambda **kw: bmps.init_boundary(
            2, 4, 2, torch.float64, **kw),
    }


NAMES = ["product_peps", "ModelTensors.from_model", "tps_from_numpy",
         "peps_from_numpy", "model_tensors_from_numpy", "load_tps",
         "init_configs_occupancy", "init_configs_uniform", "init_boundary"]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


@pytest.mark.parametrize("name", NAMES)
def test_default_device_needs_cuda(no_cuda, saved_tps, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points(saved_tps)[name]()


@pytest.mark.parametrize("name", NAMES)
def test_explicit_cpu_runs_on_the_cpu(no_cuda, saved_tps, name):
    out = _tensors(_entry_points(saved_tps)[name](device="cpu"))
    assert out and all(t.device.type == "cpu" for t in out)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)


def _tiny_measure(tps, **kw):
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.montecarlo.sweep import UpdateRule
    cfg = torch.tensor([[[0, 1], [1, 0]], [[1, 0], [0, 1]]])
    return measure(tps, spin.heisenberg(), MeasurementParams(
        num_samples=2, num_warmup_sweeps=1, nchains=2), 2,
        TruncParams(2, 1, 1e-10, scheme="sketch"), UpdateRule(), cfg, **kw)


def test_measure_runs_on_the_cpu_for_a_cpu_tps(no_cuda):
    rng = np.random.default_rng(0)
    from peps_tpu_torch.lattice import boundary_mask
    tps = torch.as_tensor(rng.standard_normal((2, 2, 2, 2, 2, 2, 2))
                          * boundary_mask(2, 2, 2, 2))
    res = _tiny_measure(tps)
    assert np.isfinite(res.stats["energy"][0])
    assert set(res.stats) == {"energy", "sz", "szsz", "spsm_row", "spsm_col"}
    assert res.psi_samples.shape == (2, 2)


@pytest.mark.parametrize("entry", ["vmc_optimize", "measure"])
def test_complex_tps_runs_through_the_entry(entry):
    """A complex TPS is taken at the entry (no dtype refusal: the kernels
    take complex64 and complex128 on the card) and runs to finite
    energies; the entry check of earlier slices is gone."""
    from peps_tpu_torch import device
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.lattice import boundary_mask
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SGDParams
    assert not hasattr(device, "require_real_on_card")
    rng = np.random.default_rng(1)
    shape = (2, 2, 2, 2, 2, 2, 2)
    tps = torch.as_tensor((rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape))
                          * boundary_mask(2, 2, 2, 2))
    if entry == "measure":
        res = _tiny_measure(tps)
        assert np.isfinite(res.stats["energy"][0])
    else:
        res = vmc_optimize(tps, spin.heisenberg(), VMCParams(
            2, TruncParams(2, 1, 1e-10, scheme="sketch"),
            MCParams(num_samples=2, num_warmup_sweeps=1, nchains=2),
            OptimizerParams(1, SGDParams()), occupancy=((0, 2), (1, 2))),
            torch.Generator().manual_seed(0))
        assert res.state.dtype == torch.complex128
        assert np.isfinite(res.energies).all()
