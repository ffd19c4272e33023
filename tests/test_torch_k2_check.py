"""chip_smoke.py's K2 check, on the CPU: with the operands it draws
(``k2_operands``), a limit of 1e-5 (f32) or 1e-12 (f64) of max |plain|
passes the plain version (computed once more, in another order) and fails
outputs that are wrong by little: the centering dropped, each mean off by
1%, or one sample's 1/psi off by 0.1%."""
import importlib.util
from pathlib import Path

import pytest
import torch

from peps_tpu_torch.kernels import centered_o as k2

REPO = Path(__file__).resolve().parent.parent
NS, SITES, K = 32, 8, 4096          # the main path's Ns and K, fewer sites


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _chip_smoke()


def _operands(smoke, dtype):
    gen = torch.Generator().manual_seed(17)
    return smoke.k2_operands(NS, SITES, K, dtype, "cpu", gen)


def _uncentered(holes, psi, cfg, d):
    safe = torch.where(psi == 0, torch.ones_like(psi), psi)
    sel = torch.nn.functional.one_hot(cfg, d).to(holes.dtype)
    return ((holes / safe[..., None])[:, :, None, :]
            * sel[..., None]).reshape(holes.shape[0], -1)


def test_operands_keep_max_plain_near_a_typical_output(smoke):
    holes, psi, cfg = _operands(smoke, torch.float64)
    assert bool((psi[0] == 0).all())
    assert float(psi[1:].abs().min()) >= 0.5
    ref = k2.centered_o_plain(holes, psi, cfg, smoke.PHYS)
    selected = _uncentered(holes, psi, cfg, smoke.PHYS) != 0
    typical = ref[selected].abs().median()
    assert float(ref.abs().max() / typical) < 40


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_against_itself_passes(smoke, dtype):
    holes, psi, cfg = _operands(smoke, dtype)
    ref = k2.centered_o_plain(holes, psi, cfg, smoke.PHYS)
    o = _uncentered(holes, psi, cfg, smoke.PHYS)
    again = (o - o.sum(0) / NS) * (1.0 / NS ** 0.5)
    assert smoke.max_err(again, ref)[1] <= smoke.TOL[str(dtype)[6:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fault", ["mean_dropped", "mean_off_1pct",
                                   "one_row_psi_off_0.1pct"])
def test_a_wrong_output_fails(smoke, dtype, fault):
    holes, psi, cfg = _operands(smoke, dtype)
    ref = k2.centered_o_plain(holes, psi, cfg, smoke.PHYS)
    o = _uncentered(holes, psi, cfg, smoke.PHYS)
    mean = o.mean(0)
    if fault == "mean_dropped":
        wrong = o / NS ** 0.5
    elif fault == "mean_off_1pct":
        wrong = (o - 1.01 * mean) / NS ** 0.5
    else:
        o[1] *= 1.001
        wrong = (o - mean) / NS ** 0.5
    assert smoke.max_err(wrong, ref)[1] > smoke.TOL[str(dtype)[6:]]
