"""K2's launch plan (kernels/centered_o.py:centered_o_plan) and its wrapper's
checks, on the CPU: the grid covers every (site, column) and every row
exactly once, the CTA fits the H100's shared memory and registers with two
CTAs an SM, and a buffer past 2^31 elements is planned, not refused."""
import numpy as np
import pytest
import torch

from peps_tpu_torch.kernels import centered_o as k2

SMEM_PER_BLOCK = 232448          # 227 KB a CTA may use
SMEM_PER_SM = 233472             # 228 KB an SM holds
REG_FILE_BYTES = 65536 * 4       # 64 K 32-bit registers an SM

SHAPES = {
    "main_path_8x8_D8": (32, 64, 8 ** 4, 2),
    "stretch_12x12_D10": (256, 144, 10 ** 4, 2),
    "big_16x16_D12": (256, 256, 12 ** 4, 2),
    "ragged_k81": (37, 5, 81, 3),
    "k_not_multiple_of_4": (5, 3, 30, 2),
    "ns_past_one_row_block": (600, 3, 40, 2),
    "one_sample": (1, 2, 4, 4),
}


def _covered_columns(plan, k):
    """The columns of K each chunk's lanes touch, as the kernel forms them
    (k0 = chunk * cols_per_cta + lane * vec, values k0 .. k0 + vec - 1,
    masked at K)."""
    chunk = np.arange(plan["col_chunks"])[:, None, None]
    lane = np.arange(k2.LANES_PER_ROW)[None, :, None]
    j = np.arange(plan["vec"])[None, None, :]
    cols = (chunk * plan["cols_per_cta"] + lane * plan["vec"] + j).ravel()
    return cols[cols < k]


def _covered_rows(plan, ns):
    """The rows the kernel's threads take over all row blocks and passes
    (row = block * block_rows + i * 32 + row_lane, masked at Ns)."""
    b = np.arange(plan["row_blocks"])[:, None, None]
    i = np.arange(plan["rows_per_thread"])[None, :, None]
    lane = np.arange(k2.ROWS_PER_PASS)[None, None, :]
    rows = (b * plan["block_rows"] + i * k2.ROWS_PER_PASS + lane).ravel()
    return rows[rows < ns]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_covers_every_column_and_row_once(name, dtype):
    ns, s, k, d = SHAPES[name]
    plan = k2.centered_o_plan(ns, s, k, d, dtype)
    item = torch.finfo(dtype).bits // 8
    assert plan["vec"] * item == 16
    assert plan["cols_per_cta"] == k2.LANES_PER_ROW * plan["vec"]
    assert plan["cols_per_cta"] * item == 128       # one line of a row
    assert plan["ctas"] == s * plan["col_chunks"] < 2 ** 31
    cols = _covered_columns(plan, k)
    assert np.array_equal(np.sort(cols), np.arange(k))
    rows = _covered_rows(plan, ns)
    assert np.array_equal(np.sort(rows), np.arange(ns))
    assert plan["dp"] >= d and plan["dp"] in (2, 4)
    assert plan["out_elements"] == ns * s * d * k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_fits_two_ctas_an_sm(name, dtype):
    ns, s, k, d = SHAPES[name]
    plan = k2.centered_o_plan(ns, s, k, d, dtype)
    n = plan["ctas_per_sm"]
    assert n >= 2
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert n * plan["smem_bytes"] <= SMEM_PER_SM
    assert n * plan["tile_bytes"] <= REG_FILE_BYTES // 2
    assert plan["threads"] * plan["rows_per_thread"] * 16 \
        == plan["tile_bytes"]


def test_plan_row_blocks():
    f32 = torch.float32
    main = k2.centered_o_plan(32, 64, 4096, 2, f32)
    assert (main["rows_per_thread"], main["ctas"]) == (1, 64 * 128)
    assert k2.centered_o_plan(33, 1, 8, 2, f32)["rows_per_thread"] == 2
    stretch = k2.centered_o_plan(256, 144, 10000, 2, f32)
    assert (stretch["rows_per_thread"], stretch["row_blocks"]) == (8, 1)
    assert stretch["col_chunks"] == 313            # the last chunk is half
    many = k2.centered_o_plan(600, 3, 40, 2, f32)
    assert (many["block_rows"], many["row_blocks"]) == (256, 3)


def test_big_buffer_plans_64_bit_offsets():
    plan = k2.centered_o_plan(256, 256, 12 ** 4, 2, torch.float32)
    assert plan["out_elements"] == 256 * 256 * 2 * 12 ** 4 > 2 ** 31
    assert plan["offset_bits"] == 64
    assert plan["ctas"] == 256 * 648


def test_plan_refuses_what_the_kernel_does_not_take():
    for dtype in (torch.int32, torch.bfloat16):     # complex is taken
        with pytest.raises(TypeError, match="centered_o takes"):
            k2.centered_o_plan(4, 2, 8, 2, dtype)
    with pytest.raises(ValueError, match="d <= 4"):
        k2.centered_o_plan(4, 2, 8, 5, torch.float32)
    with pytest.raises(ValueError, match="empty"):
        k2.centered_o_plan(0, 2, 8, 2, torch.float32)


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper down its
    launch path on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(t):
    return torch.Tensor._make_subclass(_CudaLike, t)


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached the plain version")


def _operands(ns, s, k, dtype=torch.float32, cfg_dtype=torch.int64):
    # expanded views: a buffer of any size costs no memory
    return (_cuda_like(torch.zeros(1, 1, 1, dtype=dtype).expand(ns, s, k)),
            _cuda_like(torch.ones(1, 1, dtype=dtype).expand(ns, s)),
            _cuda_like(torch.zeros(1, 1, dtype=cfg_dtype).expand(ns, s)))


@pytest.mark.parametrize("case", ["psi_shape", "cfg_shape", "holes_rank",
                                  "psi_dtype", "cfg_dtype", "complex",
                                  "d_too_large"])
def test_wrapper_refuses_bad_operands_before_launch(monkeypatch, case):
    monkeypatch.setattr(k2, "centered_o_plain", _no_plain)
    holes, psi, cfg = _operands(3, 4, 16)
    d, err = 2, ValueError
    if case == "psi_shape":
        psi = _cuda_like(torch.ones(3, 5))
    elif case == "cfg_shape":
        cfg = _cuda_like(torch.zeros(4, 4, dtype=torch.int64))
    elif case == "holes_rank":
        holes = _cuda_like(torch.zeros(3, 4, 4, 4))
    elif case == "psi_dtype":
        psi, err = _cuda_like(torch.ones(3, 4, dtype=torch.float64)), TypeError
    elif case == "cfg_dtype":       # any integer dtype is taken, not floats
        cfg, err = _cuda_like(torch.zeros(3, 4, dtype=torch.float32)), TypeError
    elif case == "complex":     # complex holes with a real psi
        holes, _, cfg = _operands(3, 4, 16, dtype=torch.complex64)
        err = TypeError
    else:
        d = 5
    before = k2.centered_o.launches
    with pytest.raises(err):
        k2.centered_o(holes, psi, cfg, d)
    assert k2.centered_o.launches == before


def test_wrapper_takes_a_buffer_past_2_31_elements(monkeypatch):
    """16x16, D=12, Ns=256: 2.7e9 elements. The wrapper plans it and goes
    on to build the kernel (which fails here, without nvcc) instead of
    refusing the size."""
    monkeypatch.setattr(k2, "centered_o_plain", _no_plain)
    holes, psi, cfg = _operands(256, 256, 12 ** 4)
    before = k2.centered_o.launches
    with pytest.raises((RuntimeError, OSError)) as info:
        k2.centered_o(holes, psi, cfg, 2)
    assert not isinstance(info.value, ValueError)
    assert k2.centered_o.launches == before
