"""The port's hand-written kernels against their plain PyTorch versions on
the card. Skipped without a CUDA device. On the GPU machine, which has no
JAX, run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: 1e-12 (float64) and 1e-5 (float32) of max |kernel - plain|
over max |plain|; the kernel sums in its own order.
"""
import pytest
import torch

from peps_tpu_torch.kernels import centered_o as k2
from peps_tpu_torch.kernels import col_transfer as k1

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _r(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chi,D,c", [(5, 2, 7), (4, 3, 4), (32, 8, 40),
                                     (64, 8, 64)])
def test_col_transfer_left_and_right(dev, dtype, chi, D, c):
    gen = torch.Generator(device=dev).manual_seed(chi + c)
    env = _r(gen, dev, dtype, 3, chi, D, c)
    top = _r(gen, dev, dtype, 3, chi, D, chi)
    site = _r(gen, dev, dtype, D, D, D, D)          # shared: batch stride 0
    bot = _r(gen, dev, dtype, c, D, c)              # shared
    before = k1.col_transfer.launches
    out = k1.col_transfer(env, top, site, bot)
    assert k1.col_transfer.launches == before + 1
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) <= TOL[dtype]
    renv = _r(gen, dev, dtype, 3, chi, D, c)
    out = k1.col_transfer_right(renv, top, site, bot)
    ref = k1.col_transfer_right(renv, top, site, bot,
                                transfer=k1.col_transfer_plain)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_col_transfer_four_broadcast_batch_dims(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    full = _r(gen, dev, dtype, 2, 3, 5, 6, 4, 3, 4)
    env = full[:, :, 1:, :1]                       # strided slice, size-1 dim
    top = _r(gen, dev, dtype, 2, 3, 4, 1, 4, 3, 4)
    site = _r(gen, dev, dtype, 3, 4, 2, 3, 3, 3, 3)
    bot = _r(gen, dev, dtype, 2, 1, 1, 1, 4, 3, 4)
    out = k1.col_transfer(env, top, site, bot)
    assert out.shape == (2, 3, 4, 2, 4, 3, 4)
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["left", "right"])
@pytest.mark.parametrize("nc", [32, 40])
def test_col_transfer_main_path_shapes(dev, dtype, form, nc):
    """chi = 32, D = 8, 32 chains: the right form's transposed views, a
    shared site, and a permuted bot as the sketch's y_mid[x-1].permute(1,0,2)
    (c = 40) or the transposed z block (c = 32) gives it."""
    chi, D = 32, 8
    gen = torch.Generator(device=dev).manual_seed(nc)
    env = _r(gen, dev, dtype, 32, chi, D, nc)
    top = _r(gen, dev, dtype, 32, chi, D, chi)
    site = _r(gen, dev, dtype, D, D, D, D)
    if nc == 40:
        bot = _r(gen, dev, dtype, D, nc, nc).permute(1, 0, 2)
    else:
        bot = _r(gen, dev, dtype, D * chi, chi).reshape(D, chi, chi) \
            .permute(2, 0, 1)
    if form == "left":
        out = k1.col_transfer(env, top, site, bot)
        ref = k1.col_transfer_plain(env, top, site, bot)
    else:
        out = k1.col_transfer_right(env, top, site, bot)
        ref = k1.col_transfer_right(env, top, site, bot,
                                    transfer=k1.col_transfer_plain)
    assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["one", "below", "at", "above"])
def test_col_transfer_both_sides_of_the_cta_split(dev, dtype, where):
    """Batches of 1 item, one item below the plan's threshold (one CTA per
    A tile), at it and 37 above it (one CTA per item), chi = 32, D = 8."""
    def ops(items):
        gen = torch.Generator(device=dev).manual_seed(items)
        env = _r(gen, dev, dtype, items, 32, 8, 32)
        top = _r(gen, dev, dtype, items, 32, 8, 32)
        site = _r(gen, dev, dtype, 2, 8, 8, 8, 8)[items % 2]
        return env, top, site, _r(gen, dev, dtype, items, 32, 8, 32)
    thr = k1.col_transfer_plan(*ops(1))["item_threshold"]
    items = {"one": 1, "below": thr - 1, "at": thr, "above": thr + 37}[where]
    env, top, site, bot = ops(items)
    plan = k1.col_transfer_plan(env, top, site, bot)
    assert plan["mode"] == ("a_tile" if items < thr else "item")
    out = k1.col_transfer(env, top, site, bot)
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) <= TOL[dtype]


def test_col_transfer_counts_one_launch_per_call(dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    env, top, bot = (_r(gen, dev, torch.float32, 4, 6, 3, 6) for _ in range(3))
    site = _r(gen, dev, torch.float32, 3, 3, 3, 3)
    before = k1.col_transfer.launches
    for _ in range(3):
        k1.col_transfer(env, top, site, bot)
    k1.col_transfer_right(env, top, site, bot)
    assert k1.col_transfer.launches == before + 4
    k1.col_transfer_plain(env, top, site, bot)
    k1.col_transfer_plan(env, top, site, bot)
    assert k1.col_transfer.launches == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,sites,k,d", [(37, 5, 81, 3), (32, 64, 4096, 2)])
def test_centered_o(dev, dtype, ns, sites, k, d):
    gen = torch.Generator(device=dev).manual_seed(ns)
    holes = _r(gen, dev, dtype, ns, sites, k)
    psi = _r(gen, dev, dtype, ns, sites)
    psi[0, 0] = 0.0
    cfg = torch.randint(0, d, (ns, sites), generator=gen, device=dev)
    before = k2.centered_o.launches
    out = k2.centered_o(holes, psi, cfg, d)
    assert k2.centered_o.launches == before + 1
    assert _rel(out, k2.centered_o_plain(holes, psi, cfg, d)) <= TOL[dtype]


def test_complex_raises_on_cuda(dev):
    x = torch.zeros(2, 2, 2, dtype=torch.complex64, device=dev)
    s = torch.zeros(2, 2, 2, 2, dtype=torch.complex64, device=dev)
    with pytest.raises(TypeError):
        k1.col_transfer(x, x, s, x)
