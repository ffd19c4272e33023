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
from peps_tpu_torch.kernels import pair_transfer as k3

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


def _psi(gen, dev, dtype, ns, sites):
    """|psi| in [0.5, 1.5): a psi near 0 would make max |plain| orders of
    magnitude above a typical output and TOL of it a loose check. psi = 0,
    NaN and subnormal psi are planted by the tests that need them."""
    mag = 0.5 + torch.rand(ns, sites, generator=gen, device=dev, dtype=dtype)
    sign = torch.randint(0, 2, (ns, sites), generator=gen, device=dev)
    return torch.where(sign == 1, mag, -mag)


def _k2_operands(dev, dtype, ns, sites, k, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    holes = _r(gen, dev, dtype, ns, sites, k)
    psi = _psi(gen, dev, dtype, ns, sites)
    cfg = torch.randint(0, d, (ns, sites), generator=gen, device=dev)
    return holes, psi, cfg


# K2 tolerances: the kernel multiplies by 1/psi and by 1/sqrt(Ns) where the
# plain version divides, about one ulp each, and sums in its own dtype in
# another order (per-thread partials, shuffles, then shared memory): well
# inside TOL of max |plain|.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ns,sites,k,d", [
    (37, 5, 81, 3),           # K % 4 != 0: scalar accesses, ragged chunk
    (32, 64, 4096, 2),        # the main path, 8x8 D=8, 32 chains
    (600, 3, 40, 2),          # three row blocks, the last one partial
    (300, 5, 81, 4),          # two row blocks, scalar accesses, d = 4
    (256, 144, 10000, 2),     # the stretch run, 12x12 D=10, 256 samples
])
def test_centered_o(dev, dtype, ns, sites, k, d):
    holes, psi, cfg = _k2_operands(dev, dtype, ns, sites, k, d, ns)
    psi[0, 0] = 0.0
    psi[ns - 1] = 0.0                                 # a whole psi = 0 row
    before = k2.centered_o.launches
    out = k2.centered_o(holes, psi, cfg, d)
    assert k2.centered_o.launches == before + 1
    assert _rel(out, k2.centered_o_plain(holes, psi, cfg, d)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_centered_o_misaligned_holes(dev, dtype):
    """A holes view whose first element is not 16-byte aligned takes the
    scalar accesses even though K is a multiple of the vector width."""
    ns, sites, k, d = 40, 3, 64, 2
    gen = torch.Generator(device=dev).manual_seed(7)
    flat = _r(gen, dev, dtype, ns * sites * k + 1)
    holes = flat[1:].view(ns, sites, k)
    assert holes.data_ptr() % 16 != 0
    psi = _psi(gen, dev, dtype, ns, sites)
    cfg = torch.randint(0, d, (ns, sites), generator=gen, device=dev)
    out = k2.centered_o(holes, psi, cfg, d)
    assert _rel(out, k2.centered_o_plain(holes, psi, cfg, d)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_centered_o_nan_psi_matches_plain_nan_pattern(dev, dtype):
    """A NaN psi makes its site's columns NaN in every row (NaN * 0 in the
    one-hot product, then the mean); the finite rest agrees in value."""
    ns, sites, k, d = 48, 4, 64, 2
    holes, psi, cfg = _k2_operands(dev, dtype, ns, sites, k, d, 11)
    psi[5, 2] = float("nan")
    psi[7, 0] = 0.0
    out = k2.centered_o(holes, psi, cfg, d)
    ref = k2.centered_o_plain(holes, psi, cfg, d)
    assert torch.equal(out.isnan(), ref.isnan())
    assert bool(ref.isnan()[:, 2 * d * k:3 * d * k].all())
    fin = ~ref.isnan()
    assert ((out[fin] - ref[fin]).abs().max()
            / ref[fin].abs().max()).item() <= TOL[dtype]


def test_centered_o_subnormal_psi_divides(dev):
    """An f32 psi of 1e-40 (subnormal: its reciprocal overflows) with holes
    of its size: the kernel divides that row, as the plain version does,
    instead of multiplying by inf."""
    ns, sites, k, d = 40, 3, 64, 2
    holes, psi, cfg = _k2_operands(dev, torch.float32, ns, sites, k, d, 5)
    psi[3, 1] = 1e-40
    holes[3, 1] *= 1e-40
    out = k2.centered_o(holes, psi, cfg, d)
    ref = k2.centered_o_plain(holes, psi, cfg, d)
    assert bool(ref.isfinite().all()) and bool(out.isfinite().all())
    assert _rel(out, ref) <= TOL[torch.float32]


def test_centered_o_past_2_31_elements(dev):
    """16x16, D=12, 256 samples, f32: a [256, 10616832] buffer of 2.7e9
    elements. Centering is per column, so the plain version on the first
    and the last site alone gives those sites' columns."""
    ns, sites, k, d = 256, 256, 12 ** 4, 2
    holes, psi, cfg = _k2_operands(dev, torch.float32, ns, sites, k, d, 3)
    assert ns * sites * d * k > 2 ** 31
    before = k2.centered_o.launches
    out = k2.centered_o(holes, psi, cfg, d)
    assert k2.centered_o.launches == before + 1
    assert out.shape == (ns, sites * d * k)
    for site in (0, sites - 1):
        cols = slice(site * d * k, (site + 1) * d * k)
        ref = k2.centered_o_plain(holes[:, site:site + 1],
                                  psi[:, site:site + 1],
                                  cfg[:, site:site + 1], d)
        assert _rel(out[:, cols], ref) <= TOL[torch.float32]


CX_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("chi,D,c", [(5, 2, 7), (32, 8, 32), (32, 8, 40)])
def test_col_transfer_complex_left_and_right(dev, dtype, chi, D, c):
    """The complex body (c64, c128) against the plain version, both forms:
    small sizes with partial chunks and A tiles, and the main path's."""
    gen = torch.Generator(device=dev).manual_seed(chi + c)
    env = _r(gen, dev, dtype, 6, chi, D, c)
    top = _r(gen, dev, dtype, 6, chi, D, chi)
    site = _r(gen, dev, dtype, 6, D, D, D, D)
    bot = _r(gen, dev, dtype, 6, c, D, c)
    before = k1.col_transfer.launches
    out = k1.col_transfer(env, top, site, bot)
    assert k1.col_transfer.launches == before + 1
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) \
        <= CX_TOL[dtype]
    renv = _r(gen, dev, dtype, 6, chi, D, c)
    out = k1.col_transfer_right(renv, top, site, bot)
    ref = k1.col_transfer_right(renv, top, site, bot,
                                transfer=k1.col_transfer_plain)
    assert _rel(out, ref) <= CX_TOL[dtype]


K1_CASES = ("sketch_v_step", "sketch_w_step", "right_btens", "bond_step",
            "row_envs", "right_blocks", "nn_traces", "walker",
            "window3_first", "window3_next")


def _k1_cases(dev, dtype, seed):
    """chip_smoke.py's ten K1 cases (8x8, D=8, chi=32, 32 chains): both
    sides of the item/A-tile split (32 to 192 items, 256 to 3584), both
    forms, stride-0 operands (the shared sites, the Gaussian block, top and
    bot broadcast over the walkers and the 3-site window's candidates)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {c[0]: c[1:] for c in smoke.k1_cases(dtype, dev, gen)}


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", K1_CASES)
def test_col_transfer_complex_main_path_cases(dev, dtype, case):
    """The complex bodies at every main-path shape, in the case's form and
    in the other one (the operands serve both at chi = 32)."""
    form, env, top, site, bot = _k1_cases(dev, dtype, 31)[case]
    for f in (form, "right" if form == "left" else "left"):
        if f == "left":
            out = k1.col_transfer(env, top, site, bot)
            ref = k1.col_transfer_plain(env, top, site, bot)
        else:
            out = k1.col_transfer_right(env, top, site, bot)
            ref = k1.col_transfer_right(env, top, site, bot,
                                        transfer=k1.col_transfer_plain)
        assert _rel(out, ref) <= CX_TOL[dtype], f


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("items", [3, 300])
def test_col_transfer_complex_partial_chunk_and_tile(dev, dtype, items):
    """nA and c not multiples of the plan's A tile and c chunk (a partial
    last tile and chunk), odd D, on both sides of the item/A-tile split
    (3 and 300 items), a stride-0 site and bot, and a strided env view."""
    gen = torch.Generator(device=dev).manual_seed(items)
    chi, D, c = 45, 3, 13
    env = _r(gen, dev, dtype, items, chi, D, c + 2)[..., 1:c + 1]
    top = _r(gen, dev, dtype, items, chi, D, chi)
    site = _r(gen, dev, dtype, D, D, D, D)
    bot = _r(gen, dev, dtype, c, D, c)
    plan = k1.col_transfer_plan(env, top, site, bot)
    assert plan["mode"] == ("item" if items >= plan["item_threshold"]
                            else "a_tile")
    assert chi % plan["ta"] != 0 and c % plan["kc"] != 0
    out = k1.col_transfer(env, top, site, bot)
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) \
        <= CX_TOL[dtype]
    out = k1.col_transfer_right(env, top, site, bot)
    ref = k1.col_transfer_right(env, top, site, bot,
                                transfer=k1.col_transfer_plain)
    assert _rel(out, ref) <= CX_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_col_transfer_complex_compiles_without_spill(dev, dtype):
    """The complex bodies in both modes: registers within the 255 a thread
    has at one CTA an SM, no local memory."""
    gen = torch.Generator(device=dev).manual_seed(2)
    for items in (32, 3584):
        env, top, bot = (_r(gen, dev, dtype, 1, 32, 8, 32).expand(
            items, 32, 8, 32) for _ in range(3))
        site = _r(gen, dev, dtype, 8, 8, 8, 8)
        diag = k1.col_transfer_diagnostic(env, top, site, bot)
        assert diag["spill_bytes"] == 0 and diag["ctas_per_sm"] >= 1


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("ns,sites,k,d", [(37, 5, 81, 3), (32, 64, 4096, 2),
                                          (300, 5, 81, 4)])
def test_centered_o_complex(dev, dtype, ns, sites, k, d):
    """The complex body against the plain version, with a psi = 0 row and
    a psi near 1e-30 (the scaled division keeps it finite in complex64)."""
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    h_re, psi, cfg = _k2_operands(dev, rdt, ns, sites, k, d, ns)
    gen = torch.Generator(device=dev).manual_seed(1)
    holes = torch.complex(h_re, _r(gen, dev, rdt, ns, sites, k))
    psi = psi * torch.exp(1j * _r(gen, dev, rdt, ns, sites))
    psi[ns - 1] = 0.0
    psi[0, 0] = complex(3e-30, -4e-30)
    holes[0, 0] *= 1e-30
    before = k2.centered_o.launches
    out = k2.centered_o(holes, psi, cfg, d)
    assert k2.centered_o.launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert _rel(out, k2.centered_o_plain(holes, psi, cfg, d)) \
        <= CX_TOL[dtype]


@pytest.mark.parametrize("kernel", ["col_transfer", "centered_o",
                                    "pair_transfer"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
def test_kernels_refuse_integer_and_bfloat16(dev, kernel, dtype):
    """Only float32, float64, complex64 and complex128 reach a kernel."""
    x3 = torch.zeros(2, 2, 2, device=dev).to(dtype)
    x4 = torch.zeros(2, 2, 2, 2, device=dev).to(dtype)
    launches = {"col_transfer": k1.col_transfer, "centered_o":
                k2.centered_o, "pair_transfer": k3.pair_transfer}[kernel]
    before = launches.launches
    with pytest.raises(TypeError):
        if kernel == "col_transfer":
            k1.col_transfer(x3, x3, x4, x3)
        elif kernel == "centered_o":
            k2.centered_o(x3, x3[..., 0], torch.zeros(
                2, 2, dtype=torch.int64, device=dev), 2)
        else:
            k3.pair_transfer(x4, x3, x4, x4, x3)
    assert launches.launches == before


def walker_operands(dev, dtype, gen, nc=32, ly=8, lx=8, chi=32, D=8):
    """K1 operands of the S+S- walker (algorithm/measure.py) at the main
    path's 8x8, D=8, chi=32, 32 chains: the start transfer (env: the left
    envs of columns < Lx, a slice of [nc, Ly, Lx+1, ...]) and a column step
    (walkers [nc, Ly, Lx(x1), ...]; top, bot and site broadcast over x1 as
    slices of the env stacks and of the candidates)."""
    def r(*shape):
        return _r(gen, dev, dtype, *shape)
    env = (chi, D, chi)
    lefts = r(nc, ly, lx + 1, *env)
    tops, bots = r(nc, ly + 1, lx, *env), r(nc, ly + 1, lx, *env)
    sites = r(nc, ly, lx, D, D, D, D)
    top, bot = tops[:, :ly], bots[:, 1:]
    x = lx // 2
    return {"start": (lefts[:, :, :lx], top, sites, bot),
            "step": (r(nc, ly, lx, *env), top[:, :, x, None],
                     sites[:, :, x, None], bot[:, :, x, None])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("call", ["start", "step"])
def test_col_transfer_walker_shapes(dev, dtype, call):
    gen = torch.Generator(device=dev).manual_seed(21)
    env, top, site, bot = walker_operands(dev, dtype, gen)[call]
    before = k1.col_transfer.launches
    out = k1.col_transfer(env, top, site, bot)
    assert k1.col_transfer.launches == before + 1
    assert out.shape == (32, 8, 8, 32, 8, 32)
    assert _rel(out, k1.col_transfer_plain(env, top, site, bot)) <= TOL[dtype]


def test_centered_o_int32_configurations_equal_int64(dev):
    for dtype in (torch.float32, torch.float64):
        holes, psi, cfg = _k2_operands(dev, dtype, 32, 64, 4096, 2, 9)
        a = k2.centered_o(holes, psi, cfg, 2)
        b = k2.centered_o(holes, psi, cfg.to(torch.int32), 2)
        assert cfg.dtype == torch.int64 and torch.equal(a, b)
    with pytest.raises(TypeError, match="integers"):
        k2.centered_o(holes, psi, cfg.to(dtype), 2)


def _measure_setup(device, ly=3, lx=3, D=3, chi=9, nc=4):
    import numpy as np
    from peps_tpu_torch.lattice import boundary_mask
    rng = np.random.default_rng(3)
    tps = torch.as_tensor(rng.standard_normal((ly, lx, 2) + (D,) * 4)
                          * boundary_mask(ly, lx, 2, D), device=device)
    base = np.array([0, 1] * (ly * lx // 2) + [0] * (ly * lx % 2))
    cfg = torch.as_tensor(np.stack([rng.permutation(base).reshape(ly, lx)
                                    for _ in range(nc)]), device=device)
    return tps, cfg


def test_measure_on_the_card_matches_the_cpu(dev):
    """3x3, D=3, chi=9, f64, the same uniforms: the card's K1 sums in
    another order than the CPU's einsums, so statistics agree to round-off
    (1e-8 relative) and the Metropolis decisions, hence accept rate and
    configurations, exactly."""
    import numpy as np
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
    gen = torch.Generator().manual_seed(5)
    uni = [draw_uniforms(gen, 4, 3, 3, torch.float64, "cpu")
           for _ in range(2 + 4)]
    params = MeasurementParams(num_samples=4, num_warmup_sweeps=2, nchains=4,
                               chunk_size=3)
    res = {}
    for where in ("cpu", dev):
        tps, cfg = _measure_setup(where)
        it = iter([tuple(u.to(where) for u in pair) for pair in uni])
        before = k1.col_transfer.launches
        res[str(where)] = measure(
            tps, spin.heisenberg(), params, 9,
            TruncParams(9, 1, 1e-12, scheme="sketch"), UpdateRule(), cfg,
            sweep_uniforms=lambda: next(it))
        if where == dev:
            assert k1.col_transfer.launches > before
    a, b = res["cpu"], res[str(dev)]
    assert a.accept_rate == b.accept_rate
    for key, (m, e) in a.stats.items():
        mb, eb = b.stats[key]
        assert np.allclose(mb, m, rtol=1e-8, atol=1e-12), key
        assert np.allclose(eb, e, rtol=1e-8, atol=1e-12), key


@pytest.mark.parametrize("entry", ["vmc_optimize", "measure"])
def test_complex_tps_on_the_card_matches_the_cpu(dev, entry):
    """A complex128 TPS runs through the entry on the card (the complex
    K1 and K2 bodies) and agrees with the CPU run on the same uniforms:
    energies to 1e-8 relative, the same Metropolis decisions."""
    import numpy as np
    from peps_tpu_torch.algorithm.measure import MeasurementParams, measure
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.sweep import UpdateRule, draw_uniforms
    from peps_tpu_torch.optimizer.cg import CGParams
    from peps_tpu_torch.optimizer.optimizer import OptimizerParams, SRParams
    gen = torch.Generator().manual_seed(6)
    uni = [draw_uniforms(gen, 4, 3, 3, torch.float64, "cpu")
           for _ in range(8)]
    trunc = TruncParams(9, 1, 1e-12, scheme="sketch")
    out = {}
    for where in ("cpu", dev):
        tps, cfg = _measure_setup(where)
        rng = np.random.default_rng(4)
        tps = tps * torch.as_tensor(np.exp(0.3j * rng.standard_normal(
            tuple(tps.shape))), device=where)
        it = iter([tuple(u.to(where) for u in pair) for pair in uni])
        before = (k1.col_transfer.launches, k2.centered_o.launches)
        if entry == "measure":
            res = measure(tps, spin.heisenberg(), MeasurementParams(
                num_samples=3, num_warmup_sweeps=1, nchains=4,
                chunk_size=2), 9, trunc, UpdateRule(), cfg,
                sweep_uniforms=lambda: next(it))
            out[str(where)] = (res.stats["energy"][0], res.accept_rate)
        else:
            res = vmc_optimize(tps, spin.heisenberg(), VMCParams(
                9, trunc, MCParams(num_samples=2, num_warmup_sweeps=1,
                                   nchains=4),
                OptimizerParams(2, SRParams(CGParams(20, 1e-10),
                                            diag_shift=1e-2), lr=0.05)),
                configs=cfg, sweep_uniforms=lambda: next(it))
            out[str(where)] = (np.array(res.energies),
                               res.final_configs.cpu().numpy())
        if where == dev:
            assert k1.col_transfer.launches > before[0]
            if entry == "vmc_optimize":
                assert k2.centered_o.launches > before[1]
    a, b = out["cpu"], out[str(dev)]
    assert np.allclose(b[0], a[0], rtol=1e-8, atol=1e-12)
    assert np.array_equal(b[1], a[1])


@pytest.mark.parametrize("algo", ["minsr", "adam"])
def test_vmc_optimize_minsr_and_adam_on_the_card(dev, algo):
    """One iteration of dense MinSR (its sample matrix from K2) and of Adam
    through vmc_optimize at 4x4, D=4, f32: finite energies and states, K1
    launched in both, K2 for MinSR only."""
    import numpy as np
    from peps_tpu_torch.algorithm.mc_evaluator import MCParams
    from peps_tpu_torch.algorithm.vmc_optimize import VMCParams, vmc_optimize
    from peps_tpu_torch.lattice import boundary_mask
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.optimizer.optimizer import (AdamParams, MinSRParams,
                                                    OptimizerParams)
    rng = np.random.default_rng(8)
    tps = torch.as_tensor(rng.standard_normal((4, 4, 2) + (4,) * 4)
                          * boundary_mask(4, 4, 2, 4), dtype=torch.float32,
                          device=dev)
    alg = MinSRParams() if algo == "minsr" else AdamParams()
    params = VMCParams(8, TruncParams(8, 1, 1e-8, scheme="sketch"),
                       MCParams(num_samples=2, num_warmup_sweeps=1,
                                nchains=8),
                       OptimizerParams(1, alg, lr=1e-3),
                       occupancy=((0, 8), (1, 8)))
    b1, b2 = k1.col_transfer.launches, k2.centered_o.launches
    res = vmc_optimize(tps, spin.heisenberg(), params,
                       torch.Generator(device=dev).manual_seed(1))
    assert np.isfinite(res.energies[0])
    assert res.state.is_cuda and bool(torch.isfinite(res.state).all())
    assert k1.col_transfer.launches > b1
    assert (k2.centered_o.launches > b2) == (algo == "minsr")


def pair_operands(dev, dtype, gen, case):
    """K3 operands: "small" (chi 5, D 2, c 7: partial chunks and A tiles),
    "ragged" (chi 7, D 3: partial A tiles and c chunks of the complex
    bodies, row2 shared by the batch), "bcast" (stride-0 broadcasts: env,
    top and bot shared by 3 candidates on row1, row2 by the whole batch),
    "odd" (chi 6, D 3, c 5: no size a multiple of the f64 body's 8 x 8 x 4
    MMA tiles, so its zero-filled padding is read), or the main path's
    shapes at 8x8, D=8, chi=32, 32 chains: "env_step" (the BTen2 scan step
    of energy._pair_row_envs, 32 x 7 row pairs), "diag_block" (the diagonal
    block, 32 x 7 x 7 bonds x 2 candidates, with env, top, row2 and bot
    broadcast over the candidate axis and the candidate sites shared by the
    chains) and "antidiag_block" (the anti-diagonal block: the candidates on
    row2, row1 broadcast over them)."""
    def r(*shape):
        return _r(gen, dev, dtype, *shape)
    if case in ("small", "odd"):
        chi, D, c = (5, 2, 7) if case == "small" else (6, 3, 5)
        return (r(3, chi, D, D, c), r(3, chi, D, chi), r(D, D, D, D),
                r(3, D, D, D, D), r(c, D, c))
    if case == "ragged":      # chi 7, D 3: partial A tiles and c chunks
        chi, D = 7, 3
        return (r(2, chi, D, D, chi), r(2, chi, D, chi), r(2, D, D, D, D),
                r(D, D, D, D), r(2, chi, D, chi))
    if case == "bcast":       # env, top, bot over the candidates, row2 over all
        chi, D, nb, d = 12, 3, 4, 3
        return (r(nb, 1, chi, D, D, chi), r(nb, 1, chi, D, chi),
                r(nb, d, D, D, D, D), r(D, D, D, D), r(nb, 1, chi, D, chi))
    chi, D, nc, pairs, lx, d = 32, 8, 32, 7, 8, 2
    if case == "env_step":
        return (r(nc, pairs, chi, D, D, chi), r(nc, pairs, chi, D, chi),
                r(nc, pairs, D, D, D, D), r(nc, pairs, D, D, D, D),
                r(nc, pairs, chi, D, chi))
    nb = lx - 1
    cands, row = r(pairs, nb, d, D, D, D, D), r(nc, pairs, nb, 1, D, D, D, D)
    row1, row2 = (cands, row) if case == "diag_block" else (row, cands)
    return (r(nc, pairs, nb, 1, chi, D, D, chi), r(nc, pairs, nb, 1, chi, D,
                                                     chi),
            row1, row2, r(nc, pairs, nb, 1, chi, D, chi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["small", "odd", "env_step", "diag_block",
                                  "antidiag_block"])
def test_pair_transfer_left_and_right(dev, dtype, case):
    gen = torch.Generator(device=dev).manual_seed(len(case))
    ops = pair_operands(dev, dtype, gen, case)
    before = k3.pair_transfer.launches
    out = k3.pair_transfer(*ops)
    assert k3.pair_transfer.launches == before + 1
    assert _rel(out, k3.pair_transfer_plain(*ops)) <= TOL[dtype]
    out = k3.pair_transfer_right(*ops)
    ref = k3.pair_transfer_right(*ops, transfer=k3.pair_transfer_plain)
    assert _rel(out, ref) <= TOL[dtype]
    assert k3.pair_transfer.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_transfer_stride0_broadcasts(dev, dtype):
    """env, top and bot shared by every candidate (stride 0 on that axis),
    row1 the candidates, row2 shared by the whole batch; equal to the
    plain version on materialized copies."""
    gen = torch.Generator(device=dev).manual_seed(7)
    chi, D, nb, d = 12, 3, 4, 3
    env = _r(gen, dev, dtype, nb, 1, chi, D, D, chi)
    top = _r(gen, dev, dtype, nb, 1, chi, D, chi)
    row1 = _r(gen, dev, dtype, nb, d, D, D, D, D)
    row2 = _r(gen, dev, dtype, D, D, D, D)
    bot = _r(gen, dev, dtype, nb, 1, chi, D, chi)
    out = k3.pair_transfer(env, top, row1, row2, bot)
    full = (env.expand(nb, d, chi, D, D, chi), top.expand(nb, d, chi, D, chi),
            row1, row2.expand(nb, d, D, D, D, D),
            bot.expand(nb, d, chi, D, chi))
    full = [x.contiguous() for x in full]
    assert out.shape == (nb, d, chi, D, D, chi)
    assert _rel(out, k3.pair_transfer_plain(*full)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["small", "odd", "env_step", "diag_block",
                                  "antidiag_block", "ragged", "bcast"])
def test_pair_transfer_complex_left_and_right(dev, dtype, case):
    """The complex bodies against the plain version, both forms, at the
    small, odd and ragged sizes, a stride-0 broadcast and the main path's
    shapes. At the blocks' 3136 items the
    plain version's complex128 intermediates do not fit the card (past 80
    GB), so there it is held on the first 4 chains' items (the kernel runs
    on all of them)."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    ops = pair_operands(dev, dtype, gen, case)
    sub = 4 if case.endswith("block") and dtype == torch.complex128 \
        else None

    def head(x):
        return x[:sub] if sub else x

    # the operands with the chain axis: 4 batch dims before their own
    small = [head(o) if o.dim() - k == 4 else o
             for o, k in zip(ops, (4, 3, 4, 4, 3))]
    before = k3.pair_transfer.launches
    out = head(k3.pair_transfer(*ops))
    assert k3.pair_transfer.launches == before + 1
    assert _rel(out, k3.pair_transfer_plain(*small)) <= CX_TOL[dtype]
    del out
    out = head(k3.pair_transfer_right(*ops))
    ref = k3.pair_transfer_right(*small, transfer=k3.pair_transfer_plain)
    assert _rel(out, ref) <= CX_TOL[dtype]


@pytest.mark.parametrize("values", ["real", "complex"])
def test_pair_transfer_zmma_tile(dev, values):
    """One m16n8k8 tile through the complex128 body's fragment loads, four
    real MMAs and fragment positions (pair_transfer_zmma_tile): c <- x^T y
    + c for x [8][16], y [8][8], c [16][8], against the same product in
    torch at 1e-12. Real values hold the MMA's fragment layout alone; complex
    ones add the sign of the negated imaginary part."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    gen = torch.Generator(device=dev).manual_seed(11)
    dt = torch.complex128 if values == "complex" else torch.float64
    x, y, c = (_r(gen, dev, dt, *s).to(torch.complex128)
               for s in ((8, 16), (8, 8), (16, 8)))
    ref = x.T @ y + c
    with torch.cuda.device(dev):
        check(cuda_library().lib.pair_transfer_zmma_tile(
            x.data_ptr(), y.data_ptr(), c.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize()
    assert _rel(c, ref) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64])
def test_pair_transfer_raises_on_unplannable(dev, dtype):
    before = k3.pair_transfer.launches
    big = torch.zeros(48, 12, 12, 48, dtype=dtype, device=dev)
    top = torch.zeros(48, 12, 48, dtype=dtype, device=dev)
    site = torch.zeros(12, 12, 12, 12, dtype=dtype, device=dev)
    with pytest.raises(RuntimeError):       # no plan fits shared memory
        k3.pair_transfer(big, top, site, site, top)
    assert k3.pair_transfer.launches == before


def _rest_setup(where, ly=3, lx=4, d=2, D=2, nc=4, seed=9):
    """A seeded random OBC TPS and configurations on ``where``, f64."""
    from peps_tpu_torch.lattice import boundary_mask
    gen = torch.Generator().manual_seed(seed)
    tps = torch.randn((ly, lx, d) + (D,) * 4, generator=gen,
                      dtype=torch.float64) \
        * torch.as_tensor(boundary_mask(ly, lx, d, D), dtype=torch.float64)
    cfg = torch.stack([torch.randperm(ly * lx, generator=gen) % d
                       for _ in range(nc)]).reshape(nc, ly, lx)
    return tps.to(where), cfg.to(where)


@pytest.mark.parametrize("scheme", ["var2", "var1", "fast"])
def test_compress_schemes_on_the_card_match_the_cpu(dev, scheme):
    """Amplitudes of 4 configurations contracted with each scheme (chi 3
    truncates), f64: cuSOLVER against LAPACK, compared through the
    gauge-free amplitude at 1e-8 relative."""
    from peps_tpu_torch.contraction import bmps
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.tps import project
    out = {}
    for where in ("cpu", dev):
        tps, cfg = _rest_setup(where)
        m, lw = bmps.amplitude(project(tps, cfg), 3,
                               TruncParams(3, 1, 1e-12, scheme=scheme))
        out[str(where)] = (m * torch.exp(lw)).cpu()
    assert _rel(out[str(dev)], out["cpu"]) < 1e-8


def test_ratio_tables_and_dress_on_the_card_match_the_cpu(dev):
    """compute_ratio_tables (K1 row envs, K3 pair tables) and the dressed
    energy of a J1-J2 model, f64, at 1e-10 of the CPU's plain versions."""
    from peps_tpu_torch.algorithm import energy
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.montecarlo.jastrow import JastrowDress
    trunc = TruncParams(4, 1, 1e-12, scheme="sketch")
    model = spin.j1j2_xxz(1.0, 0.8, 0.5, 0.4)
    res = {}
    for where in ("cpu", dev):
        tps, cfg = _rest_setup(where)
        v = torch.linspace(-0.2, 0.2, 144, dtype=torch.float64,
                           device=where).reshape(12, 12)
        dress = JastrowDress((v + v.T).fill_diagonal_(0.0),
                             torch.tensor([0.0, 1.0], dtype=torch.float64,
                                          device=where))
        b1, b3 = k1.col_transfer.launches, k3.pair_transfer.launches
        tabs = energy.compute_ratio_tables(tps, cfg, 4, trunc,
                                           ("h", "v", "d", "ad"))
        ev = energy.local_energy_and_holes_dressed(tps, cfg, model, dress, 4,
                                                   trunc)
        if where == dev:
            assert k1.col_transfer.launches > b1
            assert k3.pair_transfer.launches > b3
        res[str(where)] = (tabs, ev)
    (a, ea), (b, eb) = res["cpu"], res[str(dev)]
    for f in ("ratio1", "ratio_h", "ratio_v", "ratio_d", "ratio_ad",
              "log_abs_psi"):
        assert _rel(getattr(b, f).cpu(), getattr(a, f)) < 1e-10, f
    assert _rel(eb.e_loc.cpu(), ea.e_loc) < 1e-10


def test_sweeps_on_the_card_match_the_cpu(dev):
    """mc_sweep_3site and the dressed mc_sweep with the same uniforms, f64:
    the same configurations and counts as on the CPU; K1 launched."""
    from peps_tpu_torch.lattice import transpose_tps
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.montecarlo.jastrow import JastrowDress
    from peps_tpu_torch.montecarlo.sweep import (draw_uniforms, mc_sweep,
                                                 mc_sweep_3site)
    trunc = TruncParams(4, 1, 1e-12, scheme="sketch")
    gen = torch.Generator().manual_seed(2)
    u3 = draw_uniforms(gen, 4, 3, 4, torch.float64, "cpu", window=3)
    u2 = draw_uniforms(gen, 4, 3, 4, torch.float64, "cpu")
    res = {}
    for where in ("cpu", dev):
        tps, cfg = _rest_setup(where)
        v = torch.linspace(-0.3, 0.3, 144, dtype=torch.float64,
                           device=where).reshape(12, 12)
        dress = JastrowDress((v + v.T).fill_diagonal_(0.0),
                             torch.tensor([0.0, 1.0], dtype=torch.float64,
                                          device=where))
        before = k1.col_transfer.launches
        c3, s3 = mc_sweep_3site(tps, transpose_tps(tps), cfg, 4, trunc,
                                uniforms=tuple(u.to(where) for u in u3))
        c2, s2 = mc_sweep(tps, transpose_tps(tps), cfg, 4, trunc,
                          uniforms=tuple(u.to(where) for u in u2),
                          dress=dress)
        if where == dev:
            assert k1.col_transfer.launches > before
        res[str(where)] = (c3.cpu(), int(s3.accepted), c2.cpu(),
                           int(s2.accepted))
    a, b = res["cpu"], res[str(dev)]
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    assert torch.equal(a[2], b[2]) and a[3] == b[3]


def test_cluster_simple_update_on_the_card_matches_the_cpu(dev):
    """One simple_update_nnn and one simple_update_triangle step from a
    seeded random state, f64: the bond spectra (gauge-free) at 1e-8 of the
    CPU's."""
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models import spin
    from peps_tpu_torch.peps import PEPS, SimpleUpdateParams
    from peps_tpu_torch.peps_cluster import (simple_update_nnn,
                                             simple_update_triangle)
    gen = torch.Generator().manual_seed(4)
    ly, lx, D = 3, 4, 2
    tps, _ = _rest_setup("cpu", ly, lx, 2, D)
    lam_v = torch.rand(ly + 1, lx, D, generator=gen, dtype=torch.float64)
    lam_h = torch.rand(ly, lx + 1, D, generator=gen, dtype=torch.float64)
    lam_v[[0, ly]] = torch.tensor([1.0, 0.0], dtype=torch.float64)
    lam_h[:, [0, lx]] = torch.tensor([1.0, 0.0], dtype=torch.float64)
    params = SimpleUpdateParams(1, 0.1, TruncParams(D, 1, 1e-12))
    for fn, model in ((simple_update_nnn, spin.j1j2_xxz(1, 1, 0.5, 0.5)),
                      (simple_update_triangle,
                       spin.triangle_j1j2_heisenberg(1, 0.5))):
        out = [fn(PEPS(*(x.to(where) for x in (tps, lam_v, lam_h))), model,
                  params).peps for where in ("cpu", dev)]
        assert _rel(out[1].lam_h.cpu(), out[0].lam_h) < 1e-8
        assert _rel(out[1].lam_v.cpu(), out[0].lam_v) < 1e-8


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_fermion_dress_equals_plain_exactly(dev, dtype):
    """K4 in its three outputs (projection with both flags, one row's
    candidates, a gradient undressed through a stride-0 physical axis)
    against its plain version: a multiply by +-1, so exactly equal."""
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    gen = torch.Generator().manual_seed(7)
    ly, lx, d, D, nc = 4, 5, 3, 4, 6
    sp = FermionSpace((0, 1, 1), 2, 2)
    tab = dress_tables(sp, ly, lx)
    tps = torch.randn(ly, lx, d, D, D, D, D, generator=gen,
                      dtype=torch.float64).to(dtype)
    cfg = torch.randint(0, d, (nc, ly, lx), generator=gen)
    wide = torch.randn(nc, ly, lx, D, D, D, D, generator=gen,
                       dtype=torch.float64).to(dtype)
    wide = wide.unsqueeze(3).expand(-1, -1, -1, d, -1, -1, -1, -1)
    for args, kw in (((tps,), {"select_config": True}),
                     ((tps,), {"y0": 2, "ny": 1}),
                     ((tps,), {}),
                     ((wide,), {"select_config": True, "nf": 1})):
        before = k4.fermion_dress.launches
        out = k4.fermion_dress(args[0].to(dev), cfg.to(dev), tab, **kw)
        assert k4.fermion_dress.launches == before + 1
        ref = k4.fermion_dress_plain(args[0], cfg, tab, **kw)
        assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("D", [2, 3, 5, 8])
def test_fermion_dress_layouts_equal_plain_exactly(dev, dtype, D):
    """K4 against its plain version, bit for bit, on every layout the
    wrapper takes: a shared and a per-chain tps, non-contiguous outer
    strides, a stride-0 physical axis, the projection and the candidates,
    f0 = 1 with nf = 1, and a tps whose slabs are not 16-byte aligned (the
    value-by-value path; odd D takes it too)."""
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    gen = torch.Generator().manual_seed(D)
    ly, lx, d, nc = (3, 3, 3, 5) if D < 8 else (3, 2, 3, 4)
    tab = dress_tables(FermionSpace((0, 1, 1), (D + 1) // 2, D // 2), ly, lx)

    def r(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dtype)

    tps = r(ly, lx, d, D, D, D, D)
    per = r(nc, ly, lx, d, D, D, D, D)
    strided = r(nc, ly + 1, lx, d + 1, D, D, D, D)[:, 1:, :, 1:]
    wide = r(nc, ly, lx, D, D, D, D).unsqueeze(3).expand(
        -1, -1, -1, d, -1, -1, -1, -1)
    odd = r(ly * lx * d * D ** 4 + 1)[1:].reshape(ly, lx, d, D, D, D, D)
    cfg = torch.randint(0, d, (nc, ly, lx), generator=gen)
    cases = ((tps, {"select_config": True}), (tps, {"y0": 1, "ny": 1}),
             (tps, {}), (per, {"select_config": True, "f0": 1, "nf": 1}),
             (per, {"y0": 0, "ny": 2}), (strided, {"select_config": True}),
             (strided, {"y0": 2, "ny": 1, "nf": 1}),
             (wide, {"select_config": True, "nf": 1}),
             (odd, {"y0": 1, "ny": 2}))
    for t, kw in cases:
        before = k4.fermion_dress.launches
        out = k4.fermion_dress(t.to(dev), cfg.to(dev), tab, **kw)
        assert k4.fermion_dress.launches == before + 1
        assert torch.equal(out.cpu(), k4.fermion_dress_plain(t, cfg, tab,
                                                              **kw)), kw


def test_fermion_dress_refuses_what_it_cannot_take(dev):
    """A bond dimension past 64 and a flag range past 2 raise before any
    launch."""
    from peps_tpu_torch.fermion.convert import dress_tables
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.kernels import fermion_dress as k4
    tab = dress_tables(FermionSpace((0, 1, 1), 1, 1), 2, 2)
    cfg = torch.zeros(1, 2, 2, dtype=torch.int64, device=dev)
    before = k4.fermion_dress.launches
    with pytest.raises(ValueError):
        k4.fermion_dress(torch.zeros(2, 2, 3, 2, 2, 2, 2, device=dev), cfg,
                         tab, f0=1, nf=2)
    assert k4.fermion_dress.launches == before


# ---------------------------------------------------------- K1 backward


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_col_transfer_backward_equals_plain_autograd(dev, dtype):
    """The gradients of every K1 input through ColTransferFunction (one
    launch of K1's backward kernel, no K1 launch inside the backward)
    against autograd of col_transfer_plain, at a broadcast batch like the
    sketch scans'."""
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    gen = torch.Generator().manual_seed(3)
    tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-12

    def r(*shape):
        return torch.randn(*shape, generator=gen,
                           dtype=torch.float64).to(dtype)

    chi, D = 12, 4
    ops = [r(3, chi, D, chi), r(3, chi, D, chi), r(3, D, D, D, D),
           r(chi, D, chi)]
    w = r(3, chi, D, chi)
    grads = {}
    for where in ("cpu", dev):
        xs = [o.detach().to(where).requires_grad_(True) for o in ops]
        out = k1.col_transfer(*xs) if where == dev else \
            k1.col_transfer_plain(*xs)
        before = (kb.col_transfer_backward.launches, k1.col_transfer.launches)
        (out * w.to(where)).real.sum().backward()
        if where == dev:
            assert (kb.col_transfer_backward.launches,
                    k1.col_transfer.launches) == (before[0] + 1, before[1])
        grads[str(where)] = [x.grad.cpu() for x in xs]
    for a, b in zip(grads[str(dev)], grads["cpu"]):
        assert _rel(a, b) <= tol


def _backward_case(name, dtype, gen, dev):
    """(form, operands, needs) of a K1 backward card case: the graded
    holes' sketch V (right form, the block in the bot slot) and W scans and
    the pair traces (env, top and bot broadcast over a candidate dim) at
    6x6, D=8, chi=32, a chunk of 8 chains; the pair traces with env and
    top expanded over the candidates (stride 0, size 3: a gradient per
    candidate, summed by autograd) while bot (size 1) needs its gradient
    over them; a small case with every operand broadcast somewhere and two
    batch dims."""
    def r(*shape):
        return _rc(gen, dev, dtype, *shape)

    chi, D, losk = 32, 8, 40
    site = (D, D, D, D)
    if name == "sketch_v":
        return "right", (r(8, chi, D, chi), r(8, chi, D, chi), r(8, *site),
                         r(chi, D, chi)), (True, True, True, False)
    if name == "sketch_w":
        return "left", (r(8, chi, D, losk), r(8, chi, D, chi), r(8, *site),
                        r(losk, D, losk)), (True, True, True, False)
    if name in ("pair_traces", "expanded"):
        return "left", (r(8, 6, 5, 1, chi, D, chi), r(8, 6, 5, 1, chi, D, chi),
                        r(8, 6, 5, 3, *site), r(8, 6, 5, 1, chi, D, chi)), \
            (True, True, True, True)
    return "left", (r(1, 3, 7, 3, 9), r(4, 3, 7, 2, 6), r(4, 1, 2, 3, 5, 3),
                    r(4, 3, 9, 5, 11)), (True, False, True, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["sketch_v", "sketch_w", "pair_traces",
                                  "expanded", "mixed"])
@pytest.mark.parametrize("cluster", [None, 1, 8])
def test_col_transfer_backward_kernel_cases(dev, dtype, case, cluster,
                                            monkeypatch):
    """K1's backward kernel against autograd of col_transfer_plain at the
    graded holes' shapes, an expanded env and top, and a mixed broadcast,
    at the plan's cluster size and at 1 and 8 CTAs a cluster: every
    requested gradient within 1e-5 (f32, complex64) / 1e-12 (f64,
    complex128) of max |plain|, one launch."""
    from peps_tpu_torch.kernels import col_transfer_backward as kb
    if cluster is not None:
        plan = kb.backward_plan
        monkeypatch.setattr(kb, "backward_plan", lambda *a, **k: plan(
            *a, **{**k, "cluster": cluster}))
        monkeypatch.setattr(kb, "_META_CACHE", {})
    gen = torch.Generator(device=dev).manual_seed(len(case))
    form, ops, needs = _backward_case(case, dtype, gen, dev)
    grads = []
    for fn in (k1.col_transfer, k1.col_transfer_plain):
        xs = [o.detach().clone().requires_grad_(n) for o, n in zip(ops, needs)]
        args = [x.expand(*x.shape[:-4], 3, *x.shape[-3:])
                if case == "expanded" and i < 2 else x
                for i, x in enumerate(xs)]
        out = k1.col_transfer_right(*args, transfer=fn) if form == "right" \
            else fn(*args)
        w = _rc(torch.Generator(device=dev).manual_seed(5), dev, dtype,
                *out.shape)
        before = kb.col_transfer_backward.launches
        grads.append(torch.autograd.grad(out, [x for x in xs
                                               if x.requires_grad], w))
        launched = kb.col_transfer_backward.launches - before
        assert launched == (1 if fn is k1.col_transfer else 0)
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert _rel(a, b) <= ALL_TOL[dtype]


def test_graded_local_energy_on_the_card_matches_the_cpu(dev):
    """The graded t-J local energy and holes (K4, K1 and its backward, K3)
    of a seeded 3x3 D=4 state in complex128 at chi = 3: within 1e-10 of
    the CPU's."""
    from peps_tpu_torch.fermion.peps import FermionSpace
    from peps_tpu_torch.fermion.vmc import (GradedFermionModel,
                                            local_energy_and_holes_graded)
    from peps_tpu_torch.linalg import TruncParams
    from peps_tpu_torch.models.fermion import tj_model
    gen = torch.Generator().manual_seed(9)
    sp = FermionSpace((0, 1, 1), 2, 2)
    tps = torch.complex(torch.randn(3, 3, 3, 4, 4, 4, 4, generator=gen,
                                    dtype=torch.float64),
                        torch.randn(3, 3, 3, 4, 4, 4, 4, generator=gen,
                                    dtype=torch.float64))
    cfg = torch.stack([torch.randperm(9, generator=gen) % 3
                       for _ in range(4)]).reshape(4, 3, 3)
    # chi = 3 truncates every boundary (rank 4 and more): where a sketch
    # Gram is rank-deficient the holes move with the summation order
    trunc = TruncParams(3, 1, 1e-12, scheme="sketch")
    res = []
    for where in ("cpu", dev):
        gm = GradedFermionModel.from_model(tj_model(3.0, 1.0, t2=0.5), sp,
                                           tps.dtype, where)
        res.append(local_energy_and_holes_graded(
            tps.to(where), cfg.to(where), gm, 3, trunc))
    for f in ("e_loc", "o_tensor", "log_abs_psi"):
        assert _rel(getattr(res[1], f).cpu(), getattr(res[0], f)) < 1e-10


ALL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12,
           torch.complex64: 1e-5, torch.complex128: 1e-12}


def _rc(gen, dev, dtype, *shape):
    """Seeded normal values of dtype (complex: both parts)."""
    real = torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64
    x = torch.randn(*shape, generator=gen, device=dev, dtype=real)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(*shape, generator=gen, device=dev,
                                         dtype=real))
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("chi", [8, 16, 37, 64])
def test_bmps_overlap_shared_bottom_groups(dev, dtype, lanes, chi):
    """K5 where one b slab serves a group of 1 to 5 lanes (batch stride 0),
    chi from 8 to 64 (37: padded to 48; complex128 at 64 takes the simple
    body), 3 groups, Lx = 3, D = 3, against the plain version; one launch."""
    from peps_tpu_torch.kernels import bmps_overlap as k5
    gen = torch.Generator(device=dev).manual_seed(chi * 10 + lanes)
    a = _rc(gen, dev, dtype, 3, lanes, 3, chi, 3, chi)
    b = _rc(gen, dev, dtype, 3, 1, 3, chi, 3, chi)
    before = k5.bmps_overlap.launches
    mant, logw = k5.bmps_overlap(a, b)
    assert k5.bmps_overlap.launches == before + 1
    rm, rl = k5.bmps_overlap_plain(a, b)
    psi, ref = mant * torch.exp(logw - rl.max()), rm * torch.exp(rl - rl.max())
    assert _rel(psi, ref) <= ALL_TOL[dtype]
    assert (logw - rl).abs().max().item() <= 10 * ALL_TOL[dtype] * 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["partial", "odd_chi", "lx1", "flagship"])
def test_bmps_overlap_equals_plain(dev, dtype, case):
    """K5 against its plain version: chi = 5 (one partial tile of outputs
    a thread), chi = 37 (chi^2 not a multiple of the 256 threads), Lx = 1,
    and the flagship's per-k shape (8 configurations x 5 start lanes x 6
    columns x 4 closures, Lx = 6, chi = 32, D = 8) with b broadcast over
    the start lanes; each call adds one launch to the counter."""
    from peps_tpu_torch.kernels import bmps_overlap as k5
    gen = torch.Generator(device=dev).manual_seed(len(case))
    lx, chi, D, a_batch, b_batch = {
        "partial": (4, 5, 3, (7,), (7,)),
        "odd_chi": (3, 37, 2, (2, 3), (2, 1)),
        "lx1": (1, 16, 4, (5,), (1,)),
        "flagship": (6, 32, 8, (8, 5, 6, 4), (8, 1, 6, 4))}[case]
    a = _rc(gen, dev, dtype, *a_batch, lx, chi, D, chi)
    b = _rc(gen, dev, dtype, *b_batch, lx, chi, D, chi)
    before = k5.bmps_overlap.launches
    mant, logw = k5.bmps_overlap(a, b)
    assert k5.bmps_overlap.launches == before + 1
    rm, rl = k5.bmps_overlap_plain(a, b)
    assert mant.shape == rm.shape and logw.dtype == rl.dtype
    # compare psi = mant exp(logw) relative to the largest
    psi, ref = mant * torch.exp(logw - rl.max()), rm * torch.exp(rl - rl.max())
    assert _rel(psi, ref) <= ALL_TOL[dtype]
    assert (logw - rl).abs().max().item() <= 10 * ALL_TOL[dtype] * lx


def _graded_walker_case(ly, lx, dtype):
    """A seeded graded state and three configurations with supported
    entries in the frame of the lattice's long lines."""
    from peps_tpu_torch.fermion.peps import FermionSpace
    gen = torch.Generator().manual_seed(ly * 10 + lx)
    sp = FermionSpace((0, 1, 1), 2, 2)
    shape = (ly, lx, 3, 4, 4, 4, 4)
    tps = torch.randn(*shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        tps = torch.complex(tps, torch.randn(*shape, generator=gen,
                                             dtype=torch.float64))
    occ = torch.tensor([[1, 2, 0, 0], [2, 1, 1, 2], [0, 0, 2, 1]])
    cfg = torch.stack([occ, occ.flip(0), occ.roll(1, 1)])
    if ly > lx:
        cfg = cfg.transpose(1, 2).flip(2)
    return tps.to(dtype), cfg, sp


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("ly,lx", [(3, 4), (4, 3)])
def test_graded_pair_walkers_on_the_card_match_the_cpu(dev, dtype, ly, lx):
    """Both env-shared graded walkers (K4, K1, the sketch's K1 scans, K5)
    and the full-recompute oracle on the card against the CPU at 3x4 (the
    in-row pairs) and 4x3 (the in-column pairs, through K5), D = 4: within
    1e-10, and K5 launched exactly once per end bond k >= 2 of the column
    walker (Ly - 3 launches). chi = 6 truncates every boundary past the
    first row, as chip_smoke's card-against-CPU checks (a chi that
    truncates nothing leaves sketch Grams rank deficient, held only by
    the jitter, and the values move with the summation order)."""
    from peps_tpu_torch.algorithm import measure_fermion as mf
    from peps_tpu_torch.kernels import bmps_overlap as k5
    from peps_tpu_torch.linalg import TruncParams
    tps, cfg, sp = _graded_walker_case(ly, lx, dtype)
    chi = 6
    trunc = TruncParams(chi, 1, 1e-12, scheme="sketch")
    out = {}
    for where in ("cpu", dev):
        t, c = tps.to(where), cfg.to(where)
        shared = mf.graded_env_shared(t, c, sp, chi, trunc)
        before = k5.bmps_overlap.launches
        col = mf.tj_singlet_pair_corr_graded_colshared(t, c, sp, chi, trunc,
                                                       shared)
        launched = k5.bmps_overlap.launches - before
        out[str(where)] = (
            mf.tj_singlet_pair_corr_graded_rowshared(t, c, sp, chi, trunc,
                                                     shared).cpu(),
            col.cpu(),
            mf.tj_singlet_pair_corr_graded(t, c, sp, chi, trunc,
                                           "row" if lx > 3 else "col").cpu())
        if where != "cpu":
            assert launched == max(ly - 3, 0)
    for a, b in zip(out[str(dev)], out["cpu"]):
        assert (a - b).abs().max().item() <= 1e-10 * max(
            b.abs().max().item(), 1.0)
    assert out["cpu"][2].abs().max().item() > 0
