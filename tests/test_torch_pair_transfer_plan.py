"""K3's launch plan (kernels/pair_transfer.py:pair_transfer_plan) on the
CPU: at the J1-J2 path's shapes it fits the H100's shared memory (f32 at two
CTAs an SM; the complex bodies at A tiles of 2 or more), its tiles cover the
output exactly once, its layout keeps the f32 body's 16-byte stores and the
f64 and complex bodies' fragment loads free of bank conflicts, small odd
and ragged shapes are planned and a shape that fits nothing is refused.
Pure Python: no kernel runs here."""
import ctypes

import numpy as np
import pytest
import torch

from peps_tpu_torch.kernels import pair_transfer as k3

SMEM_PER_BLOCK = 232448          # 227 KB a CTA may use
SMEM_PER_SM = 233472             # 228 KB an SM holds
F32, F64 = torch.float32, torch.float64
C64, C128 = torch.complex64, torch.complex128
ITEM = {F32: 4, F64: 8, C64: 8, C128: 16}
KQ = {F32: 1, F64: 4, C64: 1, C128: 8}          # K padded to this
MAIN = (32, 8, 8, 32, 8, 32, 8, 8, 8, 8, 32)      # chi = 32, D = 8
SHAPES = {
    "env_step": (MAIN, 32 * 7),
    "diag_block": (MAIN, 32 * 7 * 7 * 2),
    "small": ((5, 2, 2, 7, 2, 5, 2, 2, 2, 2, 7), 3),
    "odd": ((6, 3, 3, 5, 3, 6, 3, 3, 3, 3, 5), 3),
    "chi48_d6": ((48, 6, 6, 48, 6, 48, 6, 6, 6, 6, 48), 5),
    "ragged": ((7, 3, 3, 7, 3, 7, 3, 3, 3, 3, 7), 2),
}
UNPLANNABLE = (48, 12, 12, 48, 12, 48, 12, 12, 12, 12, 48)   # chi 48, D 12


def _plan(name, dtype):
    dims, items = SHAPES[name]
    return k3.pair_transfer_plan(dims, dtype, items)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", ["env_step", "diag_block"])
def test_main_path_plan_fits_shared_memory(name, dtype):
    plan = _plan(name, dtype)
    assert (plan["ta"], plan["kc"]) == (4, 2)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    reserved = k3.SMEM_RESERVED_PER_CTA
    if dtype == F32:                 # two CTAs of 8 warps an SM
        assert 2 * (plan["smem_bytes"] + reserved) <= SMEM_PER_SM
        assert plan["smem_ctas_per_sm"] == 2
        assert plan["body"] == "simt_fma_f32"
    else:
        assert plan["body"] == "dmma_m8n8k4_f64"
    assert plan["ctas"] == SHAPES[name][1] * 8      # 32 values of A / 4


def _tile_of(t, n_mt, n_nt):
    """The kernel's tile_of: the lanes of a warp on an 8 x 4 block."""
    lane, sup = t & 31, t >> 5
    n_smt = -(-n_mt // 8)
    mi = (sup % n_smt) * 8 + (lane & 7)
    ni = (sup // n_smt) * 4 + (lane >> 3)
    return mi, ni, mi < n_mt and ni < n_nt


def _step4_cover(plan, dims):
    """How often each output value of one item is written: every A tile,
    every thread's 4 x 8 tile (f32) or every warp's lanes' MMA fragments of
    a 32 x 32 tile (f64), masked at the valid rows and columns."""
    nA, nr, nf, nC = dims[5], dims[7], dims[9], dims[10]
    ta = plan["ta"]
    count = np.zeros((nA, nr * nf, nC), dtype=int)
    for a0 in range(0, nA, ta):
        rows = min(ta, nA - a0) * nr * nf
        if plan["dtype"] == F32:
            n_mt, n_nt = -(-ta * nr * nf // 4), -(-nC // 8)
            for t in range(k3.THREADS):
                mi, ni, own = _tile_of(t, n_mt, n_nt)
                if not own:
                    continue
                for i in range(4):
                    for j in range(8):
                        r, c = mi * 4 + i, ni * 8 + j
                        if r < rows and c < nC:
                            count[a0 + r // (nr * nf), r % (nr * nf), c] += 1
        else:
            n_wm = -(-ta * nr * nf // 32)
            for w in range(k3.WARPS):
                if w >= n_wm * -(-nC // 32):
                    continue
                m0, n0 = (w % n_wm) * 32, (w // n_wm) * 32
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    for i in range(4):
                        for j in range(4):
                            for h in range(2):
                                r, c = m0 + 8 * i + g, n0 + 8 * j + 2 * q + h
                                if r < rows and c < nC:
                                    count[a0 + r // (nr * nf), r % (nr * nf),
                                          c] += 1
    return count


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", ["env_step", "small", "odd", "chi48_d6"])
def test_tiles_cover_the_output_exactly_once(name, dtype):
    dims, items = SHAPES[name]
    plan = k3.pair_transfer_plan(dims, dtype, items)
    assert plan["a_tiles"] == -(-dims[5] // plan["ta"])
    assert plan["ctas"] == items * plan["a_tiles"]
    assert plan["c_chunks"] * plan["kc"] >= dims[3]
    assert (plan["c_chunks"] - 1) * plan["kc"] < dims[3]
    assert (_step4_cover(plan, dims) == 1).all()


def _regions(plan, dims):
    """(offset, size) of each shared-memory region in elements, as the
    kernel's check_plan counts them."""
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    kq = KQ[plan["dtype"]]

    def kp(x):
        return -(-x // kq) * kq

    x1 = kp(nu * nm) * plan["ld1"]
    x3 = kp(plan["kc"] * ne) * plan["ld3"]
    shared = plan["oX3"] == plan["oX1"]
    return [(plan["oR1"], kp(nu * nm) * plan["ldR1"]),
            (plan["oR2"], kp(nd * nn) * plan["ldR2"]),
            (plan["oT"], kp(na) * plan["ldT"]),
            (plan["oE"], plan["szE"]), (plan["oB"], 2 * plan["szB"]),
            (plan["oX1"], max(x1, x3) if shared else x1),
            (plan["oX2"], kp(nd * nn) * plan["ld2"]),
            (plan["oX3"], 0 if shared else x3)]


@pytest.mark.parametrize("dtype", [F32, F64, C64, C128])
@pytest.mark.parametrize("name", list(SHAPES))
def test_layout_regions_are_aligned_disjoint_and_fit(name, dtype):
    dims, _ = SHAPES[name]
    plan = _plan(name, dtype)
    item = ITEM[dtype]
    w = 16 // item
    regions = _regions(plan, dims)
    for i, (o, n) in enumerate(regions):
        assert o % w == 0
        for o2, n2 in regions[:i]:
            assert n == 0 or n2 == 0 or o + n <= o2 or o2 + n2 <= o
    end = max(o + n for o, n in regions)
    assert plan["oTab"] >= end * item and plan["oTab"] % 16 == 0
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    for key in ("ldE", "ldT", "ldR1", "ldR2", "ld1", "ld2", "ld3", "ldB"):
        assert plan[key] % w == 0
        if dtype == F64:             # DMMA fragment loads: see below
            assert plan[key] % 16 == (2 if key == "ldE" and plan["sw"] else 4)
        if dtype == C128:            # 32 mod 128 bytes, as f64's
            assert plan[key] % 8 == 2
    if KQ[dtype] > 1:                # K padded: T3 shares T1 only
        kq = KQ[dtype]
        shares = (dims[4] * dims[1]) % kq == 0 \
            and (plan["kc"] * dims[8]) % kq == 0
        assert plan["t3_shares_t1"] == shares


def test_small_odd_shape_is_planned():
    """chi 6, D 3, c 5: no size is a multiple of the MMA tiles; the f64 plan
    pads K to 4 with zero rows and keeps T1 and T3 apart."""
    dims, items = SHAPES["odd"]
    for dtype in (F32, F64):
        plan = k3.pair_transfer_plan(dims, dtype, items)
        assert (plan["ta"], plan["kc"]) == (4, 2)
        assert plan["c_chunks"] == 3 and plan["a_tiles"] == 2
    assert not k3.pair_transfer_plan(dims, F64, items)["t3_shares_t1"]


def test_unplannable_shape_is_refused():
    for dtype in (F32, F64):
        with pytest.raises(RuntimeError, match="no pair_transfer plan"):
            k3.pair_transfer_plan(UNPLANNABLE, dtype)


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("name", ["env_step", "diag_block"])
def test_complex_main_path_plan_fits_shared_memory(name, dtype):
    """The complex bodies at the J1-J2 shapes: an A tile of 2 (step 4's
    4096 complex outputs kept in registers across the chunks), one CTA an
    SM within 227 KB, complex64 at chunks of 4 values of c, complex128 at
    1."""
    plan = _plan(name, dtype)
    assert plan["ta"] >= 2 and (plan["ta"], plan["kc"]) == \
        ((2, 4) if dtype == C64 else (2, 1))
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    assert plan["smem_ctas_per_sm"] == 1
    assert plan["body"] == ("simt_cx4x4_c64" if dtype == C64
                            else "zmma_m16n8k8_c128")
    assert plan["ctas"] == SHAPES[name][1] * 16      # 32 values of A / 2
    assert (plan["kl"], plan["zn"], plan["sw"]) == (plan["kc"],
                                                    8 * plan["kc"], 0)


def _complex_step4_cover(plan, dims):
    """How often each output value of one item is written by the complex
    bodies' step 4: complex64, each thread's 4 x 4 tile of its warp's 16 x
    32 block (lane & 3 rows, lane >> 2 columns); complex128, each warp's 2 x
    2 MMA tiles of 16 x 8 (lane l: rows l >> 2 and + 8, columns 2 (l & 3)
    and + 1), masked at the valid rows and columns."""
    nA, nr, nf, nC = dims[5], dims[7], dims[9], dims[10]
    ta, m4 = plan["ta"], plan["ta"] * dims[7] * dims[9]
    count = np.zeros((nA, nr * nf, nC), dtype=int)
    for a0 in range(0, nA, ta):
        rows = min(ta, nA - a0) * nr * nf
        cells = []
        if plan["dtype"] == C64:
            n_sm = -(-m4 // 16)
            for w in range(min(k3.WARPS, n_sm * -(-nC // 32))):
                for lane in range(32):
                    m0 = (w % n_sm) * 16 + (lane & 3) * 4
                    n0 = (w // n_sm) * 32 + (lane >> 2) * 4
                    if m0 < m4 and n0 < nC:
                        cells += [(m0 + i, n0 + j) for i in range(4)
                                  for j in range(4)]
        else:
            n_wm = -(-m4 // 32)
            for w in range(min(k3.WARPS, n_wm * -(-nC // 16))):
                m0, n0 = (w % n_wm) * 32, (w // n_wm) * 16
                for lane in range(32):
                    cells += [(m0 + 16 * i + (lane >> 2) + 8 * (v >> 1),
                               n0 + 8 * j + 2 * (lane & 3) + (v & 1))
                              for i in range(2) for j in range(2)
                              for v in range(4)]
        for r, c in cells:
            if r < rows and c < nC:
                count[a0 + r // (nr * nf), r % (nr * nf), c] += 1
    return count


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("name", ["env_step", "small", "odd", "ragged",
                                  "chi48_d6"])
def test_complex_tiles_cover_the_output_exactly_once(name, dtype):
    dims, items = SHAPES[name]
    plan = k3.pair_transfer_plan(dims, dtype, items)
    assert plan["ctas"] == items * -(-dims[5] // plan["ta"])
    assert (plan["c_chunks"] - 1) * plan["kc"] < dims[3] \
        <= plan["c_chunks"] * plan["kc"]
    assert (_complex_step4_cover(plan, dims) == 1).all()


@pytest.mark.parametrize("dtype", [F32, F64, C64, C128])
def test_ragged_shape_is_planned(dtype):
    """chi 7, D 3: the last A tile and the last c chunk are partial for the
    complex bodies (7 values of A and of c in tiles and chunks of 4)."""
    dims, items = SHAPES["ragged"]
    plan = k3.pair_transfer_plan(dims, dtype, items)
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    if dtype in (C64, C128):
        assert dims[5] % plan["ta"] != 0 and dims[3] % plan["kc"] != 0


@pytest.mark.parametrize("dtype", [C64, C128])
def test_complex_unplannable_shape_is_refused(dtype):
    with pytest.raises(RuntimeError, match="no pair_transfer plan"):
        k3.pair_transfer_plan(UNPLANNABLE, dtype)


def _quarter_wavefronts(chunks):
    """Wavefronts one quarter-warp's 16-byte loads take: the most distinct
    16-byte chunks that share one of the 8 bank groups (a chunk read by
    several lanes is one)."""
    groups = {}
    for c in set(chunks):
        groups.setdefault(c % 8, set()).add(c)
    return max(len(v) for v in groups.values())


@pytest.mark.parametrize("name", ["env_step", "diag_block", "odd"])
def test_complex64_fragment_loads_are_conflict_free(name):
    """complex64: a lane loads 4 complex values (32 bytes) of X at column
    m0 + 4 (lane & 3) and of Y at n0 + 4 (lane >> 2), as two 16-byte loads;
    each quarter-warp's loads touch one chunk per bank group, for any
    leading dim and row."""
    plan = _plan(name, C64)
    for key in ("ldE", "ldT", "ldR1", "ldR2", "ld1", "ld2", "ld3", "ldB"):
        ld = plan[key]
        for k in range(3):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                for half in (0, 1):
                    for col in (lambda l: 4 * (l & 3), lambda l: 4 * (l >> 2)):
                        chunks = [(k * ld + col(l)) // 2 + half for l in lanes]
                        assert _quarter_wavefronts(chunks) == 1


@pytest.mark.parametrize("name", ["env_step", "diag_block", "odd"])
def test_complex128_fragment_loads_are_conflict_free(name):
    """complex128: lane l loads one element (16 bytes) at row l & 3 (+ 4)
    and column l >> 2 (+ 8) of its tile; with every leading dim 2 mod 8
    elements, each quarter-warp's 8 lanes hit 8 distinct bank groups."""
    plan = _plan(name, C128)
    for key in ("ldE", "ldT", "ldR1", "ldR2", "ld1", "ld2", "ld3", "ldB"):
        ld = plan[key]
        for k0 in (0, 4):
            for c0 in (0, 8, 16):
                for quarter in range(4):
                    lanes = range(8 * quarter, 8 * quarter + 8)
                    chunks = [(k0 + (l & 3)) * ld + c0 + (l >> 2)
                              for l in lanes]
                    assert _quarter_wavefronts(chunks) == 1


def test_plan_refuses_what_the_kernel_does_not_take():
    for dtype in (torch.int32, torch.bfloat16):     # complex is taken
        with pytest.raises(TypeError, match="pair_transfer takes"):
            k3.pair_transfer_plan(MAIN, dtype)
    with pytest.raises(ValueError, match="sizes"):
        k3.pair_transfer_plan(MAIN[:-1] + (0,), F32)
    with pytest.raises(ValueError, match="2\\^31"):
        k3.pair_transfer_plan(MAIN, F32, items=2 ** 29)


def _bank_groups(addrs):
    """Wavefronts of one quarter-warp's 16-byte accesses (float offsets):
    the most distinct 16-byte chunks that share one of the 8 bank groups."""
    groups = {}
    for a in set(addrs):
        groups.setdefault((a // 4) % 8, set()).add(a // 4)
    return max(len(v) for v in groups.values())


def _f32_tables(plan, dims):
    """The kernel's offset tables of steps 1-3 and the products' sizes."""
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    ta, kc = plan["ta"], plan["kc"]
    ld1, ld2, ld3 = plan["ld1"], plan["ld2"], plan["ld3"]
    return [
        (nn * kc * nm, nu * ta,         # (n, m, c') -> T1[(u,m)][(c',n,A')]
         lambda i: (i // kc % nm) * ld1 + (i % kc * nn + i // (kc * nm)) * ta,
         lambda j: (j // ta) * nm * ld1 + j % ta),
        (nn * kc * ta, nd * nr,         # (c', n, A') -> T2[(d,n)][(c',A',r)]
         lambda i: (i // ta % nn) * ld2 + (i // (nn * ta)) * ta * nr
         + (i % ta) * nr,
         lambda j: (j // nr) * nn * ld2 + j % nr),
        (ne * nf, kc * ta * nr,
         lambda i: (i // nf) * ld3 + i % nf,
         lambda j: (j // (ta * nr)) * ne * ld3 + (j % (ta * nr)) * nf)]


@pytest.mark.parametrize("step", [1, 2, 3])
def test_f32_scatter_stores_are_conflict_free_at_the_main_shape(step):
    """Every quarter-warp (8 lanes on 8 row tiles, one column tile) stores
    16 bytes a lane, along the contiguous index of the destination, on 8
    distinct bank groups."""
    plan = _plan("diag_block", F32)
    M, N, ro, co = _f32_tables(plan, MAIN)[step - 1]
    n_mt, n_nt = M // 4, N // 4
    along_n = all(co(n + j) == co(n) + j for n in range(0, N, 4)
                  for j in range(4))
    along_m = all(ro(m + i) == ro(m) + i for m in range(0, M, 4)
                  for i in range(4))
    assert along_n or along_m
    worst = 0
    for t0 in range(0, k3.THREADS, 8):
        lanes = [_tile_of(t, n_mt, n_nt) for t in range(t0, t0 + 8)]
        assert all(own for _, _, own in lanes)
        for k in range(4):
            if along_n:
                addrs = [ro(mi * 4 + k) + co(ni * 4) for mi, ni, _ in lanes]
            else:
                addrs = [ro(mi * 4) + co(ni * 4 + k) for mi, ni, _ in lanes]
            assert all(a % 4 == 0 for a in addrs)
            worst = max(worst, _bank_groups(addrs))
    assert worst == 1


def _env_pos(plan, i, h):
    """The kernel's EPos: the column of step 1's row i in the env copy."""
    kc, kl, zn, nm = plan["kc"], plan["kl"], plan["zn"], plan["dims"][1]
    if plan["sw"]:
        i = (i & ~6) | ((i & 2) << 1) | ((i & 4) >> 1)
    g = i // kc
    return (g // nm) * zn + (g % nm) * kl + h * kc + i % kc


@pytest.mark.parametrize("key", ["ldE", "ldT", "ldR1", "ldR2", "ld1", "ld2",
                                 "ld3", "ldB"])
def test_f64_fragment_loads_are_conflict_free(key):
    """A DMMA fragment load: lane l reads row k0 + (l & 3) and the column of
    index c0 + (l >> 2); each half-warp's 16 doubles fall on 16 distinct
    8-byte bank pairs. For env (step 1's X, in its copy of two chunks, rows
    taken with bits 1 and 2 swapped) at every row tile and chunk half."""
    plan = _plan("diag_block", F64)
    ld = plan[key]
    tiles = range(0, 128, 8) if key == "ldE" else [0]
    for c0 in tiles:
        for h in ((0, 1) if key == "ldE" else (0,)):
            for half in (0, 1):
                lanes = range(16 * half, 16 * half + 16)
                col = [(_env_pos(plan, c0 + (l >> 2), h) if key == "ldE"
                        else l >> 2) for l in lanes]
                pairs = {((l & 3) * ld + c) % 16 for l, c in zip(lanes, col)}
                assert len(pairs) == 16


def test_env_rows_are_a_permutation_within_tiles():
    """The swap maps every aligned group of 8 rows of step 1 onto itself, so
    the tables and the copy cover env exactly once."""
    plan = _plan("diag_block", F64)
    assert plan["sw"] == 1
    m1 = MAIN[2] * plan["kc"] * MAIN[1]
    for h in (0, 1):
        cols = [_env_pos(plan, i, h) for i in range(m1)]
        assert len(set(cols)) == m1
        natural = {(i // 2) * plan["kl"] + 2 * h + i % 2 for i in range(m1)}
        assert set(cols) == natural


def test_f32_step1_env_loads_are_conflict_free_at_the_main_shape():
    """Step 1 reads its 4 env values of a tile as two 8-byte loads (the c'
    pairs of m and m + 1, kl apart in the copy of two chunks): the 8 row
    tiles of a half-warp then hit 8 distinct 8-byte bank pairs, for either
    half of the copy."""
    plan = _plan("diag_block", F32)
    assert (plan["kc"], plan["kl"], plan["sw"]) == (2, 4, 0)
    assert plan["zn"] % 4 == 0                     # 16-byte env copies

    def pos(i, h):
        return _env_pos(plan, i, h)

    for h in (0, 1):
        for first in (0, 2):                       # the two 8-byte loads
            for t0 in range(0, 128, 32):
                words = {pos(4 * (t0 // 32 * 8 + mi) + first, h) // 2
                         for mi in range(8)}
                assert len(words) == 8
                assert len({w % 16 for w in words}) == 8


def test_launch_meta_carries_the_plan():
    ops = (torch.zeros(3, 5, 2, 2, 7), torch.zeros(3, 5, 2, 5),
           torch.zeros(2, 2, 2, 2), torch.zeros(3, 2, 2, 2, 2),
           torch.zeros(7, 2, 7))
    batch, meta = k3.launch_meta(*ops)
    assert tuple(batch) == (3,)
    plan = k3.pair_transfer_plan(SHAPES["small"][0], F32, 3)
    n = k3.META_INTS
    assert isinstance(meta, ctypes.Array)
    assert len(meta) == n + len(k3.PLAN_KEYS) == 53 + 25
    assert list(meta)[n - 11:n] == list(SHAPES["small"][0])
    assert list(meta)[n:] == [plan[k] for k in k3.PLAN_KEYS]


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives the wrapper down its
    launch path on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrapper_refuses_an_unplannable_shape_before_launch(monkeypatch):
    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(k3, "pair_transfer_plain", no_plain)
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = UNPLANNABLE

    def cuda_like(*shape):        # an expanded view costs no memory
        return torch.Tensor._make_subclass(
            _CudaLike, torch.zeros(1, dtype=F64).expand(*shape))

    before = k3.pair_transfer.launches
    with pytest.raises(RuntimeError, match="no pair_transfer plan"):
        k3.pair_transfer(cuda_like(na, nm, nn, nc), cuda_like(na, nu, nA),
                         cuda_like(nu, nm, nd, nr), cuda_like(nd, nn, ne, nf),
                         cuda_like(nc, ne, nC))
    assert k3.pair_transfer.launches == before
