"""K1's launch plan (kernels/col_transfer.py:col_transfer_launch_plan) on the
CPU, for all four dtypes: at chip_smoke.py's ten K1 shapes (8x8, D=8,
chi=32, 32 chains) and at those of the 4x4, D=4, chi=16, 8-chain
card-against-CPU check, the complex plans fit the H100's shared memory and
the tiles a warp holds; a model of the complex bodies' tile mapping covers
every output exactly once, also past a partial last A tile and c chunk;
the complex64 fragment loads and pair stores and the complex128 fragment
loads are free of bank conflicts at the main path's leading dims; a shape
that fits nothing is refused; and the real bodies' plans are the ones the
kernel's C plan rule gave before the rule moved to Python. Pure Python: no
kernel runs here."""
import ctypes

import numpy as np
import pytest
import torch

from peps_tpu_torch.kernels import col_transfer as k1

SMEM_PER_BLOCK = 232448          # 227 KB a CTA may use
SMS = 132                        # the H100's SMs
F32, F64 = torch.float32, torch.float64
C64, C128 = torch.complex64, torch.complex128
KQ = {C64: 1, C128: 8}           # K padded to this


def k1_shapes(ly, lx, D, chi, nch, d=2):
    """chip_smoke.k1_cases's shapes as (name, dims, items): dims = (na, nl,
    nc, nu, nA, nd, nr, nC) of the left form (the right-form cases are
    symmetric there); the sketch's w step has c = C = chi + 8."""
    m = (chi, D, chi, D, chi, D, D, chi)
    w = (chi, D, chi + 8, D, chi, D, D, chi + 8)
    return [("sketch_v_step", m, nch), ("sketch_w_step", w, nch),
            ("right_btens", m, nch), ("bond_step", m, nch * d),
            ("row_envs", m, nch * ly),
            ("right_blocks", m, nch * (lx - 1) * d),
            ("nn_traces", m, nch * ly * (lx - 1) * d),
            ("walker", m, nch * ly * lx),
            ("window3_first", m, nch * 6), ("window3_next", m, nch * 6)]


MAIN_SHAPES = k1_shapes(8, 8, 8, 32, 32)
SMALL_SHAPES = k1_shapes(4, 4, 4, 16, 8)
SHAPES = [("main_" + n, d, i) for n, d, i in MAIN_SHAPES] + \
    [("small_" + n, d, i) for n, d, i in SMALL_SHAPES]
SHAPE_IDS = [s[0] for s in SHAPES]
# partial last A tile and c chunk in both modes (nA and nc not multiples of
# ta and kc), an odd D, and a c of 40 (two column blocks in step 3)
RAGGED = [("item_ragged", (40, 2, 13, 2, 45, 2, 4, 12), 300),
          ("a_tile_ragged", (20, 3, 11, 3, 13, 3, 3, 7), 3),
          ("item_c40", (32, 8, 40, 8, 32, 8, 8, 40), 256)]
UNPLANNABLE = (64, 24, 64, 24, 64, 24, 24, 64)        # chi 64, D 24

# The plans the kernel's C rule (make_plan) gave the real bodies at these
# shapes on 132 SMs, keyed by (dims, items, element bytes): (mode, ta, kc,
# ldT, ldS, ldE, ld1, ld2, ldB, oS, oE, oT1, oB, szE, szB, box_off, ctas,
# smem_bytes).
_M, _W = (32, 8, 32, 8, 32, 8, 8, 32), (32, 8, 40, 8, 32, 8, 8, 40)
_S, _SW = (16, 4, 16, 4, 16, 4, 4, 16), (16, 4, 24, 4, 16, 4, 4, 24)
_SPLIT = (1, 8, 8, 68, 68, 68, 68, 68, 36, 2176, 6528, 10880, 15232, 2176,
          2304)
_FULL = (0, 32, 4, 260, 68, 36, 132, 260, 36, 8320, 12672, 14976, 23424,
         1152, 1152)
_SMALL = (1, 8, 8, 36, 16, 36, 68, 36, 16, 576, 832, 1984, 3136, 576, 512)
REAL_PLANS = {
    (_M, 32, 4): _SPLIT + (79360, 128, 79776),
    (_M, 32, 8): _SPLIT + (158720, 128, 159136),
    (_W, 32, 4): (1, 8, 8, 68, 68, 68, 68, 68, 40, 2176, 6528, 10880, 15232,
                  2176, 2560, 81408, 128, 81824),
    (_W, 32, 8): (1, 8, 8, 68, 68, 68, 68, 68, 40, 2176, 6528, 10880, 15232,
                  2176, 2560, 162816, 128, 163232),
    (_M, 64, 4): _SPLIT + (79360, 256, 79776),
    (_M, 64, 8): _SPLIT + (158720, 256, 159136),
    (_M, 192, 4): _SPLIT + (79360, 768, 79776),
    (_M, 192, 8): _SPLIT + (158720, 768, 159136),
    (_M, 256, 4): _FULL + (102912, 256, 103328),
    (_M, 256, 8): _FULL + (205824, 256, 206240),
    (_M, 448, 4): _FULL + (102912, 448, 103328),
    (_M, 448, 8): _FULL + (205824, 448, 206240),
    (_M, 2048, 4): _FULL + (102912, 2048, 103328),
    (_M, 2048, 8): _FULL + (205824, 2048, 206240),
    (_M, 3584, 4): _FULL + (102912, 3584, 103328),
    (_M, 3584, 8): _FULL + (205824, 3584, 206240),
    (_SW, 8, 4): (1, 8, 8, 36, 16, 36, 68, 36, 24, 576, 832, 1984, 3136, 576,
                  768, 18688, 16, 19104),
    (_SW, 8, 8): (1, 8, 8, 36, 16, 36, 68, 36, 24, 576, 832, 1984, 3136, 576,
                  768, 37376, 16, 37792),
    **{(_S, items, 4): _SMALL + (16640, 2 * items, 17056)
       for items in (8, 16, 32, 48, 128, 192)},
    **{(_S, items, 8): _SMALL + (33280, 2 * items, 33696)
       for items in (8, 16, 32, 48, 128, 192)},
}
REAL_KEYS = ("mode", "ta", "kc", "ldT", "ldS", "ldE", "ld1", "ld2", "ldB",
             "oS", "oE", "oT1", "oB", "szE", "szB", "box_off", "ctas",
             "smem_bytes")


def _plan(dims, dtype, items):
    return k1.col_transfer_launch_plan(dims, dtype, items, SMS)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name,dims,items", SHAPES, ids=SHAPE_IDS)
def test_real_plans_are_unchanged(name, dims, items, dtype):
    plan = _plan(dims, dtype, items)
    got = tuple(k1.MODES.index(plan[k]) if k == "mode" else plan[k]
                for k in REAL_KEYS)
    assert got == REAL_PLANS[(dims, items, k1.ITEM[dtype])]
    assert plan["oT"] == 0 and plan["oT2"] == plan["oT1"]
    assert plan["oTab"] == plan["box_off"]       # no tables


def _regions(plan, dims, dtype):
    """(offset, size) of each shared-memory region in elements, as the
    kernel's check_plan counts them."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    kq = KQ.get(dtype, 1)

    def kp(x):
        return -(-x // kq) * kq

    t1 = kp(nu * nl) * plan["ld1"]
    t2 = kp(plan["kc"] * nd) * plan["ld2"]
    shared = plan["oT2"] == plan["oT1"]
    return [(plan["oT"], kp(na) * plan["ldT"]),
            (plan["oS"], kp(nu * nl) * plan["ldS"]),
            (plan["oE"], 2 * plan["szE"]),
            (plan["oT1"], max(t1, t2) if shared else t1),
            (plan["oT2"], 0 if shared else t2),
            (plan["oB"], 2 * plan["szB"])]


def _check(plan, dims, dtype):
    """The kernel's check_plan for the complex bodies, in Python."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    ta, kc = plan["ta"], plan["kc"]
    item = k1.ITEM[dtype]
    w = 16 // item
    c64 = dtype == C64
    m1, n1, m2, n2, m3 = nu * ta, nl * kc, kc * ta, nd * nr, ta * nr

    def up(x, m):
        return -(-x // m) * m

    need = ((up(m1, 16), up(n2, 32), up(n1, 32), up(m2, 16), up(m3, 16),
             up(nC, 32)) if c64 else
            (up(m1, 16), up(n2, 8), up(n1, 8), up(m2, 16), up(m3, 32),
             up(nC, 16)))
    lds = tuple(plan[k] for k in ("ldT", "ldS", "ldE", "ld1", "ld2", "ldB"))
    assert all(ld >= n and ld % w == 0 for ld, n in zip(lds, need))
    kq = KQ[dtype]
    if plan["oT2"] == plan["oT1"]:
        assert (nu * nl) % kq == 0 and (kc * nd) % kq == 0
    regions = _regions(plan, dims, dtype)
    for i, (o, n) in enumerate(regions):
        assert o % w == 0
        for o2, n2_ in regions[:i]:
            assert n == 0 or n2_ == 0 or o + n <= o2 or o2 + n2_ <= o
    end = max(o + n for o, n in regions)
    tab = m1 + n1 + m2 + n2
    assert plan["oTab"] % 16 == 0 and plan["oTab"] >= end * item
    assert plan["oTab"] + 4 * tab <= plan["box_off"]
    assert plan["box_off"] % 16 == 0
    assert plan["smem_bytes"] == plan["box_off"] + 4 * k1.BOX_BYTES
    assert plan["smem_bytes"] <= SMEM_PER_BLOCK
    # the tiles a warp holds: complex64 blocks of 16 x 32 (two in steps 2
    # and 3); complex128 MMA tiles of 16 x 8 (two in step 2) and one warp
    # tile of 32 x 16 in step 3
    if c64:
        assert -(-m2 // 16) * -(-n2 // 32) <= 2 * k1.WARPS
        assert -(-m3 // 16) * -(-nC // 32) <= 2 * k1.WARPS
    else:
        assert -(-m2 // 16) * -(-n2 // 8) <= 2 * k1.WARPS
        assert -(-m3 // 32) * -(-nC // 16) <= k1.WARPS


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("name,dims,items", SHAPES + RAGGED,
                         ids=SHAPE_IDS + [r[0] for r in RAGGED])
def test_complex_plan_fits_shared_memory_and_registers(name, dims, items,
                                                        dtype):
    plan = _plan(dims, dtype, items)
    _check(plan, dims, dtype)
    assert plan["body"] == ("simt_cx4x4_c64" if dtype == C64
                            else "zmma_m16n8k8_c128")
    mode = "item" if items >= k1.item_cta_threshold(SMS) else "a_tile"
    assert plan["mode"] == mode
    assert plan["ctas"] == items * (1 if mode == "item"
                                    else plan["a_tiles"])


@pytest.mark.parametrize("dtype", [C64, C128])
def test_complex_main_path_tiles(dtype):
    """The pair traces take the whole-item plan at the largest tiles; a
    32-item call (the bond step's chains) the A-tile plan, 128 CTAs."""
    name, dims, items = MAIN_SHAPES[6]
    assert name == "nn_traces"
    big = _plan(dims, dtype, items)
    assert (big["mode"], big["ta"], big["kc"]) == \
        (("item", 32, 4) if dtype == C64 else ("item", 16, 2))
    small = _plan(MAIN_SHAPES[0][1], dtype, 32)
    assert (small["mode"], small["ta"], small["ctas"]) == ("a_tile", 8, 128)
    assert small["kc"] == (8 if dtype == C64 else 4)


def _tile_cells(plan, dims, dtype, warp, lane, step):
    """The (m, n) cells a lane writes of step 2's product (held tiles) or
    step 3's output tile, as the kernel maps them."""
    nd, nr, nC = dims[5], dims[6], dims[7]
    ta, kc = plan["ta"], plan["kc"]
    m, n = (kc * ta, nd * nr) if step == 2 else (ta * nr, nC)
    cells = []
    if dtype == C64:
        n_sm = -(-m // 16)
        total = n_sm * -(-n // 32)
        for t in range(2):
            s = warp + t * k1.WARPS
            m0 = (s % n_sm) * 16 + (lane & 3) * 4
            n0 = (s // n_sm) * 32 + (lane >> 2) * 4
            if s < total and m0 < m and n0 < n:
                cells += [(m0 + i, n0 + j) for i in range(4)
                          for j in range(4)]
    elif step == 2:
        n_m = -(-m // 16)
        for t in range(2):
            s = warp + t * k1.WARPS
            if s < n_m * -(-n // 8):
                cells += [((s % n_m) * 16 + (lane >> 2) + 8 * (v >> 1),
                           (s // n_m) * 8 + 2 * (lane & 3) + (v & 1))
                          for v in range(4)]
    else:
        n_m = -(-m // 32)
        if warp < n_m * -(-n // 16):
            m0, n0 = (warp % n_m) * 32, (warp // n_m) * 16
            cells += [(m0 + 16 * i + (lane >> 2) + 8 * (v >> 1),
                       n0 + 8 * j + 2 * (lane & 3) + (v & 1))
                      for i in range(2) for j in range(2) for v in range(4)]
    return [(a, b) for a, b in cells if a < m and b < n]


@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("name,dims,items",
                         [s for s in SHAPES if s[0] in (
                             "main_nn_traces", "main_bond_step",
                             "main_sketch_w_step", "small_nn_traces")]
                         + RAGGED,
                         ids=["main_nn_traces", "main_bond_step",
                              "main_sketch_w_step", "small_nn_traces"]
                         + [r[0] for r in RAGGED])
def test_complex_tiles_cover_every_output_once(name, dims, items, dtype):
    """Step 3's tiles over the A tiles write out[A, r, C] exactly once
    (rows A' past the last valid A dropped); the c chunks cover c exactly
    once (a partial last chunk zero-filled); step 2's held tiles and the
    offset tables write every T2 value of (c', A', d, r) once."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    plan = _plan(dims, dtype, items)
    ta, kc = plan["ta"], plan["kc"]
    count = np.zeros((nA, nr, nC), dtype=int)
    for a0 in range(0, nA, ta):
        va = min(ta, nA - a0)
        for warp in range(k1.WARPS):
            for lane in range(32):
                for m, c in _tile_cells(plan, dims, dtype, warp, lane, 3):
                    if m % ta < va:
                        count[a0 + m % ta, m // ta, c] += 1
    assert (count == 1).all()
    chunks = [c0 + c for c0 in range(0, nc, kc) for c in range(kc)
              if c0 + c < nc]
    assert sorted(chunks) == list(range(nc))
    assert -(-nc // kc) == plan["c_chunks"]
    # step 2: P2[(c',A')][(d,r)] -> T2[d*kc + c'][r*ta + A'] through the
    # tables, every position once
    ld2 = plan["ld2"]
    seen = {}
    for warp in range(k1.WARPS):
        for lane in range(32):
            for m, n in _tile_cells(plan, dims, dtype, warp, lane, 2):
                pos = ((m // ta) * ld2 + m % ta) + \
                    ((n // nr) * kc * ld2 + (n % nr) * ta)
                seen[pos] = seen.get(pos, 0) + 1
    assert len(seen) == kc * ta * nd * nr and set(seen.values()) == {1}


def _bank_groups(chunks):
    """Wavefronts of one quarter-warp's 16-byte accesses: the most distinct
    16-byte chunks that share one of the 8 bank groups."""
    groups = {}
    for c in set(chunks):
        groups.setdefault(c % 8, set()).add(c)
    return max(len(v) for v in groups.values())


def _main_plans(dtype):
    """The whole-item plan (the pair traces) and the A-tile plan (the bond
    step) at the main path's shapes."""
    return [_plan(MAIN_SHAPES[6][1], dtype, MAIN_SHAPES[6][2]),
            _plan(MAIN_SHAPES[3][1], dtype, MAIN_SHAPES[3][2])]


@pytest.mark.parametrize("which", [0, 1], ids=["item", "a_tile"])
def test_complex64_fragment_loads_are_conflict_free(which):
    """A lane loads 4 complex values (32 bytes, two 16-byte loads) of X at
    column m0 + 4 (lane & 3) and of Y at n0 + 4 (lane >> 2), all lanes in
    one row: each quarter-warp reads 4 and 2 chunks a load, one a bank
    group, at every leading dim and row."""
    plan = _main_plans(C64)[which]
    for key in ("ldT", "ldS", "ldE", "ld1", "ld2", "ldB"):
        ld = plan[key]
        assert ld % 2 == 0               # 16-byte aligned fragments
        for k in range(4):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                for half in (0, 1):
                    for col in (lambda l: 4 * (l & 3), lambda l: 4 * (l >> 2)):
                        chunks = [(k * ld + col(l)) // 2 + half for l in lanes]
                        assert _bank_groups(chunks) == 1


@pytest.mark.parametrize("which", [0, 1], ids=["item", "a_tile"])
@pytest.mark.parametrize("step", [1, 2])
def test_complex64_pair_stores_are_conflict_free(which, step):
    """Steps 1 and 2 store each 4 x 4 tile as 8 pairs (16 bytes) along the
    destination's contiguous A': step 1 (Ts^T E) P1[(u,A')][(l,c')] ->
    T1[l*nu + u][c'*ta + A'], step 2 P2[(c',A')][(d,r)] -> T2[d*kc + c']
    [r*ta + A']; the lanes with bit 2 set store their two pairs in the
    other order. Every quarter-warp's store lands on 8 distinct bank
    groups, in every warp block."""
    plan = _main_plans(C64)[which]
    na, nl, nc, nu, nA, nd, nr, nC = MAIN_SHAPES[0][1]
    ta, kc = plan["ta"], plan["kc"]
    if step == 1:
        ld, m_, n_ = plan["ld1"], nu * ta, nl * kc

        def ro(m):
            return (m // ta) * ld + m % ta

        def co(n):
            return (n // kc) * nu * ld + (n % kc) * ta
    else:
        ld, m_, n_ = plan["ld2"], kc * ta, nd * nr

        def ro(m):
            return (m // ta) * ld + m % ta

        def co(n):
            return (n // nr) * kc * ld + (n % nr) * ta
    n_sm = -(-m_ // 16)
    assert all(ro(m + 1) == ro(m) + 1 for m in range(0, m_, 2))   # A' pairs
    for s in range(n_sm * -(-n_ // 32)):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            for j in range(4):
                for h in (0, 2):
                    chunks = []
                    for lane in lanes:
                        m0 = (s % n_sm) * 16 + (lane & 3) * 4
                        n0 = (s // n_sm) * 32 + (lane >> 2) * 4
                        hh = 2 - h if lane & 4 else h
                        pos = ro(m0 + hh) + co(n0 + j)
                        assert pos % 2 == 0
                        chunks.append(pos // 2)
                    assert _bank_groups(chunks) == 1


@pytest.mark.parametrize("which", [0, 1], ids=["item", "a_tile"])
def test_complex128_fragment_loads_are_conflict_free(which):
    """complex128: lane l loads one element (16 bytes) at row l & 3 (+ 4)
    and column l >> 2 (+ 8, + 16, + 24) of its tile; with every leading dim
    2 mod 8 elements, each quarter-warp's 8 lanes hit 8 distinct bank
    groups."""
    plan = _main_plans(C128)[which]
    for key in ("ldT", "ldS", "ldE", "ld1", "ld2", "ldB"):
        ld = plan[key]
        assert ld % 8 == 2
        for k0 in (0, 4):
            for c0 in (0, 8, 16, 24):
                for quarter in range(4):
                    lanes = range(8 * quarter, 8 * quarter + 8)
                    chunks = [(k0 + (l & 3)) * ld + c0 + (l >> 2)
                              for l in lanes]
                    assert _bank_groups(chunks) == 1


@pytest.mark.parametrize("dtype", [F32, F64, C64, C128])
def test_unplannable_shape_is_refused(dtype):
    with pytest.raises(RuntimeError, match="no col_transfer plan"):
        _plan(UNPLANNABLE, dtype, 4)
    with pytest.raises(RuntimeError, match="no col_transfer plan"):
        _plan((70000, 2, 2, 2, 8, 2, 2, 2), dtype, 4)   # 16-bit copy digits


def test_plan_refuses_what_the_kernel_does_not_take():
    for dtype in (torch.int32, torch.bfloat16):
        with pytest.raises(TypeError, match="col_transfer takes"):
            _plan(MAIN_SHAPES[0][1], dtype, 4)
    with pytest.raises(ValueError, match="sizes"):
        _plan(MAIN_SHAPES[0][1][:-1] + (0,), F32, 4)
    with pytest.raises(ValueError, match="2\\^31"):
        _plan(MAIN_SHAPES[0][1], C64, 2 ** 31)


@pytest.mark.parametrize("dtype", [F32, C64, C128])
def test_launch_meta_carries_the_plan(dtype):
    """The meta: batch sizes, strides and sizes (the kernel's kMetaLen),
    then the plan's PLAN_KEYS values, the mode as 0 (item) or 1 (A tile);
    a CPU tensor's planned for the H100's SMs; cached per operand
    signature."""
    ops = (torch.zeros(3, 5, 2, 7, dtype=dtype),
           torch.zeros(3, 5, 2, 5, dtype=dtype),
           torch.zeros(2, 2, 2, 2, dtype=dtype),
           torch.zeros(7, 2, 7, dtype=dtype))
    batch, meta = k1.launch_meta(*ops)
    assert tuple(batch) == (3,) and isinstance(meta, ctypes.Array)
    n = k1.META_INTS
    assert n == 4 + 3 * 7 + 8 + 8
    dims = k1.k1_dims(*ops)
    plan = _plan(dims, dtype, 3)
    assert list(meta)[n - 8:n] == dims
    assert list(meta)[n:] == k1.plan_values(plan)
    assert list(meta)[n] == 1 and len(meta) == n + len(k1.PLAN_KEYS)
    assert k1.launch_meta(*ops)[1] is meta


def test_plan_of_operands_matches_the_rule():
    ops = (torch.zeros(300, 40, 2, 13, dtype=C64),
           torch.zeros(300, 40, 2, 45, dtype=C64),
           torch.zeros(2, 2, 2, 4, dtype=C64),
           torch.zeros(13, 2, 12, dtype=C64))
    assert k1.col_transfer_plan(*ops) == _plan(RAGGED[0][1], C64, 300)
