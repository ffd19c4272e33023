"""K1: the BTen column transfer, and its plain PyTorch version.

    out[..., A, r, C] = sum_{a,l,c,u,d} env[..., a, l, c] top[..., a, u, A]
                                         site[..., u, l, d, r] bot[..., c, d, C]

This is ``peps_tpu/contraction/bmps.py:_col_transfer_left``; the right form
(``_col_transfer_right``) is the same transfer on permuted views, see
:func:`col_transfer_right`. The leading batch dimensions of the four
operands broadcast against each other (at most four of them after
broadcasting); a broadcast operand is read with batch stride 0, never
copied.

On a CPU tensor :func:`col_transfer` runs the plain version. On a CUDA
tensor it launches the hand-written kernel (``csrc/col_transfer.cu``: f32
and f64 register-tiled SIMT bodies, complex64 in 4 x 4 complex register
tiles on the FP32 cores, complex128 on ``mma.sync.m16n8k8.f64``, all in one
kernel template) or raises; there is no fallback.
:func:`col_transfer_launch_plan` is the kernel's launch plan for all four
dtypes, in Python so that the CPU tests can check it; it rides in the meta
after the sizes, and the kernel checks the plan it is given and refuses one
it cannot run. The launch meta (sizes and strides, counted in elements of
the operands' dtype, and the plan) is cached per operand signature
(:func:`launch_meta`).
"""
from __future__ import annotations

import ctypes
import math

import torch

MAX_BATCH = 4
# batch sizes, the four operands' strides and the 8 sizes (the kernel's
# kMetaLen); the plan follows
META_INTS = MAX_BATCH + 3 * (MAX_BATCH + 3) + (MAX_BATCH + 4) + 8
# the C entry of each dtype the kernel takes
ENTRIES = {torch.float32: "col_transfer_f32", torch.float64: "col_transfer_f64",
           torch.complex64: "col_transfer_c64",
           torch.complex128: "col_transfer_c128"}
COMPLEX = (torch.complex64, torch.complex128)
THREADS = 256
WARPS = THREADS // 32
SMEM_PER_BLOCK = 232448            # 227 KB a CTA may use
BOX_BYTES = 104                    # the kernel's Box: one copy's plan
H100_SMS = 132
MAX_EXTENT = 65535                 # its copies count each dim in 16 bits
# element bytes per dtype
ITEM = {torch.float32: 4, torch.float64: 8, torch.complex64: 8,
        torch.complex128: 16}
BODIES = {torch.float32: "simt_f32", torch.float64: "simt_f64",
          torch.complex64: "simt_cx4x4_c64",
          torch.complex128: "zmma_m16n8k8_c128"}
# the real bodies' thread tiles (TMk x TNk in step k, R3 step-3 tiles a
# thread) and largest A tile and c chunk, per mode (csrc Cfg)
REAL_CFG = {"item": {"TM1": 4, "TN1": 8, "TM2": 4, "TN2": 8, "TM3": 4,
                     "TN3": 8, "R3": 1, "TA": 32, "KC": 4},
            "a_tile": {"TM1": 2, "TN1": 8, "TM2": 4, "TN2": 4, "TM3": 2,
                       "TN3": 4, "R3": 2, "TA": 8, "KC": 8}}
# the complex bodies' largest (A tile, c chunk) per mode, and the step-2 and
# step-3 tiles a warp holds (csrc Body: complex64 blocks of 16 x 32;
# complex128 MMA tiles of 16 x 8, one step-3 warp tile of 32 x 16)
CX_TILES = {torch.complex64: {"item": (32, 4), "a_tile": (8, 8)},
            torch.complex128: {"item": (16, 2), "a_tile": (8, 4)}}
CX_HOLD = {torch.complex64: (2, 2), torch.complex128: (2, 1)}
# the plan values the kernel reads after the sizes, in its order (the mode
# first: 0 one CTA per item, 1 one CTA per A tile)
PLAN_KEYS = ("mode", "ta", "kc", "ldT", "ldS", "ldE", "ld1", "ld2", "ldB",
             "oT", "oS", "oE", "oT1", "oT2", "oB", "szE", "szB", "oTab",
             "box_off", "smem_bytes")
MODES = ("item", "a_tile")


def col_transfer_plain(env, top, site, bot):
    """The plain PyTorch version: the reference's three-einsum chain."""
    t = torch.einsum("...alc,...auA->...luAc", env, top)
    t = torch.einsum("...luAc,...uldr->...dArc", t, site)
    return torch.einsum("...dArc,...cdC->...ArC", t, bot)


def _merge_batch(shape, strides):
    """Drop size-1 batch dims and merge neighbours that are contiguous in
    every operand. shape: list of sizes; strides: one stride list per
    operand. Returns (shape, strides) with the same element addresses."""
    keep = [i for i, n in enumerate(shape) if n != 1]
    shape = [shape[i] for i in keep]
    strides = [[s[i] for i in keep] for s in strides]
    i = len(shape) - 1
    while i > 0:
        if all(s[i - 1] == s[i] * shape[i] for s in strides):
            shape[i - 1] *= shape[i]
            for s in strides:
                s[i - 1] = s[i]
                del s[i]
            del shape[i]
        i -= 1
    return shape, strides


def _meta(env, top, site, bot, batch):
    ops = [env.expand(*batch, *env.shape[-3:]),
           top.expand(*batch, *top.shape[-3:]),
           site.expand(*batch, *site.shape[-4:]),
           bot.expand(*batch, *bot.shape[-3:])]
    nb = len(batch)
    shape, bstrides = _merge_batch(list(batch),
                                   [list(o.stride()[:nb]) for o in ops])
    if len(shape) > MAX_BATCH:
        raise ValueError(f"col_transfer takes at most {MAX_BATCH} batch "
                         f"dimensions after merging, got shape {batch}")
    pad = MAX_BATCH - len(shape)
    meta = [1] * pad + shape
    for o, bs in zip(ops, bstrides):
        meta += [0] * pad + bs + list(o.stride()[nb:])
    dims = k1_dims(env, top, site, bot)
    meta += dims
    items = math.prod(batch)
    if items * dims[4] * dims[6] * dims[7] > 0:   # the kernel launches
        meta += plan_values(col_transfer_launch_plan(
            dims, env.dtype, items, sm_count(env.device)))
    return meta


def k1_dims(env, top, site, bot):
    """The transfer's sizes [na, nl, nc, nu, nA, nd, nr, nC]."""
    return [*env.shape[-3:], *top.shape[-2:], *site.shape[-2:],
            bot.shape[-1]]


def entry_name(dtype) -> str:
    """The kernel library's C entry for operands of ``dtype``; TypeError
    for a dtype the kernel does not take."""
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA col_transfer takes {list(ENTRIES)}, got "
                        f"{dtype}")
    return ENTRIES[dtype]


def shrink_to_fit(ta, kc, regs_ok, smem_of):
    """The complex bodies' tile rule: from the largest A tile ta and c chunk
    kc, halve ta while the output tile does not fit the registers
    (regs_ok(ta)), then kc, then ta, until smem_of(ta, kc) fits a CTA's
    shared memory. Returns (ta, kc, smem bytes), or None when nothing
    fits."""
    while True:
        smem = smem_of(ta, kc)
        if regs_ok(ta) and smem <= SMEM_PER_BLOCK:
            return ta, kc, smem
        if not regs_ok(ta) and ta > 1:
            ta = -(-ta // 2)
        elif kc > 1:
            kc = -(-kc // 2)
        elif ta > 1:
            ta = -(-ta // 2)
        else:
            return None


def _cdiv(x, m):
    return -(-x // m)


def _up(x, m):
    return _cdiv(x, m) * m


def _ld(need, mod, rem):
    """The least leading dim >= need that is rem modulo mod."""
    return need + (rem - need) % mod


def _tiles(m, tm, n, tn):
    """Thread tiles of an m x n product in tm x tn tiles, the lanes of a
    warp on an 8 x 4 block of them (the real bodies' tile_of)."""
    return _up(_cdiv(m, tm), 8) * _up(_cdiv(n, tn), 4)


def item_cta_threshold(sms):
    """The batch size from which one CTA takes a whole item: at least 1.5
    items per SM. At chi = 32 a whole-item CTA does the work of four A-tile
    CTAs in less than four times their time, so it wins once the items
    alone fill most of one wave of two CTAs per SM."""
    return (3 * sms + 1) // 2


def _regions(lay, sizes, w):
    """Lay the regions (name, elements) out in order, each offset a
    multiple of w elements; returns the end (elements)."""
    end = 0
    for key, n in sizes:
        lay[key] = end
        end = _up(end + n, w)
    return end


def _real_layout(dims, ta, kc, cfg, item):
    """The real bodies' layout: leading dims a multiple of 4 elements and
    not of 32 (16-byte rows whose starts a warp's stores spread over the
    banks), T2 over T1, no tables. fits: every step's tiles within the CTA
    and the shared bytes within 227 KB."""
    na, nl, nc, nu, nA, nd, nr, nC = dims

    def lead(x):
        ld = _up(x, 4)
        return ld + 4 if ld % 32 == 0 else ld

    lay = {"ta": ta, "kc": kc, "ldT": lead(nu * ta),
           "ldS": lead(_up(nd * nr, cfg["TN2"])), "ldE": lead(nl * kc),
           "ld1": lead(kc * ta), "ld2": lead(ta * nr),
           "ldB": lead(_up(nC, cfg["TN3"]))}
    lay["szE"] = na * lay["ldE"]
    lay["szB"] = kc * nd * lay["ldB"]
    end = _regions(lay, (("oT", na * lay["ldT"]),
                         ("oS", nl * nu * lay["ldS"]),
                         ("oE", 2 * lay["szE"]),
                         ("oT1", max(nl * nu * lay["ld1"],
                                     kc * nd * lay["ld2"])),
                         ("oB", 2 * lay["szB"])), 1)
    lay["oT2"] = lay["oT1"]
    lay["oTab"] = lay["box_off"] = _up(item * end, 16)
    lay["smem_bytes"] = lay["box_off"] + 4 * BOX_BYTES
    lay["fits"] = (_tiles(nl * kc, cfg["TM1"], nu * ta, cfg["TN1"]) <= THREADS
                   and _tiles(ta * kc, cfg["TM2"], nd * nr, cfg["TN2"])
                   <= THREADS
                   and _tiles(ta * nr, cfg["TM3"], nC, cfg["TN3"])
                   <= cfg["R3"] * THREADS
                   and lay["smem_bytes"] <= SMEM_PER_BLOCK)
    return lay


def _complex_lds(dims, ta, kc, dtype):
    """The complex bodies' leading dims (ldT, ldS, ldE, ld1, ld2, ldB) in
    elements: each covers the columns its product reads (step 1 as Ts^T E,
    step 2 T1^T Ss, step 3 T2^T B). complex64 reads X operands in warp
    blocks of 16 columns and Y operands in blocks of 32; a warp's fragment
    loads all lie in one row, so any even leading dim keeps them
    conflict-free and aligned, and T1's and T2's are 8 mod 16 elements: a
    quarter-warp's 16-byte stores into them, 4 rows of a block of 16 apart
    along (u, A') or (c', A'), then fill 8 distinct bank groups also where a
    block of 16 rows spans two u or c' (A tiles of 8). complex128 reads X in
    MMA tiles of 16, Y in tiles of 8, and T2 and bot in step 3's warp tile
    of 32 x 16; a leading dim of 2 mod 8 elements puts the 8 lanes of a
    quarter-warp's 16-byte fragment loads (row lane & 3, column lane >> 2)
    on 8 distinct bank groups."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    if dtype == torch.complex64:
        return (_up(nu * ta, 16), _up(nd * nr, 32), _up(nl * kc, 32),
                _ld(_up(kc * ta, 16), 16, 8), _ld(_up(ta * nr, 16), 16, 8),
                _up(nC, 32))
    need = (_up(nu * ta, 16), _up(nd * nr, 8), _up(nl * kc, 8),
            _up(kc * ta, 16), _up(ta * nr, 32), _up(nC, 16))
    return tuple(_ld(x, 8, 2) for x in need)


def _complex_step_tiles(dims, ta, kc, dtype):
    """(step 2's, step 3's) tiles as the kernel counts them: complex64,
    warp blocks of 16 x 32; complex128, MMA tiles of 16 x 8 in step 2 and
    warp tiles of 32 x 16 in step 3."""
    nd, nr, nC = dims[5], dims[6], dims[7]
    if dtype == torch.complex64:
        return (_cdiv(kc * ta, 16) * _cdiv(nd * nr, 32),
                _cdiv(ta * nr, 16) * _cdiv(nC, 32))
    return (_cdiv(kc * ta, 16) * _cdiv(nd * nr, 8),
            _cdiv(ta * nr, 32) * _cdiv(nC, 16))


def _complex_layout(dims, ta, kc, dtype):
    """The complex bodies' layout: K padded to 8 in complex128 (zeroed
    rows), T2 over T1 unless a padding row of one would lie under the
    other's values, then the offset tables of steps 1 and 2."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    item = ITEM[dtype]
    kq = 8 if dtype == torch.complex128 else 1
    w = 16 // item

    def kp(x):
        return _up(x, kq)

    lay = {"ta": ta, "kc": kc}
    lay.update(zip(("ldT", "ldS", "ldE", "ld1", "ld2", "ldB"),
                   _complex_lds(dims, ta, kc, dtype)))
    t1 = kp(nu * nl) * lay["ld1"]
    t2 = kp(kc * nd) * lay["ld2"]
    share = (nu * nl) % kq == 0 and (kc * nd) % kq == 0
    lay["szE"] = _up(kp(na) * lay["ldE"], w)
    lay["szB"] = _up(kp(kc * nd) * lay["ldB"], w)
    end = _regions(lay, (("oT", kp(na) * lay["ldT"]),
                         ("oS", kp(nu * nl) * lay["ldS"]),
                         ("oE", 2 * lay["szE"]),
                         ("oT1", max(t1, t2) if share else t1),
                         ("oT2", 0 if share else t2),
                         ("oB", 2 * lay["szB"])), w)
    if share:
        lay["oT2"] = lay["oT1"]
    tab = nu * ta + nl * kc + kc * ta + nd * nr
    lay["oTab"] = _up(end * item, 16)
    lay["box_off"] = _up(lay["oTab"] + 4 * tab, 16)
    lay["smem_bytes"] = lay["box_off"] + 4 * BOX_BYTES
    hold2, hold3 = CX_HOLD[dtype]
    step2, step3 = _complex_step_tiles(dims, ta, kc, dtype)
    lay["fits"] = (step2 <= WARPS * hold2 and step3 <= WARPS * hold3
                   and lay["smem_bytes"] <= SMEM_PER_BLOCK)
    lay["step3_fits"] = step3 <= WARPS * hold3
    return lay


def col_transfer_launch_plan(dims, dtype, items=1, sms=H100_SMS):
    """The kernel's launch plan for sizes ``dims`` = (na, nl, nc, nu, nA, nd,
    nr, nC) of ``dtype``, ``items`` batch items and a card of ``sms`` SMs
    (the H100's 132 by default). The mode: one CTA of 256 threads per item
    from item_cta_threshold(sms) items on, else one per (item, A tile).
    The real bodies (csrc Cfg) take the largest A tile (32 or 8, a multiple
    of 8, zero-filled past nA) and c chunk (4 or 8, a multiple of TM1) whose
    tiles and layout fit, halving the A tile first. The complex bodies take
    (32, 4) and (8, 8) in complex64, (16, 2) and (8, 4) in complex128,
    halving the A tile while step 3's tiles do not fit what a warp holds,
    then the c chunk, then the A tile (shrink_to_fit). Raises TypeError for
    a dtype the kernel does not take, ValueError for empty sizes or a grid
    past 2^31 - 1 CTAs, RuntimeError when nothing fits."""
    entry_name(dtype)
    dims = tuple(int(x) for x in dims)
    if len(dims) != 8 or min(dims) < 1:
        raise ValueError(f"col_transfer plan of sizes {dims}: needs 8 sizes "
                         ">= 1 (na, nl, nc, nu, nA, nd, nr, nC)")
    na, nl, nc, nu, nA, nd, nr, nC = dims
    mode = "item" if items >= item_cta_threshold(sms) else "a_tile"
    lay = None
    if max(dims) <= MAX_EXTENT and dtype in COMPLEX:
        ta0, kc0 = CX_TILES[dtype][mode]
        fit = shrink_to_fit(
            min(nA, ta0), min(nc, kc0),
            lambda ta: _complex_layout(dims, ta, 1, dtype)["step3_fits"],
            lambda ta, kc: (lambda lay: lay["smem_bytes"] if lay["fits"]
                            else SMEM_PER_BLOCK + 1)(
                _complex_layout(dims, ta, kc, dtype)))
        if fit is not None:
            lay = _complex_layout(dims, fit[0], fit[1], dtype)
    elif max(dims) <= MAX_EXTENT:
        cfg = REAL_CFG[mode]
        ta = _up(min(nA, cfg["TA"]), 8)
        kc = _up(min(nc, cfg["KC"]), cfg["TM1"])
        while True:
            lay = _real_layout(dims, ta, kc, cfg, ITEM[dtype])
            if lay["fits"]:
                break
            if ta > 8:
                ta = _up(ta // 2, 8)
            elif kc > cfg["TM1"]:
                kc = _up(kc // 2, cfg["TM1"])
            else:
                lay = None
                break
    if lay is None:
        raise RuntimeError(f"no col_transfer plan fits {dtype} sizes {dims} "
                           f"in {SMEM_PER_BLOCK} bytes of shared memory")
    a_tiles = _cdiv(nA, lay["ta"])
    ctas = items * (1 if mode == "item" else a_tiles)
    if ctas >= 2 ** 31:
        raise ValueError(f"col_transfer grid of {ctas} CTAs exceeds 2^31 - 1")
    return {**{k: v for k, v in lay.items() if k not in ("fits",
                                                         "step3_fits")},
            "mode": mode, "body": BODIES[dtype], "dtype": dtype,
            "dims": dims, "items": items, "a_tile": lay["ta"],
            "c_chunk": lay["kc"], "a_tiles": a_tiles,
            "c_chunks": _cdiv(nc, lay["kc"]), "ctas": ctas, "sms": sms,
            "item_threshold": item_cta_threshold(sms)}


def plan_values(plan):
    """The plan as the kernel reads it after the sizes (PLAN_KEYS)."""
    return [MODES.index(plan["mode"]), *(plan[k] for k in PLAN_KEYS[1:])]


def _check_operands(env, top, site, bot):
    ops = (env, top, site, bot)
    dt = env.dtype
    if any(o.dtype != dt for o in ops):
        raise TypeError("col_transfer operands must share one dtype, got "
                        f"{[o.dtype for o in ops]}")
    entry_name(dt)
    dev = env.device
    if any(o.device != dev for o in ops):
        raise ValueError("col_transfer operands lie on different devices")
    na, nl, nc = env.shape[-3:]
    nu, nd, nr = site.shape[-4], site.shape[-2], site.shape[-1]
    if (top.shape[-3] != na or top.shape[-2] != nu or site.shape[-3] != nl
            or bot.shape[-3] != nc or bot.shape[-2] != nd):
        raise ValueError(
            f"col_transfer shape mismatch: env {tuple(env.shape)}, top "
            f"{tuple(top.shape)}, site {tuple(site.shape)}, bot "
            f"{tuple(bot.shape)}")


_META_CACHE: dict = {}
_META_CACHE_MAX = 4096


def sm_count(device) -> int:
    """The SM count a launch on ``device`` is planned for: a CUDA device's
    own; the H100's for any other device (a CPU tensor's meta is read by
    the tests, never launched)."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_meta(env, top, site, bot):
    """(batch shape, ctypes meta array) of a kernel call, cached per
    (shapes, strides, dtype, device) signature: a hit skips the checks, the
    broadcast, the plan (for the device's SM count, :func:`sm_count`) and
    the meta rebuild."""
    key = tuple((o.shape, o.stride(), o.dtype, o.device)
                for o in (env, top, site, bot))
    hit = _META_CACHE.get(key)
    if hit is not None:
        return hit
    _check_operands(env, top, site, bot)
    batch = torch.broadcast_shapes(env.shape[:-3], top.shape[:-3],
                                   site.shape[:-4], bot.shape[:-3])
    meta = _meta(env, top, site, bot, batch)
    if len(_META_CACHE) >= _META_CACHE_MAX:
        _META_CACHE.clear()
    hit = _META_CACHE[key] = (batch, (ctypes.c_int64 * len(meta))(*meta))
    return hit


def _launch(env, top, site, bot):
    """One launch of the kernel on CUDA operands (no autograd)."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    name = entry_name(env.dtype)
    lib = cuda_library().lib     # raises before planning where CUDA is missing
    # a lazily conjugated or negated view holds other values than its data
    env, top, site, bot = (t.resolve_conj().resolve_neg()
                           for t in (env, top, site, bot))
    batch, meta = launch_meta(env, top, site, bot)
    fn = getattr(lib, name)
    out = torch.empty(*batch, top.shape[-1], site.shape[-1], bot.shape[-1],
                      dtype=env.dtype, device=env.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(env.device):
        check(fn(env.data_ptr(), top.data_ptr(), site.data_ptr(),
                 bot.data_ptr(), out.data_ptr(), meta,
                 torch.cuda.current_stream(env.device).cuda_stream))
    col_transfer.launches += 1
    return out


def col_transfer(env, top, site, bot):
    """K1 wrapper. CPU tensors: plain version. CUDA tensors: the kernel;
    where autograd records (an operand requires grad), through
    :class:`ColTransferFunction`, whose backward is one launch of K1's
    backward kernel (``kernels/col_transfer_backward.py``)."""
    if env.device.type == "cpu":
        return col_transfer_plain(env, top, site, bot)
    if env.device.type != "cuda":
        raise RuntimeError(f"col_transfer runs on cpu or cuda, not "
                           f"{env.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (env, top, site, bot)):
        return ColTransferFunction.apply(env, top, site, bot)
    return _launch(env, top, site, bot)


class ColTransferFunction(torch.autograd.Function):
    """K1 under autograd: forward = the kernel launch on CUDA tensors, the
    plain version on CPU tensors; backward =
    ``kernels.col_transfer_backward.col_transfer_backward`` (one launch of
    K1's backward kernel on CUDA tensors, the plain chain on CPU tensors),
    computing only the gradients autograd asks for."""

    @staticmethod
    def forward(ctx, env, top, site, bot):
        ctx.save_for_backward(env, top, site, bot)
        if env.device.type == "cpu":
            return col_transfer_plain(env, top, site, bot)
        return _launch(env, top, site, bot)

    @staticmethod
    def backward(ctx, g):
        from peps_tpu_torch.kernels.col_transfer_backward import \
            col_transfer_backward as backward
        env, top, site, bot = ctx.saved_tensors
        return backward(g, env, top, site, bot, ctx.needs_input_grad)


def col_transfer_plan(env, top, site, bot):
    """The launch plan the kernel takes for these operands on their device
    (:func:`col_transfer_launch_plan`; a diagnostic, nothing depends on
    it): mode ("item" or "a_tile"), a_tile, c_chunk, ctas, smem_bytes, sms,
    item_threshold, the layout and the body."""
    _check_operands(env, top, site, bot)
    batch = torch.broadcast_shapes(env.shape[:-3], top.shape[:-3],
                                   site.shape[:-4], bot.shape[:-3])
    return col_transfer_launch_plan(
        k1_dims(env, top, site, bot), env.dtype, math.prod(batch),
        sm_count(env.device))


def col_transfer_diagnostic(env, top, site, bot):
    """The plan a launch on these operands takes, with what the compiled
    kernel reaches at its shared bytes (CUDA only; nothing depends on it):
    regs_per_thread, spill_bytes (local memory a thread) and ctas_per_sm
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    plan = col_transfer_plan(env, top, site, bot)
    attrs = (ctypes.c_int64 * 3)()
    with torch.cuda.device(env.device):
        check(cuda_library().lib.col_transfer_attributes(
            list(ENTRIES).index(env.dtype), MODES.index(plan["mode"]),
            plan["smem_bytes"], attrs))
    keys = ("mode", "ta", "kc", "ctas", "smem_bytes", "body")
    return {**{k: plan[k] for k in keys}, "regs_per_thread": attrs[0],
            "spill_bytes": attrs[1], "ctas_per_sm": attrs[2]}


col_transfer.launches = 0


def col_transfer_right(renv, top, site, bot, transfer=col_transfer):
    """bmps._col_transfer_right through the left form on permuted views:
    out[a, l, c] = sum renv[A, r, C] top[a, u, A] site[u, l, d, r] bot[c, d, C]
    is the left transfer with top a<->A, site l<->r, bot c<->C."""
    return transfer(renv, top.transpose(-3, -1), site.transpose(-3, -1),
                    bot.transpose(-3, -1))
