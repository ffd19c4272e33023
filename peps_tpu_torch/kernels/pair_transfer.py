"""K3: the two-row (BTen2) column transfer, and its plain PyTorch version.

    out[..., A, r, f, C] = sum_{a,m,n,c,u,d,e} env[..., a, m, n, c]
        top[..., a, u, A] row1[..., u, m, d, r] row2[..., d, n, e, f]
        bot[..., c, e, C]

This is what ``peps_tpu/algorithm/energy.py:_pair_row_envs`` computes with
``bmps._col_transfer_left`` on a column-fused site (``_fuse_pair_columns``),
done as four products (env.top, .row1, .row2, .bot) without forming the
fused site. The right form is the same transfer on permuted views, see
:func:`pair_transfer_right`. The leading batch dimensions of the five
operands broadcast against each other (at most four of them after
merging); a broadcast operand is read with batch stride 0, never copied.

On a CPU tensor :func:`pair_transfer` runs the plain version. On a CUDA
tensor it launches the hand-written kernel (``csrc/pair_transfer.cu``: f64
on the DMMA tensor cores (m8n8k4), f32 on the FP32 CUDA cores at two CTAs
an SM, complex64 on the FP32 CUDA cores in 4 x 4 complex register tiles,
complex128 on the DMMA tensor cores (m16n8k8, four real MMAs a complex
tile product)) or raises;
there is no fallback. :func:`pair_transfer_plan` is the kernel's
launch plan, in Python so that the CPU tests can check it; the kernel
checks the plan it is given and refuses one it cannot run. The launch meta
(sizes, strides and plan) is cached per operand signature
(:func:`launch_meta`).
"""
from __future__ import annotations

import ctypes
import math

import torch

from peps_tpu_torch.kernels.col_transfer import (COMPLEX, MAX_BATCH, _cdiv,
                                                _ld, _merge_batch, _up,
                                                shrink_to_fit)

# trailing (non-batch) dims of env, top, row1, row2, bot
_NDIMS = (4, 3, 4, 4, 3)
DIM_NAMES = ("na", "nm", "nn", "nc", "nu", "nA", "nd", "nr", "ne", "nf",
             "nC")

THREADS = 256
WARPS = THREADS // 32
SMEM_PER_BLOCK = 232448            # 227 KB a CTA may use
SMEM_PER_SM = 233472               # 228 KB an SM holds
SMEM_RESERVED_PER_CTA = 1024       # the runtime's share of each CTA
SMEM_TWO_CTAS = SMEM_PER_SM // 2 - SMEM_RESERVED_PER_CTA
A_TILE, C_CHUNK = 4, 2             # the largest tiles the plan takes
CX_C_CHUNK = 4                     # ... and the complex bodies' c chunk
ENTRIES = {torch.float32: "pair_transfer_f32",
           torch.float64: "pair_transfer_f64",
           torch.complex64: "pair_transfer_c64",
           torch.complex128: "pair_transfer_c128"}
# per dtype: the body's short name, its element bytes, the multiple K is
# padded to, and the name the plan reports
BODIES = {torch.float32: ("f32", 4, 1, "simt_fma_f32"),
          torch.float64: ("f64", 8, 4, "dmma_m8n8k4_f64"),
          torch.complex64: ("c64", 8, 1, "simt_cx4x4_c64"),
          torch.complex128: ("c128", 16, 8, "zmma_m16n8k8_c128")}
META_INTS = MAX_BATCH + 3 * (MAX_BATCH + 4) + 2 * (MAX_BATCH + 3) + 11
# the kernel's plan fields, in the order it reads them after the meta
PLAN_KEYS = ("ta", "kc", "kl", "zn", "sw", "ldE", "ldT", "ldR1", "ldR2",
             "ld1", "ld2", "ld3", "ldB", "oR1", "oR2", "oT", "oE", "oB", "oX1",
             "oX2", "oX3", "szE", "szB", "oTab", "smem_bytes")


def pair_transfer_plain(env, top, row1, row2, bot):
    """The plain PyTorch version: env.top, then .row1 summing (u, m), .row2
    summing (d, n), .bot summing (c, e)."""
    t = torch.einsum("...amnc,...auA->...mncuA", env, top)
    t = torch.einsum("...mncuA,...umdr->...ncAdr", t, row1)
    t = torch.einsum("...ncAdr,...dnef->...cAref", t, row2)
    return torch.einsum("...cAref,...ceC->...ArfC", t, bot)


def _step4_fits(ta, nr, nf, nc_, body):
    """Whether step 4's output tile (ta nr nf x nC) fits the CTA as the
    kernel lays it out: f32, one 4 x 8 tile per thread (tile_of); f64, one
    32 x 32 tile per warp; complex64, one 4 x 4 tile per thread in warp
    blocks of 16 x 32; complex128, one 32 x 16 tile per warp."""
    m4 = ta * nr * nf
    if body == "f32":
        return _up(_cdiv(m4, 4), 8) * _up(_cdiv(nc_, 8), 4) <= THREADS
    rows, cols = {"f64": (32, 32), "c64": (16, 32), "c128": (32, 16)}[body]
    return _cdiv(m4, rows) * _cdiv(nc_, cols) <= WARPS


def _complex_lds(dims, ta, kc, body):
    """The complex bodies' leading dims (ldE, ldT, ldR1, ldR2, ld1, ld2, ld3,
    ldB) in elements: each covers the columns its product reads. complex64
    reads X operands in warp blocks of 16 columns and Y operands in blocks
    of 32, step 1 as Ts^T E; any even leading dim keeps its 16-byte loads
    aligned, and T1's, T2's and T3's are 2 mod 32 elements, which at chi =
    32, D = 8 spreads the 16-byte scatter stores of steps 1-3 over twice
    as many bank groups as 0 mod 32. complex128 reads X in MMA tiles of 16
    and Y in tiles of 8 (32
    and 16 in step 4), step 3 as T2^T R2; a leading dim of 2 mod 8 elements
    (32 mod 128 bytes, as f64's 4 mod 16 doubles) puts the 8 lanes of a
    quarter-warp's 16-byte fragment loads (row lane & 3, column lane >> 2)
    on 8 distinct bank groups."""
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    m1, n1, m2, n2 = nn * kc * nm, nu * ta, nn * kc * ta, nd * nr
    m3, n3, m4 = ne * nf, kc * ta * nr, ta * nr * nf
    if body == "c64":
        return (_up(m1, 32), _up(n1, 16), _up(n2, 32), _up(m3, 16),
                _ld(_up(m2, 16), 32, 2), _ld(_up(n3, 32), 32, 2),
                _ld(_up(m4, 16), 32, 2), _up(nC, 32))
    need = (_up(m1, 16), _up(n1, 8), _up(n2, 8), _up(m3, 8), _up(m2, 16),
            _up(n3, 16), _up(m4, 32), _up(nC, 16))
    return tuple(_ld(x, 8, 2) for x in need)


def _layout(dims, ta, kc, dtype):
    """Shared-memory layout for A tile ta and c chunk kc (elements, the
    table offset and total in bytes). env is copied after step 1 into one
    buffer, kl = 4 values of c at a time when kc = 2 (16 bytes a copy in
    f32, 32 in f64, serving two chunks; f32 also needs nm even, as step 1
    reads the c' pairs of two m), else kl = kc. In f32 its n blocks lie 4
    floats further apart than nm kl, so that step 1's two 8-byte loads hit
    distinct banks at D = 8; in f64 (nm a multiple of 4) step 1's rows are
    taken with bits 1 and 2 swapped (sw) and env's leading dim is 2 mod 16
    doubles, so that its fragment loads do. f64: every other leading
    dim is 4 mod 16 doubles, so the DMMA fragment loads (row lane >> 2, k
    lane & 3) hit 32 distinct banks, and K is padded to 4. f32: T1's and
    T2's leading dims are 4 mod 8 floats and T3's 8 mod 32: at chi = 32,
    D = 8 every quarter-warp's 16-byte store in steps 1-3 then lands on 8
    distinct bank groups. The complex bodies copy env one chunk at a time
    in step 1's row order (kl = kc, no swap), pad K to 8 in complex128, and
    take their leading dims from :func:`_complex_lds`."""
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    body, item, kq, _ = BODIES[dtype]
    w = 16 // item
    mma = body == "f64"
    if body in ("c64", "c128"):
        kl, zn, sw = kc, nm * kc, 0
    else:
        kl = 4 if kc == 2 and (mma or nm % 2 == 0) else kc
        zn = nm * kl + (4 if kl != kc and not mma else 0)
        sw = int(mma and kl != kc and nm % 4 == 0)

    def kp(x):
        return _up(x, kq)

    def wx(x):                  # columns a product reads of its X operand
        return _up(x, 32 if mma else 4)

    def wy(x, last=False):      # ... and of its Y operand
        return _up(x, (32 if last else 16) if mma else (8 if last else 4))

    def lead(need, mod=16, rem=4):
        return _ld(need, 16, 4) if mma else _ld(need, mod, rem)

    lay = {"ta": ta, "kc": kc, "kl": kl, "zn": zn, "sw": sw}
    if body in ("c64", "c128"):
        lay.update(zip(("ldE", "ldT", "ldR1", "ldR2", "ld1", "ld2", "ld3",
                        "ldB"), _complex_lds(dims, ta, kc, body)))
    else:
        need_e = _cdiv(wx(nn * kc * nm) // kc, nm) * zn
        lay.update({"ldE": _ld(need_e, 16, 2) if sw else lead(need_e, 4, 0),
                    "ldT": lead(wy(nu * ta), 4, 0),
                    "ldR1": lead(wy(nd * nr), 4, 0),
                    "ldR2": lead(wx(ne * nf), 4, 0),
                    "ld1": lead(wx(nn * kc * ta), 8, 4),
                    "ld2": lead((wx if mma else wy)(kc * ta * nr), 8, 4),
                    "ld3": lead(wx(ta * nr * nf), 32, 8),
                    "ldB": lead(wy(nC, last=True), 4, 0)})
    x1 = kp(nu * nm) * lay["ld1"]
    x3 = kp(kc * ne) * lay["ld3"]
    share13 = kq == 1 or ((nu * nm) % kq == 0 and (kc * ne) % kq == 0)
    lay["szE"] = _up(kp(na) * lay["ldE"], w)
    lay["szB"] = _up(kp(kc * ne) * lay["ldB"], w)
    sizes = (("oR1", kp(nu * nm) * lay["ldR1"]),
             ("oR2", kp(nd * nn) * lay["ldR2"]),
             ("oT", kp(na) * lay["ldT"]),
             ("oE", lay["szE"]),
             ("oB", 2 * lay["szB"]),
             ("oX1", max(x1, x3) if share13 else x1),
             ("oX2", kp(nd * nn) * lay["ld2"]),
             ("oX3", 0 if share13 else x3))
    end = 0
    for key, n in sizes:
        lay[key] = end
        end = _up(end + n, w)
    if share13:
        lay["oX3"] = lay["oX1"]
    tab = (nn * kc * nm + nu * ta + nn * kc * ta + nd * nr + ne * nf
           + kc * ta * nr)
    lay["oTab"] = _up(end * item, 16)
    lay["smem_bytes"] = _up(lay["oTab"] + 4 * tab, 16)
    lay["t3_shares_t1"] = share13
    return lay


def pair_transfer_plan(dims, dtype, items=1):
    """The kernel's launch plan for sizes ``dims`` = (na, nm, nn, nc, nu,
    nA, nd, nr, ne, nf, nC) of ``dtype`` and ``items`` batch items: one CTA
    of 256 threads per (item, tile of ``ta`` values of A), env and bot
    streamed in chunks of ``kc`` values of c. It takes the largest tiles
    (ta <= 4, kc <= 2) whose layout fits; f32 first within two CTAs an SM
    (``SMEM_TWO_CTAS``), then within one. Raises TypeError for a dtype the
    kernel does not take, ValueError for empty sizes and RuntimeError when
    no plan fits shared memory. ``smem_ctas_per_sm`` is what shared memory
    allows (the card-side diagnostic reports what the compiled kernel
    reaches). A complex dtype takes the complex bodies' plan
    (:func:`_complex_plan`)."""
    entry_name(dtype)
    dims = tuple(int(x) for x in dims)
    if len(dims) != len(DIM_NAMES) or min(dims) < 1:
        raise ValueError(f"pair_transfer plan of sizes {dims}: needs "
                         f"{len(DIM_NAMES)} sizes >= 1 {DIM_NAMES}")
    if dtype in COMPLEX:
        return _complex_plan(dims, dtype, items)
    body = BODIES[dtype][0]
    mma = body == "f64"
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    budgets = (SMEM_PER_BLOCK,) if mma else (SMEM_TWO_CTAS, SMEM_PER_BLOCK)
    for budget in budgets:
        ta, kc = min(nA, A_TILE), min(nc, C_CHUNK)
        while True:
            fits = _step4_fits(ta, nr, nf, nC, body)
            lay = _layout(dims, ta, kc, dtype)
            if fits and lay["smem_bytes"] <= budget:
                return _finish(lay, dims, dtype, items)
            if not fits and ta > 1:
                ta = _cdiv(ta, 2)
            elif kc > 1:
                kc = _cdiv(kc, 2)
            elif ta > 1:
                ta = _cdiv(ta, 2)
            else:
                break
    raise RuntimeError(f"no pair_transfer plan fits {dtype} sizes "
                       f"{dict(zip(DIM_NAMES, dims))} in "
                       f"{SMEM_PER_BLOCK} bytes of shared memory")


def entry_name(dtype) -> str:
    """The kernel library's C entry for operands of ``dtype``; TypeError
    for a dtype the kernel does not take."""
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA pair_transfer takes {list(ENTRIES)}, got "
                        f"{dtype}")
    return ENTRIES[dtype]


def _complex_plan(dims, dtype, items):
    """The complex bodies' plan: the largest A tile (ta <= 4) whose step 4
    tile fits the CTA, then the largest c chunk (kc <= 4) whose layout fits
    227 KB (one CTA an SM), halving ta last (col_transfer.shrink_to_fit).
    RuntimeError when none fits."""
    na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC = dims
    body = BODIES[dtype][0]
    fit = shrink_to_fit(
        min(nA, A_TILE), min(nc, CX_C_CHUNK),
        lambda ta: _step4_fits(ta, nr, nf, nC, body),
        lambda ta, kc: _layout(dims, ta, kc, dtype)["smem_bytes"])
    if fit is None:
        raise RuntimeError(f"no pair_transfer plan fits {dtype} sizes "
                           f"{dict(zip(DIM_NAMES, dims))} in "
                           f"{SMEM_PER_BLOCK} bytes of shared memory")
    ta, kc, _ = fit
    return _finish(_layout(dims, ta, kc, dtype), dims, dtype, items)


def _finish(lay, dims, dtype, items):
    nA, nc = dims[5], dims[3]
    a_tiles = _cdiv(nA, lay["ta"])
    ctas = items * a_tiles
    if ctas >= 2 ** 31:
        raise ValueError(f"pair_transfer grid of {ctas} CTAs exceeds "
                         f"2^31 - 1")
    smem_ctas = SMEM_PER_SM // (lay["smem_bytes"] + SMEM_RESERVED_PER_CTA)
    return {**lay, "dtype": dtype, "dims": dims, "items": items,
            "body": BODIES[dtype][3], "a_tiles": a_tiles,
            "c_chunks": _cdiv(nc, lay["kc"]), "ctas": ctas,
            "smem_ctas_per_sm": min(smem_ctas,
                                    2 if dtype == torch.float32 else 1)}


def _meta(ops, batch):
    nb = len(batch)
    full = [o.expand(*batch, *o.shape[o.dim() - k:])
            for o, k in zip(ops, _NDIMS)]
    shape, bstrides = _merge_batch(list(batch),
                                   [list(o.stride()[:nb]) for o in full])
    if len(shape) > MAX_BATCH:
        raise ValueError(f"pair_transfer takes at most {MAX_BATCH} batch "
                         f"dimensions after merging, got shape {batch}")
    pad = MAX_BATCH - len(shape)
    meta = [1] * pad + shape
    for o, bs in zip(full, bstrides):
        meta += [0] * pad + bs + list(o.stride()[nb:])
    dims = pair_dims(*ops)
    meta += list(dims)
    items = math.prod(batch)
    if items * dims[5] * dims[7] * dims[9] * dims[10] > 0:
        plan = pair_transfer_plan(dims, ops[0].dtype, items)
        meta += [plan[k] for k in PLAN_KEYS]
    return meta


def pair_dims(env, top, row1, row2, bot):
    """The transfer's sizes (na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC)."""
    na, nm, nn, nc = env.shape[-4:]
    nu, nA = top.shape[-2:]
    nd, nr = row1.shape[-2:]
    ne, nf = row2.shape[-2:]
    return (na, nm, nn, nc, nu, nA, nd, nr, ne, nf, bot.shape[-1])


def _check_operands(ops):
    env, top, row1, row2, bot = ops
    dt = env.dtype
    if any(o.dtype != dt for o in ops):
        raise TypeError("pair_transfer operands must share one dtype, got "
                        f"{[o.dtype for o in ops]}")
    entry_name(dt)
    if any(o.device != env.device for o in ops):
        raise ValueError("pair_transfer operands lie on different devices")
    if any(o.dim() < k for o, k in zip(ops, _NDIMS)):
        raise ValueError("pair_transfer operands lack their own dims")
    na, nm, nn, nc = env.shape[-4:]
    u1, m1, d1 = row1.shape[-4:-1]
    d2, n2, e2 = row2.shape[-4:-1]
    if (top.shape[-3] != na or top.shape[-2] != u1 or m1 != nm or n2 != nn
            or d2 != d1 or bot.shape[-3] != nc or bot.shape[-2] != e2):
        raise ValueError(
            "pair_transfer shape mismatch: "
            + ", ".join(f"{k} {tuple(o.shape)}" for k, o in zip(
                ("env", "top", "row1", "row2", "bot"), ops)))


_META_CACHE: dict = {}
_META_CACHE_MAX = 4096


def launch_meta(env, top, row1, row2, bot):
    """(batch shape, ctypes meta array) of a kernel call, cached per
    (shapes, strides, dtype, device) signature: a hit skips the checks, the
    broadcast, the plan and the meta rebuild. The meta is the batch sizes,
    the strides and the sizes (META_INTS values), then the plan's PLAN_KEYS
    values; an empty output has no plan and is never launched."""
    ops = (env, top, row1, row2, bot)
    key = tuple((o.shape, o.stride(), o.dtype, o.device) for o in ops)
    hit = _META_CACHE.get(key)
    if hit is not None:
        return hit
    _check_operands(ops)
    batch = torch.broadcast_shapes(*(o.shape[:o.dim() - k]
                                     for o, k in zip(ops, _NDIMS)))
    meta = _meta(ops, batch)
    if len(_META_CACHE) >= _META_CACHE_MAX:
        _META_CACHE.clear()
    hit = _META_CACHE[key] = (batch, (ctypes.c_int64 * len(meta))(*meta))
    return hit


def pair_transfer(env, top, row1, row2, bot):
    """K3 wrapper. CPU tensors: plain version. CUDA tensors: the kernel."""
    if env.device.type == "cpu":
        return pair_transfer_plain(env, top, row1, row2, bot)
    if env.device.type != "cuda":
        raise RuntimeError(f"pair_transfer runs on cpu or cuda, not "
                           f"{env.device}")
    from peps_tpu_torch.kernels._build import check, cuda_library
    # a lazily conjugated or negated view holds other values than its data
    env, top, row1, row2, bot = (t.resolve_conj().resolve_neg()
                                 for t in (env, top, row1, row2, bot))
    batch, meta = launch_meta(env, top, row1, row2, bot)
    fn = getattr(cuda_library().lib, entry_name(env.dtype))
    out = torch.empty(*batch, top.shape[-1], row1.shape[-1], row2.shape[-1],
                      bot.shape[-1], dtype=env.dtype, device=env.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(env.device):
        check(fn(env.data_ptr(), top.data_ptr(), row1.data_ptr(),
                 row2.data_ptr(), bot.data_ptr(), out.data_ptr(), meta,
                 torch.cuda.current_stream(env.device).cuda_stream))
    pair_transfer.launches += 1
    return out


pair_transfer.launches = 0


def pair_transfer_diagnostic(env, top, row1, row2, bot):
    """The plan a launch on these operands takes, with what the compiled
    kernel reaches at its shared bytes (CUDA only; nothing depends on it):
    regs_per_thread, spill_bytes (local memory a thread) and ctas_per_sm
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    batch, _ = launch_meta(env, top, row1, row2, bot)
    plan = pair_transfer_plan(pair_dims(env, top, row1, row2, bot),
                              env.dtype, math.prod(batch))
    attrs = (ctypes.c_int64 * 3)()
    lib = cuda_library().lib
    read = lib.pair_transfer_cx_attributes if env.dtype in COMPLEX \
        else lib.pair_transfer_attributes
    with torch.cuda.device(env.device):
        check(read(env.element_size(), plan["smem_bytes"], attrs))
    keys = ("ta", "kc", "ctas", "smem_bytes", "body", "smem_ctas_per_sm")
    return {**{k: plan[k] for k in keys}, "regs_per_thread": attrs[0],
            "spill_bytes": attrs[1], "ctas_per_sm": attrs[2]}


def pair_transfer_right(renv, top, row1, row2, bot, transfer=pair_transfer):
    """The right two-row transfer through the left form on permuted views:
    out[a, m, n, c] = sum renv[A, r, f, C] top[a, u, A] row1[u, m, d, r]
    row2[d, n, e, f] bot[c, e, C] is the left transfer with top a<->A,
    row1 m<->r, row2 n<->f and bot c<->C."""
    return transfer(renv, top.transpose(-3, -1), row1.transpose(-3, -1),
                    row2.transpose(-3, -1), bot.transpose(-3, -1))
