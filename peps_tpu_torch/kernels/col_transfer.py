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
tensor it launches the hand-written kernel (``csrc/col_transfer.cu``) or
raises; there is no fallback. float32 and float64 take the real bodies,
complex64 and complex128 a separate complex body, whose launch plan
(:func:`col_transfer_complex_plan`) is chosen here, in Python, and rides
in the meta after the sizes. The launch meta (sizes and strides, counted
in elements of the operands' dtype) is cached per operand signature
(:func:`launch_meta`).
"""
from __future__ import annotations

import ctypes
import math

import torch

MAX_BATCH = 4
# the C entry of each dtype the kernel takes
ENTRIES = {torch.float32: "col_transfer_f32", torch.float64: "col_transfer_f64",
           torch.complex64: "col_transfer_c64",
           torch.complex128: "col_transfer_c128"}
COMPLEX = (torch.complex64, torch.complex128)
THREADS = 256
SMEM_PER_BLOCK = 232448            # 227 KB a CTA may use
CX_OUT_PER_THREAD = 8              # the complex body's register tile
CX_A_TILE, CX_C_CHUNK = 8, 4       # the largest tiles its plan takes


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
    if env.dtype in COMPLEX and math.prod(batch) * dims[4] * dims[6] \
            * dims[7] > 0:       # the kernel launches: it reads a plan
        plan = col_transfer_complex_plan(dims, env.dtype, math.prod(batch))
        meta += [plan["ta"], plan["kc"], plan["smem_bytes"]]
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


def complex_smem_bytes(dims, ta, kc, item):
    """Shared bytes of the complex body at A tile ta and c chunk kc: site,
    the top tile, env and bot chunks, the two intermediates."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    return item * (nu * nl * nd * nr + na * nu * ta + na * nl * kc
                   + kc * nd * nC + nu * nl * kc * ta + kc * nd * nr * ta)


def col_transfer_complex_plan(dims, dtype, items=1):
    """The complex body's launch plan for sizes ``dims`` = (na, nl, nc, nu,
    nA, nd, nr, nC) of a complex ``dtype`` and ``items`` batch items: one
    CTA of 256 threads per (item, tile of ``ta`` values of A), c streamed in
    chunks of ``kc``. It takes the largest tiles (ta <= 8, kc <= 4) whose
    output tile fits the threads' registers (at most 8 values a thread) and
    whose shared memory (site, top tile, env and bot chunks, the two
    intermediates; elements of 8 or 16 bytes) fits 227 KB. Raises TypeError
    for a real dtype and RuntimeError when nothing fits."""
    if dtype not in COMPLEX:
        raise TypeError(f"the complex col_transfer body takes {COMPLEX}, "
                        f"got {dtype}")
    dims = tuple(int(x) for x in dims)
    na, nl, nc, nu, nA, nd, nr, nC = dims
    item = 8 if dtype == torch.complex64 else 16
    fit = shrink_to_fit(
        min(nA, CX_A_TILE), min(nc, CX_C_CHUNK),
        lambda ta: ta * nr * nC <= CX_OUT_PER_THREAD * THREADS,
        lambda ta, kc: complex_smem_bytes(dims, ta, kc, item))
    if fit is None:
        raise RuntimeError(
            f"no complex col_transfer plan fits {dtype} sizes {dims} in "
            f"{SMEM_PER_BLOCK} bytes of shared memory and "
            f"{CX_OUT_PER_THREAD} outputs a thread")
    ta, kc, smem = fit
    ctas = items * -(-nA // ta)
    if ctas >= 2 ** 31:
        raise ValueError(f"col_transfer grid of {ctas} CTAs exceeds 2^31 - 1")
    return {"body": "simt_complex", "ta": ta, "kc": kc, "smem_bytes": smem,
            "ctas": ctas, "a_tiles": -(-nA // ta),
            "outputs_per_thread": -(-(ta * nr * nC) // THREADS)}


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


def launch_meta(env, top, site, bot):
    """(batch shape, ctypes meta array) of a kernel call, cached per
    (shapes, strides, dtype, device) signature: a hit skips the checks, the
    broadcast and the meta rebuild."""
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


def col_transfer(env, top, site, bot):
    """K1 wrapper. CPU tensors: plain version. CUDA tensors: the kernel."""
    if env.device.type == "cpu":
        return col_transfer_plain(env, top, site, bot)
    if env.device.type != "cuda":
        raise RuntimeError(f"col_transfer runs on cpu or cuda, not "
                           f"{env.device}")
    from peps_tpu_torch.kernels._build import check, cuda_library
    batch, meta = launch_meta(env, top, site, bot)
    fn = getattr(cuda_library().lib, entry_name(env.dtype))
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


def col_transfer_plan(env, top, site, bot):
    """The launch plan the kernel takes for these operands (CUDA only; a
    diagnostic read of the launch's own plan rule, nothing depends on it):
    dict(mode "item" or "a_tile", a_tile, c_chunk, ctas, smem_bytes, sms,
    item_threshold: the batch size from which one CTA takes a whole item);
    for complex operands :func:`col_transfer_complex_plan`'s."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    batch, meta = launch_meta(env, top, site, bot)
    if env.dtype in COMPLEX:
        return col_transfer_complex_plan(k1_dims(env, top, site, bot),
                                         env.dtype, math.prod(batch))
    plan = (ctypes.c_int64 * 7)()
    with torch.cuda.device(env.device):
        check(cuda_library().lib.col_transfer_plan(meta, env.element_size(),
                                                   plan))
    return {"mode": "item" if plan[0] == 0 else "a_tile", "a_tile": plan[1],
            "c_chunk": plan[2], "ctas": plan[3], "smem_bytes": plan[4],
            "sms": plan[5], "item_threshold": plan[6]}


col_transfer.launches = 0


def col_transfer_right(renv, top, site, bot, transfer=col_transfer):
    """bmps._col_transfer_right through the left form on permuted views:
    out[a, l, c] = sum renv[A, r, C] top[a, u, A] site[u, l, d, r] bot[c, d, C]
    is the left transfer with top a<->A, site l<->r, bot c<->C."""
    return transfer(renv, top.transpose(-3, -1), site.transpose(-3, -1),
                    bot.transpose(-3, -1))
