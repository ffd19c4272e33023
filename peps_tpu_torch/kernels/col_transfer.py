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
raises; there is no fallback. The launch meta (sizes and strides) is cached
per operand signature (:func:`launch_meta`).
"""
from __future__ import annotations

import ctypes

import torch

MAX_BATCH = 4


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
    na, nl, nc = env.shape[-3:]
    nu, nA = top.shape[-2:]
    nd, nr = site.shape[-2:]
    nC = bot.shape[-1]
    meta += [na, nl, nc, nu, nA, nd, nr, nC]
    return meta


def _check_operands(env, top, site, bot):
    ops = (env, top, site, bot)
    dt = env.dtype
    if any(o.dtype != dt for o in ops):
        raise TypeError("col_transfer operands must share one dtype, got "
                        f"{[o.dtype for o in ops]}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA col_transfer takes float32/float64, got "
                        f"{dt} (complex support comes with fermions)")
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
    lib = cuda_library().lib
    fn = lib.col_transfer_f32 if env.dtype == torch.float32 \
        else lib.col_transfer_f64
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
    item_threshold: the batch size from which one CTA takes a whole item)."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    _, meta = launch_meta(env, top, site, bot)
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
