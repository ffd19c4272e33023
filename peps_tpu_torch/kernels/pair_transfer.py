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
tensor it launches the hand-written kernel (``csrc/pair_transfer.cu``) or
raises; there is no fallback. The launch meta (sizes and strides) is cached
per operand signature (:func:`launch_meta`).
"""
from __future__ import annotations

import ctypes

import torch

from peps_tpu_torch.kernels.col_transfer import MAX_BATCH, _merge_batch

# trailing (non-batch) dims of env, top, row1, row2, bot
_NDIMS = (4, 3, 4, 4, 3)


def pair_transfer_plain(env, top, row1, row2, bot):
    """The plain PyTorch version: env.top, then .row1 summing (u, m), .row2
    summing (d, n), .bot summing (c, e)."""
    t = torch.einsum("...amnc,...auA->...mncuA", env, top)
    t = torch.einsum("...mncuA,...umdr->...ncAdr", t, row1)
    t = torch.einsum("...ncAdr,...dnef->...cAref", t, row2)
    return torch.einsum("...cAref,...ceC->...ArfC", t, bot)


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
    env, top, row1, row2, bot = ops
    na, nm, nn, nc = env.shape[-4:]
    nu, nA = top.shape[-2:]
    nd, nr = row1.shape[-2:]
    ne, nf = row2.shape[-2:]
    nC = bot.shape[-1]
    meta += [na, nm, nn, nc, nu, nA, nd, nr, ne, nf, nC]
    return meta


def _check_operands(ops):
    env, top, row1, row2, bot = ops
    dt = env.dtype
    if any(o.dtype != dt for o in ops):
        raise TypeError("pair_transfer operands must share one dtype, got "
                        f"{[o.dtype for o in ops]}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA pair_transfer takes float32/float64, got "
                        f"{dt} (complex support comes with fermions)")
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
    broadcast and the meta rebuild."""
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
    batch, meta = launch_meta(env, top, row1, row2, bot)
    lib = cuda_library().lib
    fn = lib.pair_transfer_f32 if env.dtype == torch.float32 \
        else lib.pair_transfer_f64
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


def pair_transfer_plan(env, top, row1, row2, bot):
    """The launch plan the kernel takes for these operands (CUDA only; a
    diagnostic read of the launch's own plan rule, nothing depends on it):
    dict(a_tile, c_chunk, ctas, smem_bytes)."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    _, meta = launch_meta(env, top, row1, row2, bot)
    plan = (ctypes.c_int64 * 4)()
    with torch.cuda.device(env.device):
        check(cuda_library().lib.pair_transfer_plan(meta, env.element_size(),
                                                    plan))
    return {"a_tile": plan[0], "c_chunk": plan[1], "ctas": plan[2],
            "smem_bytes": plan[3]}


pair_transfer.launches = 0


def pair_transfer_right(renv, top, row1, row2, bot, transfer=pair_transfer):
    """The right two-row transfer through the left form on permuted views:
    out[a, m, n, c] = sum renv[A, r, f, C] top[a, u, A] row1[u, m, d, r]
    row2[d, n, e, f] bot[c, e, C] is the left transfer with top a<->A,
    row1 m<->r, row2 n<->f and bot c<->C."""
    return transfer(renv, top.transpose(-3, -1), row1.transpose(-3, -1),
                    row2.transpose(-3, -1), bot.transpose(-3, -1))
