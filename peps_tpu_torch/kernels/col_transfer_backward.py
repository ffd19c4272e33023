"""K1's backward: the gradients of the BTen column transfer in one launch,
and its plain PyTorch version.

    out[..., A, r, C] = sum env[..., a, l, c] top[..., a, u, A]
                            site[..., u, l, d, r] bot[..., c, d, C]

:func:`col_transfer_backward` returns the gradients of (env, top, site,
bot) that ``needs`` asks for (torch's convention: the incoming gradient
times the conjugate of the other operands), each reduced to its operand's
shape; None elsewhere. It is what ``jax.grad`` computes through
``peps_tpu/contraction/bmps.py:_col_transfer_left`` on the reference's
graded holes (``peps_tpu/fermion/vmc.py:301-306``).

On CPU tensors it runs the plain version
(:func:`col_transfer_backward_plain`: three plain transfers on permuted
views and a grouped einsum). On CUDA tensors it
launches the hand-written kernel (``csrc/col_transfer_backward.cu``: one
launch per call, every requested gradient, thread-block clusters over the
groups of items that share a broadcast operand) or raises; there is no
fallback. :func:`backward_plan` is the kernel's launch plan, in Python so
that the CPU tests can check it; it rides in the launch meta, which is
cached per operand signature.
"""
from __future__ import annotations

import ctypes
import math

import torch

from peps_tpu_torch.kernels import col_transfer as k1

MAX_BATCH = 4
ENTRIES = {torch.float32: "col_transfer_backward_f32",
           torch.float64: "col_transfer_backward_f64",
           torch.complex64: "col_transfer_backward_c64",
           torch.complex128: "col_transfer_backward_c128"}
H100_SMS = 132
TILE_VALUES = 4096         # an output tile: 64 x 64, or 32 x 128
MAX_TN = 128
TAB_LEN = 128 + 2 * MAX_TN  # the tile's offset tables (csrc kTabLen)
MAX_CLUSTER = 8            # the largest portable cluster
CTAS_PER_SM = 2            # the CTAs a launch keeps resident an SM
# (K chunk, row padding, stages of the cp.async ring) per dtype (csrc Tr)
CHUNK = {torch.float32: (16, 4, 4), torch.float64: (16, 4, 3),
         torch.complex64: (16, 4, 3), torch.complex128: (8, 2, 4)}
MAX_TAB_ITEMS = 32         # group items whose offsets a CTA tabulates
ITEM = {torch.float32: 4, torch.float64: 8, torch.complex64: 8,
        torch.complex128: 16}
# the tensors whose batch strides ride in the meta, in the kernel's order
TENSORS = ("env", "top", "site", "bot", "g", "genv", "gtop", "gsite", "gbot")
META_LEN = 4 + 4 * len(TENSORS) + 16 + 8 + 4 + 4 + 11


def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def _reduce_to(grad, shape):
    """Sum grad over the batch dims that broadcast onto ``shape``."""
    lead = grad.dim() - len(shape)
    if lead > 0:
        grad = grad.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape)
                 if n == 1 and grad.shape[i] != 1)
    if dims:
        grad = grad.sum(dim=dims, keepdim=True)
    return grad


def col_transfer_backward_plain(g, env, top, site, bot, needs):
    """The plain PyTorch version: the env, top and bot gradients are one
    plain transfer each (``col_transfer.col_transfer_plain``) on permuted
    views of conj(g) and the other operands, conjugated; the site gradient
    is the hole form (env.top)(bot.g), grouped as
    ``bmps.punch_holes_row``; each is reduced to its operand's shape."""
    gc = _conj(g)
    views = {"env": (gc, top.transpose(-3, -1), site.transpose(-3, -1),
                     bot.transpose(-3, -1)),
             "top": (bot, env.transpose(-3, -1), site.movedim(-4, -1),
                     gc.transpose(-3, -1)),
             "bot": (top, env, site.permute(*range(site.dim() - 4),
                                            -3, -4, -1, -2), gc)}
    out = [None] * 4
    for i, (name, op) in enumerate((("env", env), ("top", top))):
        if needs[i]:
            out[i] = _reduce_to(_conj(k1.col_transfer_plain(*views[name])),
                                op.shape)
    if needs[2]:
        lt = torch.einsum("...alc,...auA->...lcuA", env, top)
        br = torch.einsum("...cdC,...ArC->...cdAr", bot, gc)
        out[2] = _reduce_to(_conj(torch.einsum(
            "...lcuA,...cdAr->...uldr", lt, br)), site.shape)
    if needs[3]:
        out[3] = _reduce_to(_conj(k1.col_transfer_plain(*views["bot"])),
                            bot.shape)
    return tuple(out)


def entry_name(dtype) -> str:
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA col_transfer backward takes "
                        f"{list(ENTRIES)}, got {dtype}")
    return ENTRIES[dtype]


def kmax_of(dims):
    """The largest K of the kernel's products (csrc: X, P, R, F, the site,
    env, top and bot gradients)."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    return max(nC, na, nd * nr, nu * nl, nc * nA, nu * nA, nl * nc, nA * nr)


def smem_bytes(dtype, kmax) -> int:
    """The shared bytes a CTA takes: the cp.async ring of staged K chunks
    (A up to 64 wide, B up to 128; the site gradient's partial tile
    reuses it), the group's items' operand offsets, the tile's offset
    tables and the k offsets of both operands (kmax each)."""
    bk, pad, nst = CHUNK[dtype]
    ring = max(nst * (bk * (64 + pad) + bk * (MAX_TN + pad)), TILE_VALUES)
    return ring * ITEM[dtype] + MAX_TAB_ITEMS * 5 * 8 \
        + (TAB_LEN + 2 * kmax) * 4


def scratch_layout(dims, needs):
    """Offsets (elements) of the intermediates X, P, R, F in one item's
    scratch, and the item's size; an intermediate no requested gradient
    needs takes no room (offset 0)."""
    na, nl, nc, nu, nA, nd, nr, nC = dims
    ne, nt, ns, nb = needs
    sizes = (nc * nd * nA * nr if (ne or nt or ns) else 0,
             nl * nc * nu * nA if (ns or nb) else 0,
             nl * nc * nu * nA if (ne or nt) else 0,
             nc * nd * nA * nr if nb else 0)
    offs, end = [], 0
    for n in sizes:
        offs.append(end if n else 0)
        end += -(-n // 2) * 2          # 16-byte aligned in every dtype
    return offs, end


def backward_plan(dims, dtype, needs, group_items, groups, sms=H100_SMS,
                  cluster=None):
    """The launch plan for sizes ``dims`` = (na, nl, nc, nu, nA, nd, nr, nC)
    of ``dtype``, the requested gradients ``needs``, ``groups`` groups of
    ``group_items`` items each (the items of a group share some requested
    gradient's broadcast operand) and a card of ``sms`` SMs. The cluster
    size: the least power of two (at most 8) with which the groups give
    every SM a CTA; a group's products are cut into tiles of 4096 values
    dealt over its cluster, and where the groups alone fill the card one
    CTA takes a group (no tile waits on a cluster barrier). ``cluster``
    overrides it. Clusters: one per group, at most CTAS_PER_SM * sms CTAs
    in all (each walks over groups). Raises TypeError for a dtype the
    kernel does not take, ValueError for empty sizes or a group past
    2^31 - 1 items."""
    entry_name(dtype)
    dims = tuple(int(x) for x in dims)
    if len(dims) != 8 or min(dims) < 1:
        raise ValueError(f"col_transfer backward plan of sizes {dims}: "
                         "needs 8 sizes >= 1")
    if group_items >= 2 ** 31 or groups < 1:
        raise ValueError(f"col_transfer backward of {groups} groups of "
                         f"{group_items} items")
    if cluster is None:
        cluster = 1
        while cluster < MAX_CLUSTER and groups * cluster < sms:
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster size {cluster} not in 1..{MAX_CLUSTER}")
    clusters = max(1, min(groups, CTAS_PER_SM * sms // cluster))
    offs, item = scratch_layout(dims, needs)
    return {"dims": dims, "dtype": dtype,
            "needs": tuple(bool(n) for n in needs), "cluster": cluster,
            "clusters": clusters, "ctas": clusters * cluster,
            "group_items": group_items, "groups": groups, "item_sz": item,
            "scratch_offsets": offs, "scratch": clusters * group_items * item,
            "smem_bytes": smem_bytes(dtype, kmax_of(dims)), "sms": sms}


_META_CACHE: dict = {}
_META_CACHE_MAX = 4096


def launch_meta(g, env, top, site, bot, needs, sms=H100_SMS):
    """(plan, ctypes meta) of a kernel call, cached per (shapes, strides,
    dtype, device, needs) signature."""
    ops = (env, top, site, bot, g)
    key = (tuple((o.shape, o.stride(), o.dtype, o.device) for o in ops),
           tuple(bool(n) for n in needs), sms)
    hit = _META_CACHE.get(key)
    if hit is not None:
        return hit
    k1._check_operands(env, top, site, bot)
    if g.dtype != env.dtype or g.device != env.device:
        raise TypeError("col_transfer backward: the gradient must share the "
                        "operands' dtype and device")
    inner = (3, 3, 4, 3, 3)
    batch = torch.broadcast_shapes(*(o.shape[:o.dim() - n]
                                     for o, n in zip(ops, inner)))
    dims = k1.k1_dims(env, top, site, bot)
    # the kernel's offset tables are 32-bit: every operand's inner offsets
    for o, n in zip(ops, inner):
        if sum((x - 1) * st for x, st in zip(o.shape[o.dim() - n:],
                                             o.stride()[o.dim() - n:])) \
                >= 2 ** 31:
            raise ValueError("col_transfer backward: an operand's inner "
                             "offsets pass 2^31")
    if tuple(g.shape) != (*batch, dims[4], dims[6], dims[7]):
        raise ValueError(f"col_transfer backward: gradient of shape "
                         f"{tuple(g.shape)} for an output of shape "
                         f"{(*batch, dims[4], dims[6], dims[7])}")
    nb = len(batch)
    strides = [list(o.expand(*batch, *o.shape[o.dim() - n:]).stride()[:nb])
               for o, n in zip(ops, inner)]
    for o, n, need in zip(ops[:4], inner[:4], needs):
        strides.append(list(torch.empty(o.shape, device="meta").expand(
            *batch, *o.shape[o.dim() - n:]).stride()[:nb]) if need
            else [0] * nb)
    shape, strides = k1._merge_batch(list(batch), strides)
    if len(shape) > MAX_BATCH:
        raise ValueError(f"col_transfer backward takes at most {MAX_BATCH} "
                         f"batch dimensions after merging, got {batch}")
    pad = MAX_BATCH - len(shape)
    shape = [1] * pad + shape
    strides = [[0] * pad + s for s in strides]
    # group dims: where a requested gradient's operand is broadcast
    group = [int(any(need and strides[5 + i][d] == 0
                     for i, need in enumerate(needs)) and shape[d] > 1)
             for d in range(MAX_BATCH)]
    # env and top broadcast over the same group dims: P one per run. R is
    # then summed over the run, so every requested env or top gradient
    # must be reduced over that run too: an expanded env or top (stride 0
    # at a size > 1) has a gradient per item there, and shares nothing.
    bcast = [[s[d] == 0 for d in range(MAX_BATCH)] for s in strides]
    share = int(any(group) and all(
        bcast[0][d] == bcast[1][d]
        and not (needs[0] and bcast[5][d] != bcast[0][d])
        and not (needs[1] and bcast[6][d] != bcast[1][d])
        for d in range(MAX_BATCH) if group[d]))
    group_items = math.prod(n for n, f in zip(shape, group) if f)
    groups = math.prod(n for n, f in zip(shape, group) if not f)
    plan = backward_plan(dims, env.dtype, needs, group_items, groups, sms)
    meta = list(shape)
    for s in strides:
        meta += s
    for o, n in zip(ops, inner):
        meta += list(o.stride()[o.dim() - n:])
    meta += dims + [int(bool(n)) for n in needs] + group
    meta += [plan["cluster"], plan["clusters"], group_items, groups,
             plan["item_sz"], *plan["scratch_offsets"], plan["smem_bytes"],
             share]
    plan = {**plan, "share": bool(share)}
    assert len(meta) == META_LEN
    if len(_META_CACHE) >= _META_CACHE_MAX:
        _META_CACHE.clear()
    hit = _META_CACHE[key] = (plan, (ctypes.c_int64 * len(meta))(*meta))
    return hit


def _launch(g, env, top, site, bot, needs):
    """One launch of the kernel on CUDA tensors."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    name = entry_name(env.dtype)
    lib = cuda_library().lib     # raises before planning where CUDA is missing
    # a lazily conjugated or negated view holds other values than its data
    g, env, top, site, bot = (t.resolve_conj().resolve_neg()
                              for t in (g, env, top, site, bot))
    plan, meta = launch_meta(g, env, top, site, bot, needs,
                             k1.sm_count(env.device))
    ops = (env, top, site, bot)
    grads = [torch.empty(o.shape, dtype=o.dtype, device=o.device) if n
             else None for o, n in zip(ops, needs)]
    if g.numel() == 0:
        return tuple(x.zero_() if x is not None else None for x in grads)
    scratch = torch.empty(plan["scratch"], dtype=env.dtype,
                          device=env.device)
    args = (*(t.data_ptr() for t in (env, top, site, bot, g)),
            *(x.data_ptr() if x is not None else None for x in grads),
            scratch.data_ptr(), meta)
    if torch.cuda.current_device() == env.device.index:
        check(getattr(lib, name)(*args,
                                 torch.cuda.current_stream().cuda_stream))
    else:
        with torch.cuda.device(env.device):
            check(getattr(lib, name)(
                *args, torch.cuda.current_stream(env.device).cuda_stream))
    col_transfer_backward.launches += 1
    return tuple(grads)


def col_transfer_backward(g, env, top, site, bot, needs):
    """K1's backward. CPU tensors: :func:`col_transfer_backward_plain`.
    CUDA tensors: one launch of the kernel for every gradient ``needs``
    asks for (a tuple of four flags for env, top, site, bot). Returns the
    four gradients, None where not asked for."""
    if env.device.type == "cpu":
        return col_transfer_backward_plain(g, env, top, site, bot, needs)
    if env.device.type != "cuda":
        raise RuntimeError(f"col_transfer backward runs on cpu or cuda, not "
                           f"{env.device}")
    if not any(needs):
        return (None,) * 4
    return _launch(g, env, top, site, bot, tuple(bool(n) for n in needs))


def backward_diagnostic(dtype):
    """The compiled kernel of ``dtype`` (CUDA only; nothing depends on it):
    smem_bytes a CTA without its k tables, regs_per_thread and
    spill_bytes."""
    from peps_tpu_torch.kernels._build import check, cuda_library
    out = (ctypes.c_int64 * 3)()
    check(cuda_library().lib.col_transfer_backward_attributes(
        list(ENTRIES).index(dtype), out))
    return {"smem_bytes": out[0], "regs_per_thread": out[1],
            "spill_bytes": out[2]}


col_transfer_backward.launches = 0
