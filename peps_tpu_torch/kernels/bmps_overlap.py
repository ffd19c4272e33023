"""K5: the closure of a top-type and a bottom-type boundary MPS, and its
plain PyTorch version.

    m_0 = e0 e0^T,   m_{x+1} = normalize(sum_{a,c,v} m_x[a, c] a[x][a, v, b]
                                                   b[x][c, v, d])

over the Lx columns, the norm Frobenius and clamped to ``finfo.tiny``;
returns (m_Lx[0, 0], sum_x log ||.||) per item. a and b are [..., Lx, chi,
D, chi] (a top-type: its vertical leg is the d leg of the rows above; b
bottom-type); their leading batch dimensions broadcast against each other
(at most four after merging) and a broadcast operand is read with batch
stride 0, never copied. This is
``peps_tpu/algorithm/measure_fermion.py:_bmps_overlap``, a ``lax.scan`` of
two einsums, a norm and a divide per column that XLA fused on the TPU.

On a CPU tensor :func:`bmps_overlap` runs the plain version; on a CUDA
tensor it launches the hand-written kernel (``csrc/bmps_overlap.cu``: one
CTA takes the items that share a b slab, stages each b_v once for all of
them and keeps every item's m in shared memory across all columns;
float32, float64, complex64 and complex128) or raises; there is no
fallback. :func:`overlap_plan` is the launch plan (lanes a CTA, buffers,
shared bytes), in Python so that the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from peps_tpu_torch.kernels.col_transfer import _merge_batch, sm_count

MAX_BATCH = 4
MAX_CHI = 64        # the kernel keeps chi^2 / 256 outputs a thread (<= 16)
MAX_LANES = 16      # items a CTA of the staged body (csrc kMaxLanes)
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472       # the H100's shared memory an SM (1 KB a CTA kept)
H100_SMS = 132
# the staged body's row padding (elements) per dtype (csrc Staged<T>::pad)
PAD = {torch.float32: 4, torch.complex64: 2, torch.float64: 4,
       torch.complex128: 2}
ITEM = {torch.float32: 4, torch.float64: 8, torch.complex64: 8,
        torch.complex128: 16}
ENTRIES = {torch.float32: "bmps_overlap_f32",
           torch.float64: "bmps_overlap_f64",
           torch.complex64: "bmps_overlap_c64",
           torch.complex128: "bmps_overlap_c128"}


def _tiny(t):
    return torch.finfo(t.real.dtype if t.is_complex() else t.dtype).tiny


def bmps_overlap_plain(a, b):
    """The plain PyTorch version: the reference's scan, one einsum, a norm
    and a divide per column."""
    batch = torch.broadcast_shapes(a.shape[:-4], b.shape[:-4])
    chi = a.shape[-3]
    rdt = a.real.dtype if a.is_complex() else a.dtype
    m = torch.zeros(*batch, chi, b.shape[-3], dtype=a.dtype, device=a.device)
    m[..., 0, 0] = 1.0
    logw = torch.zeros(batch, dtype=rdt, device=a.device)
    for x in range(a.shape[-4]):
        m2 = torch.einsum("...ac,...avb,...cvd->...bd", m,
                          a[..., x, :, :, :], b[..., x, :, :, :])
        n = torch.clamp(torch.linalg.vector_norm(m2, dim=(-2, -1)),
                        min=_tiny(a))
        m = m2 / n[..., None, None]
        logw = logw + torch.log(n)
    return m[..., 0, 0], logw


def entry_name(dtype) -> str:
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA bmps_overlap takes {list(ENTRIES)}, got "
                        f"{dtype}")
    return ENTRIES[dtype]


def staged_smem(dtype, chi_p, lanes, nbuf):
    """Shared bytes of a staged CTA: m and the accumulator of each lane,
    nbuf buffers of b_v and of a lane's a_v, and two of T, each chi_p x
    (chi_p + pad); the warps' partial sums and the lanes' log weights."""
    blk = chi_p * (chi_p + PAD[dtype]) * ITEM[dtype]
    real = ITEM[dtype] // (2 if dtype.is_complex else 1)
    return (2 * lanes + 2 * nbuf + 2) * blk + (8 + MAX_LANES) * real


def overlap_plan(dtype, chi, lane_items, groups, sms=H100_SMS):
    """The launch plan of ``groups`` groups of ``lane_items`` items that
    share a b slab (the lanes), chi padded to chi_p (a multiple of 16).
    The staged body with two buffers where they fit, else one. Lanes a
    CTA: the fewest that keep two lanes in flight an SM, counting the CTAs
    an SM's shared memory holds. A stage is two barriers around a short
    product: a second lane in flight (a second CTA, or a second lane of
    one CTA) hides them, and past that the lanes of a CTA only run one
    after another. So one lane a CTA wherever two CTAs fit an SM, two
    where one CTA fills it (complex128 at chi_p = 32; float64 and
    complex64 at 48, float32 at 64), the b slab then staged once for
    both; where two lanes do not fit either, one. Where no staged CTA
    fits (complex128 at chi > 48), the simple body: one CTA an item."""
    chi_p = -(-chi // 16) * 16
    for nbuf in (2, 1):
        for lanes in range(1, min(lane_items, MAX_LANES) + 1):
            smem = staged_smem(dtype, chi_p, lanes, nbuf)
            if smem > SMEM_PER_BLOCK:
                break
            resident = max(1, min(8, SMEM_PER_SM // (smem + 1024)))
            last = lanes == min(lane_items, MAX_LANES) or staged_smem(
                dtype, chi_p, lanes + 1, nbuf) > SMEM_PER_BLOCK
            if lanes * resident >= 2 or last:
                return {"body": "staged", "lanes": lanes, "nbuf": nbuf,
                        "chi_p": chi_p, "smem_bytes": smem,
                        "ctas": groups * -(-lane_items // lanes)}
    return {"body": "simple", "lanes": 1, "nbuf": 0, "chi_p": chi,
            "smem_bytes": 0, "ctas": groups * lane_items}


def launch_meta(a, b):
    """(batch shape, a, b, meta list) of a kernel call: the operands with
    contiguous slabs, the batch merged to at most MAX_BATCH dimensions."""
    if a.dtype != b.dtype:
        raise TypeError(f"bmps_overlap operands must share one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    entry_name(a.dtype)
    if a.device != b.device:
        raise ValueError("bmps_overlap operands lie on different devices")
    if a.shape[-4:] != b.shape[-4:] or a.shape[-3] != a.shape[-1]:
        raise ValueError(f"bmps_overlap shape mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    lx, chi, dv = a.shape[-4], a.shape[-3], a.shape[-2]
    if chi > MAX_CHI:
        raise ValueError(f"bmps_overlap takes chi <= {MAX_CHI}, got {chi}")
    slab = (chi * dv * chi, dv * chi, chi, 1)
    a, b = (t if t.stride()[-4:] == slab else t.contiguous() for t in (a, b))
    batch = torch.broadcast_shapes(a.shape[:-4], b.shape[:-4])
    nb = len(batch)
    ops = [t.expand(*batch, *t.shape[-4:]) for t in (a, b)]
    shape, strides = _merge_batch(list(batch),
                                  [list(o.stride()[:nb]) for o in ops])
    if len(shape) > MAX_BATCH:
        raise ValueError(f"bmps_overlap takes at most {MAX_BATCH} batch "
                         f"dimensions after merging, got shape {batch}")
    pad = MAX_BATCH - len(shape)
    meta = [1] * pad + shape
    for s in strides:
        meta += [0] * pad + s
    meta += [lx, chi, dv]
    # lane dims: b broadcast over them (a slab shared by their items)
    sa, sb = ([0] * pad + s for s in strides)
    size = [1] * pad + shape
    lane = [int(size[d] > 1 and sb[d] == 0 and sa[d] != 0)
            for d in range(MAX_BATCH)]
    lane_items = math.prod(n for n, f in zip(size, lane) if f)
    groups = math.prod(n for n, f in zip(size, lane) if not f)
    plan = overlap_plan(a.dtype, chi, lane_items, groups,
                        sm_count(a.device))
    item = a.element_size()
    vec = int(chi * item % 16 == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0
              and all(x * item % 16 == 0 for x in sa + sb))
    meta += lane + [("simple", "staged").index(plan["body"]), plan["lanes"],
                    plan["nbuf"], vec, plan["chi_p"], plan["smem_bytes"]]
    return batch, a, b, meta


def bmps_overlap(a, b):
    """K5 wrapper. CPU tensors: plain version. CUDA tensors: the kernel.
    Returns (mantissa [batch] in the operands' dtype, log weight [batch]
    in its real dtype)."""
    if a.device.type == "cpu":
        return bmps_overlap_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"bmps_overlap runs on cpu or cuda, not "
                           f"{a.device}")
    from peps_tpu_torch.kernels._build import check, cuda_library
    name = entry_name(a.dtype)
    lib = cuda_library().lib
    # a lazily conjugated or negated view holds other values than its data
    a, b = (t.resolve_conj().resolve_neg() for t in (a, b))
    batch, a, b, meta = launch_meta(a, b)
    rdt = a.real.dtype if a.is_complex() else a.dtype
    mant = torch.empty(batch, dtype=a.dtype, device=a.device)
    logw = torch.empty(batch, dtype=rdt, device=a.device)
    if mant.numel() == 0:
        return mant, logw
    meta_c = (ctypes.c_int64 * len(meta))(*meta)
    with torch.cuda.device(a.device):
        check(getattr(lib, name)(
            a.data_ptr(), b.data_ptr(), mant.data_ptr(), logw.data_ptr(),
            meta_c, torch.cuda.current_stream(a.device).cuda_stream))
    bmps_overlap.launches += 1
    return mant, logw


bmps_overlap.launches = 0
