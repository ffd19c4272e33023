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
tensor it launches the hand-written kernel (``csrc/bmps_overlap.cu``, one
CTA per item holding m in shared memory across all columns; float32,
float64, complex64 and complex128) or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from peps_tpu_torch.kernels.col_transfer import _merge_batch

MAX_BATCH = 4
MAX_CHI = 64        # the kernel keeps chi^2 / 256 outputs a thread (<= 16)
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
