"""K2: the centered, scaled SR sample matrix, and its plain PyTorch version.

    a[s, (y, x, p, k)] = (O[s, y, x, p, k] - mean_s O[:, y, x, p, k]) / sqrt(Ns)
    O[s, y, x, p, k]   = [cfg[s, y, x] == p] * holes[s, y, x, k] / psi[s, y, x]

with psi = 1 where psi == 0, k running over the flattened (u, l, d, r) legs.
This fuses ``peps_tpu/algorithm/energy.py:_row_pass``'s O build
(energy.py:112-116), the sample stacking of ``mc_evaluator._mc_collect``
(mc_evaluator.py:265) and ``mc_evaluator._center_scale`` (:316-320): the
un-centered [Ns, P] O buffer is never written.

What bounds it on the H100: memory (a few flops per output). The kernel
(``csrc/centered_o.cu``, CUDA C++ for sm_90a; the source note has the
design) gives one CTA a site and a 128-byte chunk of its K columns for all
d values of p, reads each holes value once into registers, and writes the
d outputs from there. :func:`centered_o_plan` is its launch plan, in
Python so that the CPU tests can check it.

complex64 and complex128 take a separate, simple complex body in the same
source (no conjugate: O as above, the SR solve conjugates later), planned
by the same function. On a CPU tensor :func:`centered_o` runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

THREADS = 256
LANES_PER_ROW = 8                      # 8 lanes x 16 bytes: a 128-byte line
ROWS_PER_PASS = THREADS // LANES_PER_ROW
MAX_ROWS_PER_THREAD = 8                # a row block holds 256 rows
MAX_D = 4                              # spin-1/2 2, t-J 3, Hubbard 4
ENTRIES = {torch.float32: "centered_o_f32", torch.float64: "centered_o_f64",
           torch.complex64: "centered_o_c64",
           torch.complex128: "centered_o_c128"}
COMPLEX = (torch.complex64, torch.complex128)
CX_COLS = 32                           # the complex body: 32 columns a CTA


def centered_o_plain(holes, psi, cfg, d):
    """holes [Ns, S, K], psi [Ns, S], cfg [Ns, S] int, d -> a [Ns, S*d*K]."""
    ns = holes.shape[0]
    safe = torch.where(psi == 0, torch.ones_like(psi), psi)
    sel = torch.nn.functional.one_hot(cfg.long(), d).to(holes.dtype)
    o = (holes / safe[..., None])[:, :, None, :] * sel[..., None]
    o = o.reshape(ns, -1)
    obar = o.mean(dim=0)
    return (o - obar[None, :]) / torch.sqrt(
        torch.tensor(float(ns), dtype=holes.dtype, device=holes.device))


def centered_o_plan(ns, s, k, d, dtype):
    """The kernel's launch plan for holes [ns, s, k] of ``dtype`` and d
    physical states: one CTA of ``threads`` per (site, chunk of
    ``cols_per_cta`` columns of K); each thread keeps ``rows_per_thread``
    16-byte vectors of the chunk's tile in registers;
    rows come in ``row_blocks`` blocks of ``block_rows`` (more than one
    block re-reads all but the last in the write pass). ``smem_bytes`` is
    the CTA's static shared memory, ``tile_bytes`` its register tile,
    ``ctas_per_sm`` the CTAs an SM holds at least (the kernel's launch
    bounds); offsets are 64-bit whatever the size. A complex dtype takes
    the complex body's plan (:func:`_complex_plan`)."""
    entry_name(dtype)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA centered_o takes 1 <= d <= {MAX_D}, "
                         f"got d = {d}")
    if min(ns, s, k) < 1:
        raise ValueError(f"centered_o plan of an empty buffer: "
                         f"{(ns, s, k)}")
    if dtype in COMPLEX:
        return _complex_plan(ns, s, k, d, dtype)
    item = torch.finfo(dtype).bits // 8
    vec = 16 // item
    kc = LANES_PER_ROW * vec
    chunks = -(-k // kc)
    r = 1
    while r < MAX_ROWS_PER_THREAD and r * ROWS_PER_PASS < ns:
        r *= 2
    block_rows = r * ROWS_PER_PASS
    dp = 2 if d <= 2 else 4
    ctas = s * chunks
    if ctas >= 2 ** 31:
        raise ValueError(f"centered_o grid of {ctas} CTAs exceeds 2^31 - 1")
    smem = (block_rows * (item + 4) + (THREADS // 32 + 1) * dp * kc * item)
    return {"threads": THREADS, "cols_per_cta": kc, "col_chunks": chunks,
            "ctas": ctas, "rows_per_thread": r, "block_rows": block_rows,
            "row_blocks": -(-ns // block_rows), "dp": dp, "vec": vec,
            "smem_bytes": smem, "tile_bytes": block_rows * kc * item,
            "ctas_per_sm": 4 if r <= 2 else 3 if r == 4 else 2,
            "out_elements": ns * s * d * k, "offset_bits": 64}


def _complex_plan(ns, s, k, d, dtype):
    """The complex body's plan: one CTA of 256 threads per (site, chunk of
    32 columns of K), the warps striding over the Ns rows twice (sums,
    then the write); shared memory holds the warps' partial sums of the
    ``dp`` >= d states (8 or 16 bytes a value)."""
    item = 8 if dtype == torch.complex64 else 16
    chunks = -(-k // CX_COLS)
    ctas = s * chunks
    if ctas >= 2 ** 31:
        raise ValueError(f"centered_o grid of {ctas} CTAs exceeds 2^31 - 1")
    dp = 2 if d <= 2 else 4
    return {"body": "simt_complex", "threads": THREADS,
            "cols_per_cta": CX_COLS, "col_chunks": chunks, "ctas": ctas,
            "dp": dp, "smem_bytes": (THREADS // 32) * dp * CX_COLS * item,
            "row_passes": 2, "out_elements": ns * s * d * k,
            "offset_bits": 64}


def entry_name(dtype) -> str:
    """The kernel library's C entry for holes of ``dtype``; TypeError for a
    dtype the kernel does not take."""
    if dtype not in ENTRIES:
        raise TypeError(f"the CUDA centered_o takes {list(ENTRIES)}, got "
                        f"{dtype}")
    return ENTRIES[dtype]


def _check_operands(holes, psi, cfg):
    """Shapes, dtypes and devices the kernel takes (holes' dtype and d are
    checked by the plan)."""
    if holes.dim() != 3:
        raise ValueError(f"centered_o holes must be [Ns, S, K], got "
                         f"{tuple(holes.shape)}")
    ns, s, _ = holes.shape
    if psi.shape != (ns, s) or cfg.shape != (ns, s):
        raise ValueError(f"centered_o shapes: holes {tuple(holes.shape)}, "
                         f"psi {tuple(psi.shape)}, cfg {tuple(cfg.shape)}")
    if psi.dtype != holes.dtype:
        raise TypeError(f"centered_o psi is {psi.dtype}, holes "
                        f"{holes.dtype}")
    if cfg.dtype.is_floating_point or cfg.dtype.is_complex:
        raise TypeError(f"centered_o configurations must be integers, got "
                        f"{cfg.dtype}")
    if psi.device != holes.device or cfg.device != holes.device:
        raise ValueError("centered_o operands lie on different devices")


def centered_o(holes, psi, cfg, d):
    """K2 wrapper. CPU tensors: plain version. CUDA tensors: the kernel.
    cfg may be of any integer dtype on either."""
    if holes.device.type == "cpu":
        return centered_o_plain(holes, psi, cfg, d)
    if holes.device.type != "cuda":
        raise RuntimeError(f"centered_o runs on cpu or cuda, not "
                           f"{holes.device}")
    _check_operands(holes, psi, cfg)
    ns, s, k = holes.shape
    if ns * s * k == 0:
        return holes.new_empty(ns, s * d * k)
    plan = centered_o_plan(ns, s, k, d, holes.dtype)
    from peps_tpu_torch.kernels._build import check, cuda_library
    lib = cuda_library().lib
    # the kernel reads int64 states; any integer dtype converts here, as
    # the plain version's cfg.long() does
    holes, psi, cfg = holes.contiguous(), psi.contiguous(), \
        cfg.to(torch.int64).contiguous()
    out = torch.empty(ns, s * d * k, dtype=holes.dtype, device=holes.device)
    if holes.dtype in COMPLEX:
        args = (ctypes.c_int64 * 6)(ns, s, k, d, plan["col_chunks"],
                                    plan["dp"])
    else:
        vec = (k % plan["vec"] == 0 and holes.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        args = (ctypes.c_int64 * 9)(ns, s, k, d, plan["col_chunks"],
                                    plan["rows_per_thread"],
                                    plan["row_blocks"], plan["dp"], int(vec))
    fn = getattr(lib, entry_name(holes.dtype))
    with torch.cuda.device(holes.device):
        check(fn(holes.data_ptr(), psi.data_ptr(), cfg.data_ptr(),
                 out.data_ptr(), args,
                 torch.cuda.current_stream(holes.device).cuda_stream))
    centered_o.launches += 1
    return out


centered_o.launches = 0
