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

On a CPU tensor :func:`centered_o` runs the plain version; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

THREADS = 256
LANES_PER_ROW = 8                      # 8 lanes x 16 bytes: a 128-byte line
ROWS_PER_PASS = THREADS // LANES_PER_ROW
MAX_ROWS_PER_THREAD = 8                # a row block holds 256 rows
MAX_D = 4                              # spin-1/2 2, t-J 3, Hubbard 4


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
    bounds); offsets are 64-bit whatever the size."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA centered_o takes float32/float64, got "
                        f"{dtype} (complex support comes with fermions)")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the CUDA centered_o takes 1 <= d <= {MAX_D}, "
                         f"got d = {d}")
    if min(ns, s, k) < 1:
        raise ValueError(f"centered_o plan of an empty buffer: "
                         f"{(ns, s, k)}")
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
    vec = (k % plan["vec"] == 0 and holes.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    args = (ctypes.c_int64 * 9)(ns, s, k, d, plan["col_chunks"],
                                plan["rows_per_thread"], plan["row_blocks"],
                                plan["dp"], int(vec))
    fn = lib.centered_o_f32 if holes.dtype == torch.float32 \
        else lib.centered_o_f64
    with torch.cuda.device(holes.device):
        check(fn(holes.data_ptr(), psi.data_ptr(), cfg.data_ptr(),
                 out.data_ptr(), args,
                 torch.cuda.current_stream(holes.device).cuda_stream))
    centered_o.launches += 1
    return out


centered_o.launches = 0
