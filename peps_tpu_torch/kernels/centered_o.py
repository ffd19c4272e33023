"""K2: the centered, scaled SR sample matrix, and its plain PyTorch version.

    a[s, (y, x, p, k)] = (O[s, y, x, p, k] - mean_s O[:, y, x, p, k]) / sqrt(Ns)
    O[s, y, x, p, k]   = [cfg[s, y, x] == p] * holes[s, y, x, k] / psi[s, y, x]

with psi = 1 where psi == 0, k running over the flattened (u, l, d, r) legs.
This fuses ``peps_tpu/algorithm/energy.py:_row_pass``'s O build
(energy.py:112-116), the sample stacking of ``mc_evaluator._mc_collect``
(mc_evaluator.py:265) and ``mc_evaluator._center_scale`` (:316-320): the
un-centered [Ns, P] O buffer is never written.

What bounds it on the H100: memory. At the main-path shape (Ns = 32,
P = 8*8*2*8^4 = 524288, f32) it reads the holes (33.5 MB) twice and writes
the 67 MB result once, against ~3 FLOP per element. Design: one Triton
program per column tile; a first loop over sample tiles sums the column
means, a second loop writes the centered values. The second read of the
holes hits L2 for the tile just summed. The one-hot scatter is a compare on
the loaded config, so a zero of the O buffer costs no read.

On a CPU tensor :func:`centered_o` runs the plain version; on a CUDA tensor
it launches the Triton kernel or raises.
"""
from __future__ import annotations

import functools

import torch


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


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def centered_o_kernel(holes_ptr, psi_ptr, cfg_ptr, out_ptr, NS, S, K, P,
                          D_PHYS: tl.constexpr, BLOCK_S: tl.constexpr,
                          BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        cols = pid * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < P
        site = cols // (D_PHYS * K)
        p = (cols // K) % D_PHYS
        k = cols % K
        rows0 = tl.arange(0, BLOCK_S)
        acc = tl.zeros((BLOCK_C,), dtype=holes_ptr.dtype.element_ty)
        ns_f = acc + NS          # Ns in the working dtype (f64 stays f64)
        for s0 in range(0, NS, BLOCK_S):
            rows = s0 + rows0
            m = (rows[:, None] < NS) & cmask[None, :]
            sidx = rows[:, None] * S + site[None, :]
            h = tl.load(holes_ptr + sidx * K + k[None, :], mask=m, other=0.0)
            ps = tl.load(psi_ptr + sidx, mask=m, other=1.0)
            c = tl.load(cfg_ptr + sidx, mask=m, other=-1)
            ps = tl.where(ps == 0.0, 1.0, ps)
            o = (h / ps) * (c == p[None, :]).to(h.dtype)
            acc += tl.sum(o, axis=0)
        mean = acc / ns_f
        root = tl.sqrt(ns_f)
        for s0 in range(0, NS, BLOCK_S):
            rows = s0 + rows0
            m = (rows[:, None] < NS) & cmask[None, :]
            sidx = rows[:, None] * S + site[None, :]
            h = tl.load(holes_ptr + sidx * K + k[None, :], mask=m, other=0.0)
            ps = tl.load(psi_ptr + sidx, mask=m, other=1.0)
            c = tl.load(cfg_ptr + sidx, mask=m, other=-1)
            ps = tl.where(ps == 0.0, 1.0, ps)
            o = (h / ps) * (c == p[None, :]).to(h.dtype)
            tl.store(out_ptr + rows[:, None] * P + cols[None, :],
                     (o - mean[None, :]) / root[None, :], mask=m)

    return triton, centered_o_kernel


BLOCK_C = 256


def centered_o(holes, psi, cfg, d):
    """K2 wrapper. CPU tensors: plain version. CUDA tensors: the kernel."""
    if holes.device.type == "cpu":
        return centered_o_plain(holes, psi, cfg, d)
    if holes.device.type != "cuda":
        raise RuntimeError(f"centered_o runs on cpu or cuda, not "
                           f"{holes.device}")
    if holes.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA centered_o takes float32/float64, got "
                        f"{holes.dtype} (complex support comes with fermions)")
    ns, s, k = holes.shape
    if psi.shape != (ns, s) or cfg.shape != (ns, s):
        raise ValueError(f"centered_o shapes: holes {tuple(holes.shape)}, "
                         f"psi {tuple(psi.shape)}, cfg {tuple(cfg.shape)}")
    if psi.dtype != holes.dtype or psi.device != holes.device \
            or cfg.device != holes.device:
        raise ValueError("centered_o operands differ in dtype or device")
    if ns * s * d * k >= 2 ** 31:
        raise ValueError("centered_o buffer too large for 32-bit offsets")
    triton, kernel = _kernel()
    holes, psi = holes.contiguous(), psi.contiguous()
    cfg = cfg.to(torch.int32).contiguous()
    p = s * d * k
    out = torch.empty(ns, p, dtype=holes.dtype, device=holes.device)
    block_s = min(32, triton.next_power_of_2(max(ns, 1)))
    grid = (triton.cdiv(p, BLOCK_C),)
    with torch.cuda.device(holes.device):
        kernel[grid](holes, psi, cfg, out, ns, s, k, p, D_PHYS=d,
                     BLOCK_S=block_s, BLOCK_C=BLOCK_C, num_warps=4)
    centered_o.launches += 1
    return out


centered_o.launches = 0


