"""Z2-graded tensors: dense data plus static parity and arrow metadata per
axis (port of ``peps_tpu/fermion/graded.py``).

* ``GT`` = a dense tensor + per-axis parity vectors (tuples of 0/1) and
  arrows (``dual``: True = bra/in, False = ket/out). The parities and
  arrows describe the TRAILING ``len(parity)`` axes; any axes before them
  are batch axes (the reference maps with ``vmap`` where the port batches).
* Koszul rule: swapping two axes multiplies elementwise by
  (-1)^{p_i(a) p_j(b)}; the parities are static, so each sign is a
  constant mask.
* Contraction pairs a primal (ket) axis with a dual (bra) axis; with the
  primal member first the pairing carries (-1)^p on the contracted index.
  ``gcontract`` arranges a's contracted axes last and b's first (reversed).
* Truncated SVD and QR act blockwise in parity with a static split of the
  kept bond, D = D_even + D_odd, or per U(1) flux sector.

Everything runs on ``torch.linalg``; no hand kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _ptuple(p):
    return tuple(int(x) for x in p)


@dataclasses.dataclass(frozen=True)
class GT:
    """Graded tensor. ``parity[i]`` is a tuple of 0/1 of length
    ``data.shape[nb + i]``, ``dual[i]`` True for a bra (in) axis, False for
    a ket (out) axis; nb = data.ndim - len(parity) leading batch axes."""
    data: torch.Tensor
    parity: tuple
    dual: tuple

    def __post_init__(self):
        object.__setattr__(self, "parity",
                           tuple(_ptuple(p) for p in self.parity))
        object.__setattr__(self, "dual", tuple(bool(d) for d in self.dual))

    @property
    def ndim(self):
        return len(self.parity)

    @property
    def nb(self):
        return self.data.dim() - len(self.parity)

    @property
    def shape(self):
        return tuple(self.data.shape[self.nb:])


def even_parity(dim: int) -> tuple:
    return (0,) * dim


def split_parity(d_even: int, d_odd: int) -> tuple:
    """Canonical sorted bond layout: [even block | odd block]."""
    return (0,) * d_even + (1,) * d_odd


def parity_mask(t: GT) -> np.ndarray:
    """0/1 mask [graded axes] of the parity-conserving entries."""
    tot = np.zeros(t.shape, dtype=np.int64)
    for ax, p in enumerate(t.parity):
        shape = [1] * t.ndim
        shape[ax] = len(p)
        tot = tot + np.asarray(p).reshape(shape)
    return (tot % 2 == 0).astype(np.int64)


def project_even(t: GT) -> GT:
    """Zero out the parity-violating entries."""
    return GT(t.data * torch.as_tensor(parity_mask(t), dtype=t.data.dtype,
                                       device=t.data.device),
              t.parity, t.dual)


def _pair_sign(p_a, p_b) -> np.ndarray:
    """(-1)^{p_a x p_b} as a rank-2 array [len(p_a), len(p_b)]."""
    return 1.0 - 2.0 * (np.outer(p_a, p_b) % 2)


def _mask(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def _axis_sign(data, parity, axis, ndim):
    """data times (-1)^parity along graded axis ``axis`` of ``ndim``."""
    shape = [1] * ndim
    shape[axis] = len(parity)
    s = (1.0 - 2.0 * (np.asarray(parity) % 2)).reshape(shape)
    return data * _mask(s, data)


def gtranspose(t: GT, perm) -> GT:
    """Graded transpose: transpose times the Koszul sign of every pair of
    axes whose order ``perm`` inverts."""
    perm = tuple(perm)
    n, nb = t.ndim, t.nb
    assert sorted(perm) == list(range(n)), perm
    sign = np.ones(t.shape)
    for i in range(n):
        for j in range(i + 1, n):
            if perm.index(i) > perm.index(j):
                m = _pair_sign(t.parity[i], t.parity[j])
                shape = [1] * n
                shape[i], shape[j] = len(t.parity[i]), len(t.parity[j])
                sign = sign * m.reshape(shape)
    data = t.data if np.all(sign == 1.0) else t.data * _mask(sign, t.data)
    data = data.permute(tuple(range(nb)) + tuple(nb + p for p in perm))
    return GT(data, tuple(t.parity[p] for p in perm),
              tuple(t.dual[p] for p in perm))


def operator_gt(mat4: torch.Tensor, p_out1, p_out2, p_in1, p_in2) -> GT:
    """Two-site operator as a graded tensor from ORDERED matrix elements
    mat4[..., a', b', a, b] = <a' b'| G |a b>: the bra side carries the
    reversal sign (-1)^{p(a) p(b)}. Axes (out1, out2, in1, in2), arrows
    (ket, ket, bra, bra)."""
    sign = 1.0 - 2.0 * (np.outer(np.asarray(p_in1), np.asarray(p_in2)) % 2)
    data = mat4 * _mask(sign[None, None, :, :], mat4)
    return GT(data, (tuple(p_out1), tuple(p_out2), tuple(p_in1),
                     tuple(p_in2)), (False, False, True, True))


def gconj(t: GT) -> GT:
    """Dagger without transposition: conjugate the data, flip the arrows."""
    return GT(t.data.conj().resolve_conj(), t.parity,
              tuple(not d for d in t.dual))


def gcontract(a: GT, axes_a, b: GT, axes_b) -> GT:
    """Graded tensordot of a.axes_a[k] with b.axes_b[k]: Koszul signs of
    moving a's contracted axes last and b's first (reversed), and (-1)^p on
    every pair whose a-member is primal. Both operands may carry leading
    batch axes, which broadcast."""
    axes_a, axes_b = tuple(axes_a), tuple(axes_b)
    assert len(axes_a) == len(axes_b)
    for ia, ib in zip(axes_a, axes_b):
        assert a.parity[ia] == b.parity[ib], (
            f"parity mismatch: axis {ia} {a.parity[ia]} vs axis {ib} "
            f"{b.parity[ib]}")
        assert a.dual[ia] != b.dual[ib], (
            f"arrow mismatch on contraction pair ({ia},{ib})")
    free_a = tuple(i for i in range(a.ndim) if i not in axes_a)
    free_b = tuple(i for i in range(b.ndim) if i not in axes_b)
    ta = gtranspose(a, free_a + axes_a)
    tb = gtranspose(b, tuple(reversed(axes_b)) + free_b)
    da = ta.data
    for k, ia in enumerate(axes_a):
        if not a.dual[ia]:
            da = _axis_sign(da, a.parity[ia], len(free_a) + k, ta.ndim)
    k = len(axes_a)
    ca = int(np.prod([len(a.parity[i]) for i in axes_a], initial=1))
    fa = ta.shape[:len(free_a)]
    fb = tb.shape[k:]
    nbb = tb.nb
    # b's leading contracted axes reversed back into a's order
    mb = tb.data.permute(tuple(range(nbb))
                         + tuple(nbb + k - 1 - i for i in range(k))
                         + tuple(range(nbb + k, nbb + tb.ndim)))
    out = da.reshape(*da.shape[:ta.nb], -1, ca) \
        @ mb.reshape(*mb.shape[:nbb], ca, -1)
    out = out.reshape(*out.shape[:-2], *fa, *fb)
    return GT(out,
              tuple(a.parity[i] for i in free_a)
              + tuple(b.parity[i] for i in free_b),
              tuple(a.dual[i] for i in free_a)
              + tuple(b.dual[i] for i in free_b))


def fuse(t: GT, n_leading: int) -> GT:
    """Fuse the first ``n_leading`` graded axes into one (row-major), XOR
    parities. The fused axes share one arrow; a DUAL group carries the
    intra-group pair signs, so that gcontract(fuse(a), fuse(b)) equals the
    multi-axis contraction."""
    assert all(d == t.dual[0] for d in t.dual[:n_leading]), \
        "fuse group must have a uniform arrow"
    nb = t.nb
    dims = t.shape[:n_leading]
    ps = [np.asarray(p) for p in t.parity[:n_leading]]
    fused = np.zeros(dims, dtype=np.int64)
    for ax, p in enumerate(ps):
        shape = [1] * n_leading
        shape[ax] = len(p)
        fused = fused + p.reshape(shape)
    fused = (fused % 2).reshape(-1)
    data = t.data
    if t.dual[0]:
        sign = np.ones(dims)
        for i in range(n_leading):
            for j in range(i + 1, n_leading):
                shape = [1] * n_leading
                shape[i], shape[j] = len(ps[i]), len(ps[j])
                sign = sign * _pair_sign(ps[i], ps[j]).reshape(shape)
        data = data * _mask(sign.reshape(dims + (1,) * (t.ndim - n_leading)),
                            data)
    data = data.reshape(*data.shape[:nb], -1, *t.shape[n_leading:])
    return GT(data, (_ptuple(fused),) + t.parity[n_leading:],
              (t.dual[0],) + t.dual[n_leading:])


# ---------------------------------------------------------------------------
# graded linear algebra (blockwise, static parity split), batched over
# leading axes
# ---------------------------------------------------------------------------

def _block_masks(pr, pc):
    pr, pc = np.asarray(pr), np.asarray(pc)
    return (np.outer(1 - pr, 1 - pc).astype(np.float64),
            np.outer(pr, pc).astype(np.float64))


def graded_svd_truncated(m: torch.Tensor, pr, pc, d_even: int, d_odd: int):
    """Truncated SVD of parity-even matrices [..., R, C] (row parity pr,
    column parity pc) keeping a static (d_even, d_odd) split of the new
    bond. Returns (u [..., R, D], s [..., D], vt [..., D, C], trunc_err
    [...], new parity) with the new bond laid out [even | odd]; u @ diag(s)
    @ vt reconstructs m by a plain matmul."""
    ee, oo = _block_masks(pr, pc)
    ue, se, vte = torch.linalg.svd(m * _mask(ee, m), full_matrices=False)
    uo, so, vto = torch.linalg.svd(m * _mask(oo, m), full_matrices=False)
    k = se.shape[-1]
    assert d_even <= k and d_odd <= k, (d_even, d_odd, k)
    pr_np, pc_np = np.asarray(pr, np.float64), np.asarray(pc, np.float64)
    ue = ue * _mask(1.0 - pr_np, m)[:, None]
    vte = vte * _mask(1.0 - pc_np, m)[None, :]
    uo = uo * _mask(pr_np, m)[:, None]
    vto = vto * _mask(pc_np, m)[None, :]
    u = torch.cat([ue[..., :d_even], uo[..., :d_odd]], -1)
    s = torch.cat([se[..., :d_even], so[..., :d_odd]], -1)
    vt = torch.cat([vte[..., :d_even, :], vto[..., :d_odd, :]], -2)
    total = (se ** 2).sum(-1) + (so ** 2).sum(-1)
    kept = (s ** 2).sum(-1)
    terr = (total - kept) / torch.clamp(total, min=torch.finfo(se.dtype).tiny)
    return u, s, vt, terr, split_parity(d_even, d_odd)


def charged_svd_truncated(m: torch.Tensor, row_masks, col_masks,
                          keep: tuple):
    """U(1)-charge-resolved truncated SVD of m [..., R, C]: row_masks /
    col_masks [..., S, R] / [..., S, C] 0/1 select each of the S flux
    sectors' rows / columns, keep the per-sector kept counts (sum D). Each
    sector is an SVD of the masked matrix with its vectors re-masked, so
    truncation cannot move weight between sectors. Returns (u [..., R, D],
    s [..., D], vt [..., D, C], trunc_err [...])."""
    row_masks = torch.as_tensor(row_masks, device=m.device)
    col_masks = torch.as_tensor(col_masks, device=m.device)
    us, ss, vts = [], [], []
    total = None
    for sidx, cnt in enumerate(keep):
        rm = row_masks[..., sidx, :].to(m.dtype)
        cm = col_masks[..., sidx, :].to(m.dtype)
        u, s, vt = torch.linalg.svd(m * rm[..., :, None] * cm[..., None, :],
                                    full_matrices=False)
        part = (s ** 2).sum(-1)
        total = part if total is None else total + part
        assert cnt <= s.shape[-1], (sidx, cnt, s.shape)
        us.append(u[..., :cnt] * rm[..., :, None])
        ss.append(s[..., :cnt])
        vts.append(vt[..., :cnt, :] * cm[..., None, :])
    u, s, vt = torch.cat(us, -1), torch.cat(ss, -1), torch.cat(vts, -2)
    kept = (s ** 2).sum(-1)
    terr = (total - kept) / torch.clamp(total, min=torch.finfo(s.dtype).tiny)
    return u, s, vt, terr


def sector_qr(m: torch.Tensor, col_idx, row_masks):
    """Charge-sector QR of covariant matrices m [..., R, C]: col_idx the
    static per-sector column index tuples, row_masks [..., T, R] 0/1 each
    sector's rows. Returns (q [..., R, K], r [..., K, C]), K the total of
    the sectors' columns, inner bond laid out sector-major; q @ r = m on
    the sector support and q's columns lie on their sector's rows."""
    row_masks = torch.as_tensor(row_masks, device=m.device)
    c = m.shape[-1]
    k = sum(len(cols) for cols in col_idx)
    qs = []
    r_full = torch.zeros(*m.shape[:-2], k, c, dtype=m.dtype, device=m.device)
    off = 0
    for t, cols in enumerate(col_idx):
        cols_t = torch.as_tensor(cols, dtype=torch.int64, device=m.device)
        rm = row_masks[..., t, :].to(m.dtype)
        qt, rt = torch.linalg.qr(m[..., cols_t] * rm[..., :, None],
                                 mode="reduced")
        qs.append(qt * rm[..., :, None])
        r_full[..., off:off + len(cols), :][..., cols_t] = rt
        off += len(cols)
    return torch.cat(qs, -1), r_full


def sector_lq(m: torch.Tensor, row_idx, col_masks):
    """LQ counterpart of sector_qr: m = l @ q (plain matmul), l [..., R, K]
    holding the sector rows and q [..., K, C] masked to each sector's
    columns; the plain transpose of sector_qr on m^T."""
    q2, r2 = sector_qr(m.mT, row_idx, col_masks)
    return r2.mT, q2.mT


def graded_qr(m: torch.Tensor, pr, pc):
    """Blockwise QR of parity-even matrices [..., R, C]. Returns (q, r,
    bond parity): q [..., R, 2k], r [..., 2k, C], bond laid out
    [even | odd]; plain matmul reconstructs."""
    pr_np = np.asarray(pr, np.float64)
    ee, oo = _block_masks(pr, pc)
    qe, re = torch.linalg.qr(m * _mask(ee, m), mode="reduced")
    qo, ro = torch.linalg.qr(m * _mask(oo, m), mode="reduced")
    k = qe.shape[-1]
    q = torch.cat([qe * _mask(1.0 - pr_np, m)[:, None],
                   qo * _mask(pr_np, m)[:, None]], -1)
    return q, torch.cat([re, ro], -2), split_parity(k, k)
