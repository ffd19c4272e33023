"""Periodic-boundary contractor: real-space coarse-graining with projector
truncation (port of ``peps_tpu/contraction/pbc.py``).

Axis-aligned coarse-graining of an n x n torus network (n = 2^k or
3 * 2^k): pair (or triple) columns, truncate each doubled vertical bond
with a projector pair built from the two bond Grams (never the merged
pair tensor), normalise, transpose the frame and repeat until one site is
left, whose u-d and l-r loops are traced. Two projector schemes, as in the
reference: the exact one (SVDs of the Grams and of the bond matrix,
:func:`_bond_projectors_gram`) and ``scheme="fast"``/``"sketch"``
(jittered-Cholesky Gram factors and a randomized truncated SVD of the bond
matrix, :func:`_bond_projectors_gram_fast`). Gradient holes come from
torch autograd through the whole coarse-graining, every SVD through
:func:`~peps_tpu_torch.linalg.svd_safe`; the normalisations are detached,
so the holes are d(mantissa)/dT at fixed scales.

Every function batches over leading axes: the chains, the bonds and the
candidate pairs of the PBC local energy go through one call. The fast
scheme's Gaussian test matrix [B, k] of a bond of size B is shared by
every call, configuration and bond (ratios are formed through one fixed
truncated map); it comes from ``test_matrix(b, k, dtype, device)``,
default :func:`pbc_test_matrix` (a fixed torch generator; the bits differ
from the reference's ``PRNGKey(20260817)`` draws, which the parity tests
pass in). The products stay ``torch.matmul``/``einsum`` and the
factorizations ``torch.linalg``, as the reference left them to XLA.

Conventions: tn [..., n, n, u, l, d, r]; bond u of (y, x) pairs with bond
d of (y-1 mod n, x); l pairs with r of (y, x-1 mod n).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from peps_tpu_torch.linalg import TruncParams, svd_mask, svd_safe

PBC_SEED = 20260817

TestMatrix = Callable[[int, int, torch.dtype, torch.device], torch.Tensor]


@functools.lru_cache(maxsize=None)
def pbc_test_matrix(b: int, k: int, dtype, device) -> torch.Tensor:
    """The port's fixed Gaussian test matrix [b, k] of the fast scheme:
    drawn from a CPU ``torch.Generator`` seeded with the reference's key,
    in float64, then cast to the real dtype and moved; cached."""
    gen = torch.Generator().manual_seed(PBC_SEED)
    omega = torch.randn((b, k), generator=gen, dtype=torch.float64)
    real = torch.empty((), dtype=dtype).real.dtype
    return omega.to(dtype=real, device=device)


def _tiny(dtype) -> float:
    return torch.finfo(torch.empty((), dtype=dtype).real.dtype).tiny


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _safe_sqrt(s):
    """sqrt of s [..., k] with a machine-eps floor relative to each max and
    a zero branch whose gradient is 0 (rank-deficient Grams have exact
    zero eigenvalues after truncation)."""
    smax = s.amax(-1, keepdim=True)
    pos = s > torch.finfo(s.dtype).eps * torch.clamp(smax, min=_tiny(s.dtype))
    root = torch.sqrt(torch.where(pos, s, torch.ones_like(s)))
    return torch.where(pos, root, torch.zeros_like(s))


def _assemble_projectors(u, s, vh, r_t, l_b, chi: int, trunc: TruncParams,
                         inv_relative_eps: float):
    """The projector pair from an SVD (u, s, vh) of c = r_t @ l_b:
    p_top = l_b V S^-1/2 [..., B, chi], p_bot = S^-1/2 U^H r_t [..., chi, B],
    S^-1/2 regularised below inv_relative_eps * max s and masked by the
    truncation rule."""
    mask = svd_mask(s, TruncParams(chi, trunc.d_min, trunc.trunc_err))
    s_max = s.amax(-1, keepdim=True)
    eps = inv_relative_eps * torch.clamp(s_max, min=_tiny(s.dtype))
    big = s > eps
    s_inv_sqrt = torch.where(
        big, 1.0 / torch.sqrt(torch.where(big, s, torch.ones_like(s))),
        torch.zeros_like(s)) * mask
    sis = s_inv_sqrt.to(u.dtype)
    u_t = u * sis[..., None, :]
    v_t = sis[..., :, None] * vh
    k = s.shape[-1]
    if k >= chi:
        u_t, v_t = u_t[..., :chi], v_t[..., :chi, :]
    else:
        u_t = torch.nn.functional.pad(u_t, (0, chi - k))
        v_t = torch.nn.functional.pad(v_t, (0, 0, 0, chi - k))
    return l_b @ v_t.mH, u_t.mH @ r_t


def _bond_projectors_gram(g_top, g_bot, chi: int, trunc: TruncParams,
                          inv_relative_eps: float, test_matrix=None):
    """Projector pair of a doubled bond from its two Grams [..., B, B]
    (g_top = M_t^H M_t of the tensor above, g_bot = M_b M_b^H of the one
    below), through exact SVDs: g_top = r_t^H r_t, g_bot = l_b l_b^H, then
    the SVD of c = r_t l_b."""
    _, s_t, vh_t = svd_safe(g_top)
    r_t = _safe_sqrt(s_t).to(vh_t.dtype)[..., :, None] * vh_t
    u_b, s_b, _ = svd_safe(g_bot)
    l_b = u_b * _safe_sqrt(s_b).to(u_b.dtype)[..., None, :]
    u, s, vh = svd_safe(r_t @ l_b)
    return _assemble_projectors(u, s, vh, r_t, l_b, chi, trunc,
                                inv_relative_eps)


def _eps_rel_for(dtype) -> float:
    real = torch.empty((), dtype=dtype).real.dtype
    return 1e-12 if torch.finfo(real).bits >= 64 else 1e-5


def _jittered_cholesky(m, eps_rel: float):
    """Lower Cholesky factor of m + eps_rel I [..., n, n]. Where it fails
    (the round-off of a rank-deficient Gram can pass the reference's
    jitter, in float64 too, and the reference's amplitude is then NaN),
    the jitter grows 100-fold, up to three times; a matrix that fails them
    all gives NaN, as JAX's Cholesky, and no raise. Where the first jitter
    holds, the factor is the reference's."""
    eye = _eye(m.shape[-1], m)
    l, info = torch.linalg.cholesky_ex(m + eps_rel * eye)
    for k in range(1, 4):
        bad = info > 0
        if not bool(bad.any()):
            break
        l2, info2 = torch.linalg.cholesky_ex(m + eps_rel * 100.0 ** k * eye)
        l = torch.where(bad[..., None, None], l2, l)
        info = torch.where(bad, info2, info)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(l, float("nan")), l)


def _gram_chol_factor(g, eps_rel: float):
    """Lower L [..., B, B] with L L^H = g + eps maxdiag(g) I, exact by
    construction (the max-diagonal jitter covers float32 round-off at the
    top eigenvalue's scale)."""
    g = 0.5 * (g + g.mH)
    diag = torch.diagonal(g, dim1=-2, dim2=-1).real
    scale = torch.clamp(diag.amax(-1), min=_tiny(g.dtype))[..., None, None]
    l = _jittered_cholesky(g / scale.to(g.dtype), eps_rel)
    return l * torch.sqrt(scale).to(g.dtype)


def _orth(y, eps_rel: float):
    """Orthonormal columns of y [..., B, k]: Cholesky-QR and one
    Newton-Schulz step."""
    k = y.shape[-1]
    g = y.mH @ y
    tr = torch.diagonal(g, dim1=-2, dim2=-1).real.sum(-1)
    scale = torch.clamp(tr / k, min=_tiny(y.dtype))[..., None, None]
    l = _jittered_cholesky(g / scale.to(y.dtype), eps_rel)
    l = l * torch.sqrt(scale).to(y.dtype)
    q = torch.linalg.solve_triangular(l, y.mH, upper=False).mH
    return q @ (1.5 * _eye(k, y) - 0.5 * (q.mH @ q))


def _rand_svd(c, k: int, power_iters: int, eps_rel: float,
              test_matrix: TestMatrix):
    """Randomized truncated SVD of c [..., B, B] to rank k (subspace
    iteration from the shared test matrix, then one [k, B] SVD). Returns
    (u [..., B, k], s [..., k], vh [..., k, B])."""
    omega = test_matrix(c.shape[-1], k, c.dtype, c.device).to(c.dtype)
    q = _orth(c @ omega, eps_rel)
    for _ in range(power_iters):
        q = _orth(c @ (c.mH @ q), eps_rel)
    u_s, s, vh = svd_safe(q.mH @ c)
    return q @ u_s, s, vh


def _bond_projectors_gram_fast(g_top, g_bot, chi: int, trunc: TruncParams,
                               inv_relative_eps: float,
                               test_matrix: TestMatrix | None = None):
    """Projector pair from jittered-Cholesky Gram factors and a randomized
    truncated SVD of the bond matrix to rank chi + 16 (an exact SVD where
    that reaches the bond's size); the same assembly as the exact scheme."""
    eps_rel = _eps_rel_for(g_top.dtype)
    r_t = _gram_chol_factor(g_top, eps_rel).mH          # g_top ~ r_t^H r_t
    l_b = _gram_chol_factor(g_bot, eps_rel)             # g_bot ~ l_b l_b^H
    c = r_t @ l_b
    b = c.shape[-1]
    k = min(b, chi + 16)
    if k >= b:
        u, s, vh = svd_safe(c)
    else:
        u, s, vh = _rand_svd(c, k, max(1, trunc.rsvd_power), eps_rel,
                             test_matrix or pbc_test_matrix)
    return _assemble_projectors(u, s, vh, r_t, l_b, chi, trunc,
                                inv_relative_eps)


def _projector_fn(trunc: TruncParams):
    """The scheme's projector builder: "fast"/"sketch" matmul-and-Cholesky,
    any other scheme the exact SVDs."""
    return (_bond_projectors_gram_fast if trunc.scheme in ("fast", "sketch")
            else _bond_projectors_gram)


def _triple_columns(tn):
    """Contract column triples: [..., n, nx] -> [..., n, nx/3] with tripled
    u and d legs (the 3 * 2^k lattices)."""
    a, b, c = tn[..., :, 0::3, :, :, :, :], tn[..., :, 1::3, :, :, :, :], \
        tn[..., :, 2::3, :, :, :, :]
    m = torch.einsum("...yxulda,...yxUaDb,...yxVbEr->...yxuUVldDEr", a, b, c)
    ny, nx3 = a.shape[-6], a.shape[-5]
    du, dl, dd = a.shape[-4], a.shape[-3], a.shape[-2]
    dU, dD, dV, dE = b.shape[-4], b.shape[-2], c.shape[-4], c.shape[-2]
    return m.reshape(*m.shape[:-10], ny, nx3, du * dU * dV, dl,
                     dd * dD * dE, c.shape[-1])


def _absorb_pair(pb, a, b, pt):
    """out[c, l, e, r] = pb[c, u, U] a[u, l, d, k] b[U, k, D, r] pt[d, D, e],
    three pairwise products over leading axes."""
    t = torch.einsum("...cuU,...uldk->...cUldk", pb, a)
    t = torch.einsum("...cUldk,...UkDr->...cldDr", t, b)
    return torch.einsum("...cldDr,...dDe->...cler", t, pt)


def _pair_truncate(tn, chi: int, trunc: TruncParams, inv_relative_eps: float,
                   test_matrix=None, return_projs: bool = False):
    """Contract column pairs and truncate the doubled vertical bonds without
    forming the merged pair tensor: the bond Grams and the projector
    absorption go against the unmerged pair (a, b). tn [..., n, nx, u, l,
    d, r] -> [..., n, nx/2, chi', l, chi', r]; with return_projs also the
    absorb-ready projector grids (pb [..., n, nx/2, chi', du, dU], pt
    [..., n, nx/2, dd, dD, chi']) indexed by output node, which the
    trial/commit cache keeps."""
    a = tn[..., :, 0::2, :, :, :, :]                  # [.., y, x, u, l, d, k]
    b = tn[..., :, 1::2, :, :, :, :]                  # [.., y, x, U, k, D, r]
    du, dU, dd, dD = a.shape[-4], b.shape[-4], a.shape[-2], b.shape[-2]
    bond = dd * dD
    ta = torch.einsum("...uldk,...ulEK->...dkEK", a, a.conj())
    tb = torch.einsum("...UkDr,...UKFr->...kDKF", b, b.conj())
    g_top = torch.einsum("...dkEK,...kDKF->...dDEF", ta, tb)
    g_top = g_top.reshape(*g_top.shape[:-4], bond, bond)
    a2, b2 = torch.roll(a, -1, dims=-6), torch.roll(b, -1, dims=-6)
    sa = torch.einsum("...uldk,...VldK->...ukVK", a2, a2.conj())
    sb = torch.einsum("...UkDr,...WKDr->...UkWK", b2, b2.conj())
    g_bot = torch.einsum("...ukVK,...UkWK->...uUVW", sa, sb)
    g_bot = g_bot.reshape(*g_bot.shape[:-4], bond, bond)
    chi_eff = min(chi, bond)
    p_top, p_bot = _projector_fn(trunc)(g_top, g_bot, chi_eff, trunc,
                                        inv_relative_eps, test_matrix)
    # p_top[y, x] goes into the d legs of pair (y, x); p_bot[y, x] into the
    # u legs of pair (y+1, x)
    pb = torch.roll(p_bot, 1, dims=-4).reshape(*p_bot.shape[:-2], chi_eff,
                                               du, dU)
    pt = p_top.reshape(*p_top.shape[:-2], dd, dD, chi_eff)
    out = _absorb_pair(pb, a, b, pt)
    return (out, (pb, pt)) if return_projs else out


def _truncate_vertical_merged(m, chi: int, trunc: TruncParams,
                              inv_relative_eps: float, test_matrix=None,
                              return_projs: bool = False):
    """Projectors on every vertical bond of a merged m [..., n, nx, U, l,
    D_, r] (the 3-column path, small enough to form), absorbed:
    [..., n, nx, chi, l, chi, r]; with return_projs also the absorb-ready
    (pb [..., n, nx, chi, U], pt [..., n, nx, D_, chi]) by output node."""
    g_top = torch.einsum("...uldr,...ulEr->...dE", m, m.conj())
    m2 = torch.roll(m, -1, dims=-6)
    g_bot = torch.einsum("...uldr,...Vldr->...uV", m2, m2.conj())
    p_top, p_bot = _projector_fn(trunc)(g_top, g_bot, chi, trunc,
                                        inv_relative_eps, test_matrix)
    p_bot_u = torch.roll(p_bot, 1, dims=-4)
    out = torch.einsum("...ulDr,...Dc->...ulcr", m, p_top)
    out = torch.einsum("...ku,...ulcr->...klcr", p_bot_u, out)
    return (out, (p_bot_u, p_top)) if return_projs else out


def _transpose_frame(tn):
    """Reflect across the main diagonal: swap the lattice axes, u<->l and
    d<->r."""
    nd = tn.dim()
    lead = list(range(nd - 6))
    return tn.permute(*lead, nd - 5, nd - 6, nd - 3, nd - 4, nd - 1, nd - 2)


def _pbc_size_ok(n: int) -> bool:
    while n % 2 == 0:
        n //= 2
    return n in (1, 3)


def contract_pbc(tn: torch.Tensor, chi: int, trunc: TruncParams,
                 inv_relative_eps: float = 1e-12,
                 test_matrix: TestMatrix | None = None):
    """Contract torus networks [..., n, n, u, l, d, r] (each side 2^k or
    3 * 2^k) to scalars. Returns (mantissa [...], log_weight [...]) with
    psi = mantissa * exp(log_weight); the normalisations are detached, as
    the reference's stop_gradient."""
    ny, nx = tn.shape[-6], tn.shape[-5]
    if not (_pbc_size_ok(ny) and _pbc_size_ok(nx)):
        raise ValueError(f"contract_pbc: a {ny}x{nx} torus; each side must "
                         "be 2^k or 3*2^k")
    rdt = tn.real.dtype if tn.is_complex() else tn.dtype
    tiny = torch.finfo(rdt).tiny

    def normalize(t):
        nrm = torch.linalg.vector_norm(t, dim=(-4, -3, -2, -1), keepdim=True)
        nrm = torch.clamp(nrm, min=tiny).detach()
        return t / nrm, torch.log(nrm).sum(dim=(-6, -5, -4, -3, -2, -1))

    tn, logw = normalize(tn)
    while tn.shape[-6] > 1 or tn.shape[-5] > 1:
        nxc = tn.shape[-5]
        if nxc > 1:
            if nxc % 3 == 0 and nxc % 2 != 0:
                m = _triple_columns(tn)
                tn = _truncate_vertical_merged(m, min(chi, m.shape[-4]),
                                               trunc, inv_relative_eps,
                                               test_matrix)
            else:
                tn = _pair_truncate(tn, chi, trunc, inv_relative_eps,
                                    test_matrix)
        tn, lw = normalize(tn)
        logw = logw + lw
        tn = _transpose_frame(tn)
    t = tn[..., 0, 0, :, :, :, :]
    return torch.einsum("...ulul->...", t), logw


def amplitude_pbc(tn, chi: int, trunc: TruncParams,
                  inv_relative_eps: float = 1e-12,
                  test_matrix: TestMatrix | None = None):
    """(mantissa, log_weight) of torus networks; see :func:`contract_pbc`."""
    return contract_pbc(tn, chi, trunc, inv_relative_eps, test_matrix)


def punch_all_holes_pbc(tn, chi: int, trunc: TruncParams,
                        inv_relative_eps: float = 1e-12,
                        test_matrix: TestMatrix | None = None):
    """Every site's environment d(mantissa)/dT by autograd through the
    coarse-graining (the reference's ``jax.grad``; real networks only, as
    there). Returns (holes [..., n, n, u, l, d, r], mantissa [...],
    log_weight [...]); holes[y, x] is taken at fixed normalisations, which
    cancel in O = hole / psi."""
    if tn.is_complex():
        raise TypeError("punch_all_holes_pbc takes real networks (the "
                        "reference's holes are jax.grad of a real mantissa)")
    leaf = tn.detach().requires_grad_(True)
    with torch.enable_grad():
        mant, logw = contract_pbc(leaf, chi, trunc, inv_relative_eps,
                                  test_matrix)
        (holes,) = torch.autograd.grad(mant.sum(), leaf)
    return holes, mant.detach(), logw.detach()
