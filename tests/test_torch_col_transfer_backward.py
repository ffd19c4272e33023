"""K1's backward on the CPU: the plain version (what the kernel
csrc/col_transfer_backward.cu computes on the card) against jax.vjp of the
reference's transfers (peps_tpu/contraction/bmps.py:_col_transfer_left and
_col_transfer_right), and the launch plans of the backward kernel and of
K5 (bmps_overlap).

Inputs are made with numpy from a seed. The operands are broadcast as the
graded holes broadcast them: one per item, one with a size-1 batch dim,
one shared by the whole batch (batch stride 0); every subset of gradients
is asked for through ColTransferFunction under autograd. torch's gradient
of a complex function is the conjugate of JAX's vjp of the conjugate
cotangent. Tolerances: 1e-10 relative in float64 and complex128 (round-off
of two summation orders), 1e-5 in float32.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.contraction import bmps as jb
from peps_tpu_torch.kernels import bmps_overlap as k5
from peps_tpu_torch.kernels import col_transfer as k1
from peps_tpu_torch.kernels import col_transfer_backward as kb

# a, l, c, u, A, d, r, C: all different, so that a mixed-up index fails
SIZES = dict(a=3, l=2, c=4, u=2, A=5, d=3, r=2, C=3)
NEEDS = [n for n in itertools.product((False, True), repeat=4) if any(n)]
TOL = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5}


def _operands(dtype, form):
    """env (per item, batch 2 x 3), top (size-1 batch dim 0), site (no
    batch: shared), bot (size-1 batch dim 1), the cotangent g; the right
    form's env is [A, r, C] and its top / site / bot are the reference's
    own layouts."""
    s = SIZES
    rng = np.random.default_rng(7 + (form == "right"))

    def r(*shape):
        x = rng.standard_normal(shape)
        if dtype == "complex128":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    env = r(2, 3, s["a"], s["l"], s["c"]) if form == "left" else \
        r(2, 3, s["A"], s["r"], s["C"])
    top = r(1, 3, s["a"], s["u"], s["A"])
    site = r(s["u"], s["l"], s["d"], s["r"])
    bot = r(2, 1, s["c"], s["d"], s["C"])
    g = r(2, 3, s["A"], s["r"], s["C"]) if form == "left" else \
        r(2, 3, s["a"], s["l"], s["c"])
    return env, top, site, bot, g


@functools.lru_cache(maxsize=None)
def _reference(dtype, form):
    """JAX's four gradients, in torch's convention, as numpy arrays of the
    operands' shapes."""
    env, top, site, bot, g = _operands(dtype, form)
    fn = jb._col_transfer_left if form == "left" else jb._col_transfer_right
    # inner batch dim (3): env, top per item, site and bot shared; outer
    # (2): env and bot per item, top and site shared
    f = jax.vmap(jax.vmap(fn, in_axes=(0, 0, None, None)),
                 in_axes=(0, None, None, 0))
    _, vjp = jax.vjp(f, jnp.asarray(env), jnp.asarray(top[0]),
                     jnp.asarray(site), jnp.asarray(bot[:, 0]))
    ge, gt, gs, gb = (np.conj(np.asarray(x))
                      for x in vjp(jnp.asarray(np.conj(g))))
    return ge, gt[None], gs, gb[:, None]


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
@pytest.mark.parametrize("form", ["left", "right"])
@pytest.mark.parametrize("needs", NEEDS,
                         ids=["".join("etsb"[i] for i in range(4) if n[i])
                              for n in NEEDS])
def test_plain_backward_matches_jax_vjp(dtype, form, needs):
    """Every requested gradient of ColTransferFunction (CPU: the plain
    backward) against jax.vjp of the reference's transfer, with broadcast
    operands reduced to their own shapes; no kernel launched."""
    env, top, site, bot, g = _operands(dtype, form)
    ref = _reference(dtype, form)
    xs = [torch.as_tensor(x).requires_grad_(n)
          for x, n in zip((env, top, site, bot), needs)]

    def transfer(*ops):
        return k1.ColTransferFunction.apply(*ops)

    before = (kb.col_transfer_backward.launches, k1.col_transfer.launches)
    out = transfer(*xs) if form == "left" else \
        k1.col_transfer_right(*xs, transfer=transfer)
    req = [x for x in xs if x.requires_grad]
    grads = iter(torch.autograd.grad(out, req, torch.as_tensor(g)))
    assert (kb.col_transfer_backward.launches,
            k1.col_transfer.launches) == before
    for need, r in zip(needs, ref):
        if not need:
            continue
        got = next(grads).detach().numpy()
        assert got.shape == r.shape
        assert np.abs(got - r).max() <= TOL[dtype] * np.abs(r).max()


def test_backward_wrapper_on_the_cpu_is_the_plain_chain():
    """col_transfer_backward on CPU tensors returns the plain chain's
    gradients, None where not asked for, and counts no launch."""
    env, top, site, bot, g = (torch.as_tensor(x)
                              for x in _operands("float64", "left"))
    needs = (True, False, True, True)
    before = kb.col_transfer_backward.launches
    got = kb.col_transfer_backward(g, env, top, site, bot, needs)
    ref = kb.col_transfer_backward_plain(g, env, top, site, bot, needs)
    assert kb.col_transfer_backward.launches == before
    assert got[1] is None
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------------------- the plans

def _meta(shapes, needs, dtype=torch.float32, expand=None):
    """The plan and meta of operands of ``shapes``; ``expand``: the batch
    shape to which env and top are expanded (stride-0 views)."""
    env, top, site, bot = (torch.empty(s, dtype=dtype) for s in shapes)
    if expand is not None:
        env, top = (t.expand(*expand, *t.shape[-3:]) for t in (env, top))
    batch = torch.broadcast_shapes(env.shape[:-3], top.shape[:-3],
                                   site.shape[:-4], bot.shape[:-3])
    g = torch.empty(*batch, top.shape[-1], site.shape[-1], bot.shape[-1],
                    dtype=dtype)
    plan, meta = kb.launch_meta(g, env, top, site, bot, needs)
    return plan, list(meta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_backward_plan_groups_and_scratch(dtype):
    """The groups of the graded holes' calls: the sketch V scan (the block
    in bot, broadcast but not differentiated: one item a group, 8 groups,
    clusters of 8), the pair traces (env, top, bot broadcast over 3
    candidates: groups of 3, 240 of them, which fill the card with a CTA
    each, at most two CTAs an SM), and a shared site (one group of every
    item); the scratch holds X, P, R, F only where a requested gradient
    needs them; the shared bytes count the k tables at the largest K; P
    and R are one per run where env and top share their broadcast."""
    chi, D = 32, 8
    env, site = (chi, D, chi), (D, D, D, D)
    plan, meta = _meta(((8,) + env, (8,) + env, (8,) + site, env),
                       (True, True, True, False), dtype)
    assert (plan["group_items"], plan["groups"], plan["cluster"],
            plan["clusters"]) == (1, 8, 8, 8)
    assert kb.kmax_of(plan["dims"]) == chi * chi
    assert meta[kb.META_LEN - 15:kb.META_LEN - 11] == [0, 0, 0, 0]
    x = chi * D * chi * D
    assert plan["scratch_offsets"] == [0, x, 2 * x, 0]
    assert plan["scratch"] == 8 * 3 * x
    assert plan["smem_bytes"] == kb.smem_bytes(dtype, chi * chi) \
        <= k1.SMEM_PER_BLOCK
    pair = ((8, 6, 5, 1) + env, (8, 6, 5, 1) + env, (8, 6, 5, 3) + site,
            (8, 6, 5, 1) + env)
    plan, meta = _meta(pair, (True,) * 4, dtype)
    assert (plan["group_items"], plan["groups"], plan["cluster"]) == \
        (3, 240, 1)
    assert plan["share"] and meta[-1] == 1     # env and top alike
    assert plan["ctas"] <= 2 * kb.H100_SMS
    assert plan["scratch"] == plan["clusters"] * 3 * 4 * x
    plan, _ = _meta(((5,) + env, (5,) + env, site, (5,) + env),
                    (False, False, True, False), dtype)
    assert (plan["group_items"], plan["groups"]) == (5, 1)
    assert plan["scratch_offsets"][2:] == [0, 0]


def test_backward_meta_layout_and_merged_batch(monkeypatch):
    """The meta: merged batch sizes first (a size-1 dim dropped, padded to
    four), then nine tensors' batch strides (a gradient's 0 where its
    operand is broadcast), the inner strides, the sizes, the needs, the
    group flags and the plan (the last: whether env and top share their
    broadcast), META_LEN values in all; the plan's cluster size rides in
    the meta."""
    plan_fn = kb.backward_plan
    monkeypatch.setattr(kb, "backward_plan", lambda *a, **k: plan_fn(
        *a, **{**k, "cluster": 2}))
    monkeypatch.setattr(kb, "_META_CACHE", {})
    plan, meta = _meta(((1, 3, 7, 3, 9), (4, 3, 7, 2, 6), (4, 1, 2, 3, 5, 3),
                        (4, 3, 9, 5, 11)), (True, False, True, True))
    assert len(meta) == kb.META_LEN
    assert meta[:4] == [1, 1, 4, 3]
    strides = [meta[4 + 4 * i:8 + 4 * i] for i in range(9)]
    assert strides[0][2:] == [0, 7 * 3 * 9]            # env over dim 0
    assert strides[2][2:] == [2 * 3 * 5 * 3, 0]        # site over dim 1
    assert strides[5][2:] == [0, 7 * 3 * 9]            # genv like env
    assert strides[6] == [0, 0, 0, 0]                  # gtop not asked for
    assert meta[64:68] == [1, 0, 1, 1]
    assert meta[68:72] == [0, 0, 1, 1]                 # both dims group
    assert (plan["group_items"], plan["groups"], plan["cluster"]) == \
        (12, 1, 2)
    assert meta[72:75] == [2, 1, 12]
    assert meta[-1] == 0 and not plan["share"]   # env and top differ


@pytest.mark.parametrize("needs", [(True, True, True, True),
                                   (True, False, False, True),
                                   (False, True, False, True),
                                   (False, False, True, True)],
                         ids=["etsb", "eb", "tb", "sb"])
def test_backward_share_only_where_the_gradients_share_the_run(needs):
    """P and R are one per run of env's broadcast (the plan's share) only
    where env and top are broadcast over the same group dims and every
    requested env or top gradient is reduced over them too. env and top
    expanded (stride 0, size 3) over a dim on which bot (size 1) needs its
    gradient: that dim is a group dim, but the env and top gradients are
    per item there, so R must not be summed over it; where neither is
    asked for, P alone is shared. Sizes are the pair traces' (8 x 3
    items)."""
    shapes = ((8, 1, 3, 2, 4), (8, 1, 3, 2, 5), (8, 3, 2, 2, 3, 2),
              (8, 1, 4, 3, 3))
    plan, meta = _meta(shapes, needs, expand=(8, 3))
    assert meta[kb.META_LEN - 15:kb.META_LEN - 11] == [0, 0, 0, 1]
    assert (plan["group_items"], plan["groups"]) == (3, 8)
    assert plan["share"] == (not (needs[0] or needs[1])) and \
        meta[-1] == int(plan["share"])
    # the same operands not expanded (size 1): the gradients share the run
    plan, meta = _meta(shapes, needs)
    assert plan["share"] and meta[-1] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("chi", [8, 16, 32, 37, 48, 64])
def test_overlap_plan_fits_and_shares_the_bottom(dtype, chi):
    """K5's plan at the column walker's per-k shape (5 start lanes sharing
    a b slab, 192 groups): the staged body wherever its buffers fit a CTA
    (all but complex128 at chi = 64), lanes a CTA between 1 and the
    group's 5, its shared bytes as the kernel counts them; chi padded to
    a multiple of 16; at the main path's chi = 32 one lane a CTA, two in
    complex128, where one CTA fills an SM (the lanes that timed fastest
    on the H100)."""
    plan = k5.overlap_plan(dtype, chi, 5, 192)
    if chi == 32:
        assert plan["lanes"] == (2 if dtype == torch.complex128 else 1)
    if dtype == torch.complex128 and chi > 48:
        assert plan["body"] == "simple"
        return
    assert plan["body"] == "staged"
    assert plan["chi_p"] == -(-chi // 16) * 16
    assert 1 <= plan["lanes"] <= 5
    assert plan["smem_bytes"] == k5.staged_smem(
        dtype, plan["chi_p"], plan["lanes"], plan["nbuf"]) \
        <= k5.SMEM_PER_BLOCK
    assert plan["ctas"] == 192 * -(-5 // plan["lanes"])


def test_overlap_meta_finds_the_lanes():
    """The lane dims are those over which b is broadcast and a is not: the
    flagship's start-bond dim (a [8, 5, 6, 4, ...], b [8, 1, 6, 4, ...];
    the batch merged to [8, 5, 24])."""
    lx, chi, D = 6, 32, 8
    a = torch.zeros(8, 5, 6, 4, lx, chi, D, chi)
    b = torch.zeros(8, 1, 6, 4, lx, chi, D, chi)
    batch, _, _, meta = k5.launch_meta(a, b)
    assert list(batch) == [8, 5, 6, 4]
    assert meta[:4] == [1, 8, 5, 24]           # the last two dims merged
    assert meta[15:19] == [0, 0, 1, 0]
    assert meta[19] == 1                       # the staged body
    assert meta[23] == 32 and len(meta) == 25
