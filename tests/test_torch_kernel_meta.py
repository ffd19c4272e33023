"""K1's and K3's launch meta caches (kernels/col_transfer.py and
kernels/pair_transfer.py:launch_meta), on the CPU: one entry per (shapes,
strides, dtype, device) signature, each equal to a fresh _meta(...)."""
import torch

from peps_tpu_torch.kernels import col_transfer as k1
from peps_tpu_torch.kernels import pair_transfer as k3


def _fresh(env, top, site, bot):
    batch = torch.broadcast_shapes(env.shape[:-3], top.shape[:-3],
                                   site.shape[:-4], bot.shape[:-3])
    return batch, k1._meta(env, top, site, bot, batch)


def test_meta_cache_keys_on_strides():
    k1._META_CACHE.clear()
    g = torch.Generator().manual_seed(0)
    env = torch.randn(5, 6, 3, 6, generator=g)
    top = torch.randn(5, 6, 3, 6, generator=g)
    top_t = torch.randn(5, 6, 3, 6, generator=g).transpose(-3, -1)
    site = torch.randn(3, 3, 3, 3, generator=g)
    bot = torch.randn(5, 6, 3, 6, generator=g)
    assert top_t.shape == top.shape and top_t.stride() != top.stride()
    a = k1.launch_meta(env, top, site, bot)
    b = k1.launch_meta(env, top_t, site, bot)
    assert len(k1._META_CACHE) == 2 and a is not b
    for ops, hit in (((env, top, site, bot), a), ((env, top_t, site, bot), b)):
        batch, meta = _fresh(*ops)
        assert hit[0] == batch and list(hit[1]) == meta
        assert k1.launch_meta(*ops) is hit          # a hit, no rebuild
    assert len(k1._META_CACHE) == 2


def test_meta_cache_keys_on_dtype_and_broadcast():
    k1._META_CACHE.clear()
    x = torch.ones(2, 4, 2, 4, dtype=torch.float64)
    s = torch.ones(2, 2, 2, 2, dtype=torch.float64)
    shared = k1.launch_meta(x, x, s, x)
    per_item = k1.launch_meta(x, x, s.expand(2, 2, 2, 2, 2), x)
    single = k1.launch_meta(x.float(), x.float(), s.float(), x.float())
    assert len(k1._META_CACHE) == 3
    assert list(shared[1]) == _fresh(x, x, s, x)[1]
    assert list(per_item[1]) == list(shared[1])      # stride 0 either way
    # strides in elements, not bytes (the plan after them counts bytes)
    n = k1.META_INTS
    assert list(single[1])[:n] == list(shared[1])[:n]


def test_meta_of_the_walker_broadcast():
    """The S+S- walker's column step (algorithm/measure.py): walkers
    [nc, Ly, Lx, ...]; top, bot and site are column x of larger stacks,
    broadcast over the start column. Three batch dims survive the merge
    (nothing is contiguous across Ly in the sliced stacks); the broadcast
    operands read the start-column dim with stride 0; a step at another
    column has the same sizes and strides (its offset travels in the data
    pointer), so it hits the same entry."""
    k1._META_CACHE.clear()
    nc, ly, lx, chi, D = 3, 2, 4, 5, 2
    g = torch.Generator().manual_seed(1)
    walkers = torch.randn(nc, ly, lx, chi, D, chi, generator=g)
    tops = torch.randn(nc, ly + 1, lx, chi, D, chi, generator=g)
    sites = torch.randn(nc, ly, lx, D, D, D, D, generator=g)
    metas = []
    for x in (1, 2):
        ops = (walkers, tops[:, :ly, x, None], sites[:, :, x, None],
               tops[:, 1:, x, None])
        batch, meta = k1.launch_meta(*ops)
        assert batch == (nc, ly, lx) and list(meta) == _fresh(*ops)[1]
        # meta: 1 pad + 3 sizes, then per operand 1 pad + 3 batch strides
        # + its own strides (3 legs, the site 4)
        assert list(meta[:4]) == [1, nc, ly, lx]
        starts = [4, 11, 18, 26]
        strides = [list(meta[i + 1:i + 4]) for i in starts]
        assert strides[0][2] == chi * D * chi
        assert all(st[2] == 0 for st in strides[1:])
        metas.append(list(meta))
        out = k1.col_transfer(*ops)
        assert torch.allclose(out, k1.col_transfer_plain(
            walkers, ops[1].expand(nc, ly, lx, chi, D, chi),
            ops[2].expand(nc, ly, lx, D, D, D, D),
            ops[3].expand(nc, ly, lx, chi, D, chi)))
    assert len(k1._META_CACHE) == 1 and metas[0] == metas[1]


def test_pair_transfer_meta_of_the_diagonal_block():
    """K3's diagonal block (algorithm/energy.py:_pair_pass): chains, row
    pairs, bonds and a candidate axis. env, top, row2 and bot are column
    slices of the stacks with a size-1 candidate axis (stride 0 after the
    broadcast); the candidate sites have no chain axis (stride 0 there).
    The right form's permuted views are a second entry; a repeat call hits
    the cache."""
    k3._META_CACHE.clear()
    nc, pairs, lx, chi, D, d = 3, 2, 4, 5, 2, 2
    g = torch.Generator().manual_seed(2)
    lefts = torch.randn(nc, pairs, lx + 1, chi, D, D, chi, generator=g)
    tops = torch.randn(nc, pairs, lx, chi, D, chi, generator=g)
    rows = torch.randn(nc, pairs, lx, D, D, D, D, generator=g)
    cands = torch.randn(pairs, lx, d, D, D, D, D, generator=g)
    nb = lx - 1
    ops = (lefts[:, :, :nb].unsqueeze(-5), tops[:, :, :nb].unsqueeze(-4),
           cands[:, :nb], rows[:, :, :nb].unsqueeze(-5),
           tops[:, :, :nb].unsqueeze(-4))
    batch, meta = k3.launch_meta(*ops)
    assert batch == (nc, pairs, nb, d)
    assert list(meta) == k3._meta(ops, batch)
    assert list(meta[:4]) == [nc, pairs, nb, d]
    # per operand: 4 batch strides then its own (env 4, top 3, rows 4, bot 3)
    starts, own = [4], (4, 3, 4, 4, 3)
    for k in own[:-1]:
        starts.append(starts[-1] + 4 + k)
    bstrides = [list(meta[i:i + 4]) for i in starts]
    assert [b[3] for b in bstrides] == [0, 0, D ** 4, 0, 0]   # candidates
    assert bstrides[2][0] == 0                                # no chain axis
    n = k3.META_INTS               # sizes, then the launch plan
    assert list(meta[n - 11:n]) == [chi, D, D, chi, D, chi, D, D, D, D, chi]
    assert k3.launch_meta(*ops) is k3.launch_meta(*ops)
    right = (ops[0],) + tuple(o.transpose(-3, -1) for o in ops[1:])
    k3.launch_meta(*right)
    assert len(k3._META_CACHE) == 2
    assert torch.allclose(
        k3.pair_transfer(*ops),
        k3.pair_transfer_plain(*(o.expand(*batch, *o.shape[-k:])
                                 for o, k in zip(ops, own))))
