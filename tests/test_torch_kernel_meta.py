"""K1's launch meta cache (kernels/col_transfer.py:launch_meta), on the CPU:
one entry per (shapes, strides, dtype, device) signature, each equal to a
fresh _meta(...)."""
import torch

from peps_tpu_torch.kernels import col_transfer as k1


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
    assert list(single[1]) == list(shared[1])        # elements, not bytes
