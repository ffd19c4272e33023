"""Shared inputs of the fermion parity tests (tests/test_torch_fermion_*.py):
random parity-even graded TPS from a numpy seed, and the sweep uniforms the
reference's graded samplers draw from their keys."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from peps_tpu.fermion.graded import GT as JGT, parity_mask as j_parity_mask
from peps_tpu.fermion.sweep import _bond_key
from peps_tpu.lattice import boundary_mask


def random_graded_tps(rng, ly, lx, space, complex_=False):
    """Gaussian parity-even site tensors [Ly, Lx, d, D, D, D, D] of space,
    boundary slots zero; complex with complex_."""
    d, D = len(space.phys_parity), space.bond_dim
    pm = j_parity_mask(JGT(jnp.zeros((d,) + (D,) * 4),
                           (space.phys_parity,) + (space.bond_parity,) * 4,
                           (False, True, True, False, False)))
    shape = (ly, lx, d) + (D,) * 4
    arr = rng.standard_normal(shape)
    if complex_:
        arr = arr + 1j * rng.standard_normal(shape)
    return arr * pm * boundary_mask(ly, lx, d, D)


def hole_configs(rng, nc, ly, lx, counts):
    """nc random arrangements of the local states with counts {state: n}."""
    base = np.concatenate([np.full(n, s) for s, n in sorted(counts.items())])
    return np.stack([rng.permutation(base).reshape(ly, lx)
                     for _ in range(nc)]).astype(np.int32)


def graded_sweep_uniforms(chain_keys, ly, lx):
    """(u_h [nc, Ly, Lx-1], u_v [nc, Lx, Ly-1]) that the reference's
    mc_sweep_fermion_shared draws from each chain key: split into (key,
    kh, kv), one uniform per bond from fold_in(fold_in(fold_in(k, pass),
    y), x), x the kernel position (fermion/sweep.py:90,310,326-329)."""
    def one(key):
        _, kh, kv = jax.random.split(key, 3)
        uh = jnp.stack([jnp.stack([
            jax.random.uniform(_bond_key(kh, 0, y, x), (), jnp.float64)
            for x in range(lx - 1)]) for y in range(ly)])
        uv = jnp.stack([jnp.stack([
            jax.random.uniform(_bond_key(kv, 1, y, x), (), jnp.float64)
            for y in range(ly - 1)]) for x in range(lx)])
        return uh, uv
    uh, uv = jax.jit(jax.vmap(one))(chain_keys)
    return torch.as_tensor(np.array(uh)), torch.as_tensor(np.array(uv))


def full_sweep_uniforms(chain_keys, n_bonds):
    """[nc, n_bonds]: the uniforms the reference's full-recompute
    mc_sweep_fermion draws, (key, k) = split(key) per bond
    (fermion/vmc.py:341-344)."""
    def one(key):
        out = []
        for _ in range(n_bonds):
            key, k = jax.random.split(key)
            out.append(jax.random.uniform(k, (), jnp.float64))
        return jnp.stack(out)
    return torch.as_tensor(np.array(jax.jit(jax.vmap(one))(chain_keys)))
