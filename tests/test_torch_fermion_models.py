"""The port's fermionic models (peps_tpu_torch.models.fermion, its copy of
the reference's numpy module) and graded bond Hamiltonians
(peps_tpu_torch.fermion.gates) against the JAX package: every channel
table, conservation mask and gate equal, and FermionTensors grouping the
channels as the reference does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peps_tpu.algorithm.energy_fermion import FermionTensors as JFT
from peps_tpu.fermion import gates as j_gates
from peps_tpu.models import fermion as j_fermion
from peps_tpu_torch.algorithm.energy_fermion import FermionTensors
from peps_tpu_torch.fermion import gates
from peps_tpu_torch.models import fermion

MODELS = {
    "spinless": lambda m: m.spinless_fermion(1.0, 0.5, 0.3, t2=-0.4),
    "spinless_no_t2": lambda m: m.spinless_fermion(1.0, 0.5),
    "tj": lambda m: m.tj_model(3.0, 1.0, mu=0.2, t2=0.7, v=0.1),
    "tj_plain": lambda m: m.tj_model(),
    "hubbard": lambda m: m.hubbard(1.0, 8.0, mu=0.5),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_channel_tables_equal_reference(name):
    ref, out = MODELS[name](j_fermion), MODELS[name](fermion)
    assert out.phys_dim == ref.phys_dim and out.spinless == ref.spinless
    assert out.name == ref.name
    for f in ("n_up", "n_dn"):
        assert np.array_equal(getattr(out, f), getattr(ref, f))
    assert (out.h_site is None) == (ref.h_site is None)
    if ref.h_site is not None:
        assert np.array_equal(out.h_site, ref.h_site)
    for f in ("channels_h", "channels_v", "channels_d", "channels_ad"):
        a, b = getattr(out, f), getattr(ref, f)
        assert len(a) == len(b), f
        for ca, cb in zip(a, b):
            assert ca.string == cb.string and np.array_equal(ca.h, cb.h), f
    for orient in ("h", "v"):
        assert np.array_equal(gates.bond_h2(out, orient),
                              j_gates.bond_h2(ref, orient))
    pp = [int(ref.n_up[i] + ref.n_dn[i]) % 2 for i in range(ref.phys_dim)]
    h2 = gates.bond_h2(out, "h")
    assert np.array_equal(gates.swap_gate_sites(h2, pp),
                          np.asarray(j_gates.swap_gate_sites(h2, pp)))
    for dtype in (torch.float64, torch.complex128):
        ft = FermionTensors.from_model(out, dtype, "cpu")
        jft = JFT.from_model(ref, jnp.complex128 if dtype.is_complex
                             else jnp.float64)
        assert ft.has_diag == jft.has_diag and ft.spinless == jft.spinless
        assert ft.n_up.dtype == torch.float64
        for f in (f"h_{o}_{k}" for o in ("h", "v", "d", "ad")
                  for k in ("none", "up", "dn")):
            a, b = getattr(ft, f), getattr(jft, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == dtype and np.array_equal(a.numpy(),
                                                           np.asarray(b)), f


def test_conserve_masks_equal_reference():
    assert fermion.hubbard_conserve_mask() == j_fermion.hubbard_conserve_mask()
    assert fermion.tj_conserve_mask() == j_fermion.tj_conserve_mask()
