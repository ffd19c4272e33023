"""Carry states and models across from the JAX package.

Each function takes the JAX package's arrays as numpy (``np.asarray`` of a
jax array) and returns the port's tensors on a given device (default: the current CUDA
device) and dtype, with
the same layouts, so both packages compute the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from peps_tpu_torch.algorithm.energy import ModelTensors
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.peps import PEPS


def tps_from_numpy(arr, device=None, dtype=None) -> torch.Tensor:
    """TPS [Ly, Lx, d, D, D, D, D] as a tensor (a copy: the JAX package's
    arrays are read-only)."""
    return torch.as_tensor(np.array(arr), dtype=dtype,
                           device=resolve_device(device))


def peps_from_numpy(gammas, lam_v, lam_h, device=None, dtype=None) -> PEPS:
    """Gamma/Lambda PEPS with the JAX layouts (gammas [Ly, Lx, d, D^4],
    lam_v [Ly+1, Lx, D], lam_h [Ly, Lx+1, D])."""
    device = resolve_device(device)
    return PEPS(*(tps_from_numpy(a, device, dtype)
                  for a in (gammas, lam_v, lam_h)))


def model_tensors_from_numpy(model, device=None, dtype=None) -> ModelTensors:
    """A JAX ``ModelTensors`` (or a ``SquareLatticeModel``), field by field."""
    return ModelTensors.from_model(model, dtype, device)


def fermion_space_from(space):
    """The port's FermionSpace of a JAX ``FermionSpace`` (static tuples)."""
    from peps_tpu_torch.fermion.peps import FermionSpace
    return FermionSpace(tuple(int(p) for p in space.phys_parity),
                        int(space.d_even), int(space.d_odd))


def u1_charges_from(charges):
    """The port's U1Charges of a JAX ``U1Charges`` (static tuples)."""
    from peps_tpu_torch.fermion.peps import U1Charges
    return U1Charges(tuple(charges.phys_charge), tuple(charges.bond_charge),
                     tuple(tuple(k) for k in charges.keep),
                     tuple(tuple(int(v) for v in row)
                           for row in charges.kappa))


def graded_state_from_numpy(gammas, lam_v, lam_h, space, charges=None,
                            device=None, dtype=None):
    """A graded state of the JAX package: its Gamma/Lambda PEPS (as numpy),
    FermionSpace and optional U1Charges -> (PEPS, FermionSpace, U1Charges
    or None) of the port."""
    return (peps_from_numpy(gammas, lam_v, lam_h, device, dtype),
            fermion_space_from(space),
            None if charges is None else u1_charges_from(charges))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
