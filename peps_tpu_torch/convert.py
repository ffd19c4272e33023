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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
