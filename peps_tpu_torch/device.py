"""Where the port's entry points put their tensors.

Every entry point that creates tensors takes ``device=None``, which means the
current CUDA device: the port is written for the card. A CPU run asks for it
with ``device="cpu"``; without a CUDA device, ``None`` raises instead of
falling back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "peps_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())

