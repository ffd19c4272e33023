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


def require_real_on_card(tps: torch.Tensor, entry: str) -> None:
    """A complex TPS runs on the CPU only: the card's kernels take float32
    and float64. Raise one clear error at an entry point instead of a
    TypeError deep inside the first column transfer."""
    if tps.is_complex() and tps.device.type == "cuda":
        raise NotImplementedError(
            f"{entry}: a complex TPS ({tps.dtype}) does not run on the card "
            "yet, the CUDA kernels take float32/float64 (ROADMAP queue 2, "
            "item 1: complex dtypes for K1 and K2); pass a real TPS or run "
            "on the CPU")
