"""Chain-batched sampling helpers (port of the main-path part of
``peps_tpu/montecarlo/engine.py``): configurations [nc, Ly, Lx] int64 on the
device, the chain axis leading."""
from __future__ import annotations

import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.tps import project


def init_configs_occupancy(generator: torch.Generator, nchains: int, ly: int,
                           lx: int, occupancy: dict[int, int],
                           device=None) -> torch.Tensor:
    """Random configurations with exact per-state occupation counts: one
    random permutation of the occupancy list per chain."""
    base = []
    for state, count in sorted(occupancy.items()):
        base.extend([state] * count)
    if len(base) != ly * lx:
        raise ValueError(
            f"occupancy counts sum to {len(base)} but the lattice has "
            f"{ly * lx} sites ({ly}x{lx}); occupancy={occupancy!r}")
    device = resolve_device(device)
    base = torch.tensor(base, dtype=torch.int64, device=device)
    keys = torch.rand(nchains, ly * lx, generator=generator, device=device)
    return base[torch.argsort(keys, dim=1)].reshape(nchains, ly, lx)


def init_configs_uniform(generator: torch.Generator, nchains: int, ly: int,
                         lx: int, d: int, device=None) -> torch.Tensor:
    return torch.randint(0, d, (nchains, ly, lx), generator=generator,
                         device=resolve_device(device))


def amplitudes(tps, configs, chi: int, trunc: TruncParams):
    """(mantissa [nc], log_weight [nc]) per chain."""
    return bmps.amplitude(project(tps, configs), chi, trunc)


def ensure_validity(tps, configs, generator: torch.Generator, chi: int,
                    trunc: TruncParams):
    """Replace zero-amplitude chains with copies of random healthy chains.
    Returns (configs, n_rescued tensor); no host sync."""
    mant, _ = amplitudes(tps, configs, chi, trunc)
    valid = mant != 0
    n_valid = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    u = torch.rand(configs.shape[0], generator=generator,
                   device=configs.device, dtype=torch.float64)
    donors = (u * torch.clamp(n_valid, min=1)).long()
    rescued = torch.where(valid[:, None, None], configs, configs[order[donors]])
    return rescued, configs.shape[0] - n_valid


def normalize_state_order1(tps, configs, chi: int, trunc: TruncParams):
    """Rescale the TPS so that the largest sampled |psi| is O(1)."""
    mant, logw = amplitudes(tps, configs, chi, trunc)
    log_abs = torch.log(torch.clamp(mant.abs(), min=1e-300)) + logw
    n_sites = tps.shape[0] * tps.shape[1]
    return tps * torch.exp(-log_abs.max() / n_sites)
