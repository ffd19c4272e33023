"""Chain-batched sampling state and helpers (port of
``peps_tpu/montecarlo/engine.py``): configurations [nc, Ly, Lx] int64 on the
device, the chain axis leading. The reference's jax.random key becomes a
``torch.Generator`` (or a source of each sweep's uniforms, as the parity
tests replay the reference's)."""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from peps_tpu_torch.contraction import bmps
from peps_tpu_torch.device import resolve_device
from peps_tpu_torch.lattice import transpose_tps
from peps_tpu_torch.linalg import TruncParams
from peps_tpu_torch.montecarlo.sweep import SweepStats, UpdateRule, mc_sweep
from peps_tpu_torch.tps import project


class ChainState(NamedTuple):
    configs: torch.Tensor                     # [nc, Ly, Lx] int64
    generator: torch.Generator | None = None  # draws each sweep's uniforms


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


@dataclasses.dataclass
class MonteCarloEngine:
    """Host-side owner of the chain batch and its sweep (the reference's
    MonteCarloEngine). Each sweep's uniforms come from ``uniform_source()``
    when it is set, else from ``state.generator``."""
    tps: torch.Tensor
    chi: int
    trunc: TruncParams
    rule: UpdateRule
    state: ChainState
    uniform_source: Callable[[], tuple] | None = None

    def __post_init__(self):
        self._tps_t = transpose_tps(self.tps)

    def step_sweep(self) -> SweepStats:
        """One sweep of every chain; returns the summed SweepStats."""
        uniforms = self.uniform_source() if self.uniform_source else None
        configs, stats = mc_sweep(self.tps, self._tps_t, self.state.configs,
                                  self.chi, self.trunc, uniforms=uniforms,
                                  generator=self.state.generator,
                                  rule=self.rule)
        self.state = self.state._replace(configs=configs)
        return stats

    def warm_up(self, n_sweeps: int) -> float:
        """n_sweeps sweeps; returns their acceptance rate."""
        acc = tri = 0
        for _ in range(n_sweeps):
            st = self.step_sweep()
            acc += int(st.accepted)
            tri += int(st.trials)
        return acc / max(tri, 1)


def _npy(path: str) -> str:
    return path if path.endswith(".npy") else path + ".npy"


def save_configs(path: str, configs: torch.Tensor) -> None:
    """Dump the chain configurations for a warm restart, as the reference
    writes them: one int32 .npy file (".npy" appended where missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(_npy(path), configs.detach().cpu().numpy().astype(np.int32))


def load_configs(path: str, device=None) -> torch.Tensor:
    """Configurations saved by either package, as int64 on ``device``
    (None: the current CUDA device)."""
    return torch.as_tensor(np.load(_npy(path)).astype(np.int64),
                           device=resolve_device(device))
