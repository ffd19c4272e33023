"""Monte Carlo statistics (port of ``peps_tpu/montecarlo/statistics.py``):
binned means and errors, and the autocorrelation time. The importance-
weighted ``weighted_mean_and_binned_error_batch`` serves only the fermionic
pair correlator and comes with ROADMAP queue 1, item 10."""
from __future__ import annotations

import math

import numpy as np
import torch


def _bins(s: int):
    """(number of bins, bin length) of ~sqrt(S) sweeps each."""
    nbins = max(int(math.sqrt(s)), 1)
    return nbins, s // nbins


def mean_and_binned_error(samples: torch.Tensor):
    """samples [S] or [S, C] (sweeps x chains). Bins of ~sqrt(S) sweeps
    absorb autocorrelation; chains are independent. Returns (mean, stderr)
    as 0-d tensors on the samples' device."""
    if samples.ndim == 1:
        samples = samples[:, None]
    s, c = samples.shape
    nbins, bin_len = _bins(s)
    binned = samples[:nbins * bin_len].reshape(nbins, bin_len, c).mean(dim=1)
    mean = binned.mean()
    n_indep = nbins * c
    var = binned.var(unbiased=False) if n_indep > 1 \
        else torch.zeros_like(mean)
    return mean, torch.sqrt(var / max(n_indep - 1, 1))


def mean_and_binned_error_batch(samples: torch.Tensor):
    """samples [S, C, K] (sweeps x chains x observables) -> (means [K],
    stderrs [K]): the same binning as :func:`mean_and_binned_error`, one
    reduction for all K observables."""
    s, c, k = samples.shape
    nbins, bin_len = _bins(s)
    binned = samples[:nbins * bin_len].reshape(nbins, bin_len, c, k) \
        .mean(dim=1).reshape(nbins * c, k)
    mean = binned.mean(dim=0)
    n_indep = nbins * c
    var = binned.var(dim=0, unbiased=False) if n_indep > 1 \
        else torch.zeros_like(mean)
    return mean, torch.sqrt(var / max(n_indep - 1, 1))


def autocorrelation(samples, max_lag: int | None = None) -> np.ndarray:
    """Normalized autocorrelation function along axis 0 (host, float64)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    s = x.shape[0]
    if max_lag is None:
        max_lag = min(s // 4, 100)
    xc = x - x.mean(axis=0, keepdims=True)
    var = (xc ** 2).mean()
    out = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        out[lag] = (xc[:s - lag] * xc[lag:]).mean() / max(var, 1e-300)
    return out


def integrated_autocorrelation_time(samples) -> float:
    """tau_int = 1/2 + sum rho(lag), truncated at the first rho <= 0."""
    rho = autocorrelation(samples)
    tau = 0.5
    for lag in range(1, len(rho)):
        if rho[lag] <= 0:
            break
        tau += rho[lag]
    return float(tau)
