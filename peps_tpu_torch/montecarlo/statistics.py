"""Monte Carlo statistics (port of ``peps_tpu/montecarlo/statistics.py``):
binned means and errors, their importance-weighted form with jackknife
errors, and the autocorrelation time."""
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


def weighted_mean_and_binned_error_batch(samples: torch.Tensor,
                                        log_weights: torch.Tensor):
    """Self-normalized importance-sampling statistics with binned jackknife
    errors, for estimators sampled from a biased distribution (samples from
    |psi e^J|^2 with log_weights = -2 J give E_|psi|^2[X] = sum(w X) /
    sum(w)). samples [S, C, K], log_weights [S, C]. Bins of ~sqrt(S) sweeps
    absorb autocorrelation; the (bin, chain) blocks count as independent
    and the ratio's error is the leave-one-block-out jackknife's. Returns
    (means [K], stderrs [K])."""
    s, c, k = samples.shape
    w = torch.exp(log_weights - log_weights.max())[..., None]
    nbins, bin_len = _bins(s)
    usable = nbins * bin_len
    num = (w * samples)[:usable].reshape(nbins, bin_len, c, k).sum(dim=1)
    den = w.expand(s, c, k)[:usable].reshape(nbins, bin_len, c, k) \
        .sum(dim=1)
    num = num.reshape(nbins * c, k)
    den = den.reshape(nbins * c, k)
    tot_num, tot_den = num.sum(dim=0), den.sum(dim=0)
    mean = tot_num / tot_den
    nb = nbins * c
    if nb > 1:
        jk = (tot_num[None] - num) / (tot_den[None] - den)
        var = (nb - 1) / nb * ((jk - jk.mean(dim=0)) ** 2).sum(dim=0)
        return mean, torch.sqrt(var)
    return mean, torch.zeros_like(mean)


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
