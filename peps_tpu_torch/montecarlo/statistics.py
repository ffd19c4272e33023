"""Monte Carlo statistics (port of ``mean_and_binned_error`` of
``peps_tpu/montecarlo/statistics.py``)."""
from __future__ import annotations

import math

import torch


def mean_and_binned_error(samples: torch.Tensor):
    """samples [S] or [S, C] (sweeps x chains). Bins of ~sqrt(S) sweeps
    absorb autocorrelation; chains are independent. Returns (mean, stderr)
    as 0-d tensors on the samples' device."""
    if samples.ndim == 1:
        samples = samples[:, None]
    s, c = samples.shape
    nbins = max(int(math.sqrt(s)), 1)
    bin_len = s // nbins
    binned = samples[:nbins * bin_len].reshape(nbins, bin_len, c).mean(dim=1)
    mean = binned.mean()
    n_indep = nbins * c
    var = binned.var(unbiased=False) if n_indep > 1 \
        else torch.zeros_like(mean)
    return mean, torch.sqrt(var / max(n_indep - 1, 1))
