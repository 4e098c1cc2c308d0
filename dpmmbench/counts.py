"""Count documents for the multinomial/Dirichlet configurations, made on
the device from the run's seed.

A torch copy of DPMMSubClusters.jl's ``generate_mnmm_data(N, D, K,
trials)`` (``src/data_generators.jl:59-72``; the JAX package's
``utils/generators.generate_mnmm_data``): each of the ``k_true`` clusters
draws its probability vector from a Dirichlet whose parameters are
integers 1-20, but coordinate ``i % d`` of cluster ``i``, an integer
30-100; each document's generator label is uniform over the clusters, and
its counts are ``trials`` draws from its cluster's vector.  The counts are
made ``CHUNK_ROWS`` documents at a time (a draw's index a trial, then a
bincount a row), never centred.  The same seed gives the same counts and
labels on one kind of device.
"""
from __future__ import annotations

import torch

CHUNK_ROWS = 1 << 18


def cluster_probs(k_true: int, d: int, gen: torch.Generator, device):
    """float64 [k_true, d] probability vectors by the source's rule."""
    alphas = torch.randint(1, 21, (k_true, d), generator=gen,
                           device=device).to(torch.float64)
    rows = torch.arange(k_true, device=device)
    alphas[rows, rows % d] = torch.randint(
        30, 101, (k_true,), generator=gen, device=device).to(torch.float64)
    g = torch._standard_gamma(alphas, generator=gen)
    return g / g.sum(1, keepdim=True)


def mnmm_data(n: int, d: int, k_true: int, trials: int, seed: int,
              device) -> tuple:
    """(counts float32 [n, d], labels int64 [n], probabilities float64
    [k_true, d]) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    probs = cluster_probs(k_true, d, gen, device)
    cdf = torch.cumsum(probs, 1).to(torch.float32)
    cdf[:, -1] = 1.0                   # every uniform in [0, 1) finds a bin
    labels = torch.randint(0, k_true, (n,), generator=gen, device=device)
    x = torch.zeros((n, d), dtype=torch.float32, device=device)
    ones = torch.ones((min(n, CHUNK_ROWS), trials), dtype=torch.float32,
                      device=device)
    for p0 in range(0, n, CHUNK_ROWS):
        p1 = min(n, p0 + CHUNK_ROWS)
        u = torch.rand((p1 - p0, trials), generator=gen, device=device)
        bins = torch.searchsorted(cdf[labels[p0:p1]], u, right=True)
        # whole numbers below 2^24 add exactly, in any order
        x[p0:p1].scatter_add_(1, bins, ones[:p1 - p0])
    return x, labels, probs
