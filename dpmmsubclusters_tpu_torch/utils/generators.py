"""Synthetic data generators (reference: src/data_generators.jl).

Same sampling semantics as the reference, implemented with numpy on host
(data generation is not a hot path):

* :func:`generate_gaussian_data` -- Dirichlet-weighted mixture, component
  means ~ N(0, MixtureVar*I), covariances ~ InverseWishart(D+2, I)
  (data_generators.jl:19-42).
* :func:`generate_mnmm_data` -- Dirichlet cluster probability vectors with a
  boosted coordinate; Multinomial(trials) draws (data_generators.jl:59-72).

Data layout is [N, D] (rows = points) -- the framework convention; pass
``transposed=True`` to :func:`dpmmsubclusters_tpu_torch.fit` for reference-layout
D x N arrays instead.
"""
from __future__ import annotations

import numpy as np


def _inv_wishart(rng, df: int, d: int):
    """Draw from InverseWishart(df, I) via the Wishart of the inverse."""
    g = rng.standard_normal((df, d))
    w = g.T @ g  # Wishart(df, I)
    return np.linalg.inv(w)


def generate_gaussian_data(n: int, d: int, k: int, mixture_var: float, seed=None):
    """Returns (x [N, D] float32, labels [N] int, means [K, D], covs [K, D, D])."""
    rng = np.random.default_rng(seed)
    pi = rng.dirichlet(np.ones(k))
    counts = rng.multinomial(n, pi)
    labels = np.zeros(n, np.int64)
    x = np.zeros((n, d), np.float32)
    means = np.zeros((k, d), np.float32)
    covs = np.zeros((k, d, d), np.float32)
    start = 0
    for i in range(k):
        c = counts[i]
        means[i] = rng.multivariate_normal(
            np.zeros(d), mixture_var * np.eye(d)
        )
        covs[i] = _inv_wishart(rng, d + 2, d)
        if c > 0:
            labels[start : start + c] = i
            x[start : start + c] = rng.multivariate_normal(
                means[i], covs[i], size=c
            )
        start += c
    return x, labels, means, covs


def generate_mnmm_data(n: int, d: int, k: int, trials: int, seed=None):
    """Returns (x [N, D] float32 counts, labels [N] int, clusters [K, D])."""
    rng = np.random.default_rng(seed)
    clusters = np.zeros((k, d))
    for i in range(k):
        alphas = rng.integers(1, 21, size=d).astype(np.float64)
        alphas[i % d] = rng.integers(30, 101)
        clusters[i] = rng.dirichlet(alphas)
    labels = rng.integers(0, k, size=n)
    x = rng.multinomial(trials, clusters[labels]).astype(np.float32)
    return x, labels, clusters
