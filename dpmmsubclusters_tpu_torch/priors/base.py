"""The conjugate-prior "family" protocol.

Same contract as :mod:`dpmmsubclusters_tpu.priors.base`: hyperparameters,
sufficient statistics and sampled parameters are dicts of tensors with
arbitrary leading batch dimensions (``[K, 3]`` in the sampler: cluster slot
x {whole, left, right}); the per-point log-likelihood is the linear
functional ``features(x) . phi`` and the statistics are the one-hot
reduction of the same feature rows.
"""
from __future__ import annotations

from typing import Any, Protocol

import torch

Params = Any  # dict of tensors


class Family(Protocol):
    """Protocol implemented by :mod:`.niw` and :mod:`.dirichlet`."""

    name: str

    def feature_dim(self, d: int) -> int: ...
    def stat_dim(self, d: int) -> int: ...
    def features(self, x: torch.Tensor) -> torch.Tensor: ...

    def empty_stats(self, batch_shape: tuple, d: int, device=...) -> Params: ...
    def stats_from_flat(self, flat: torch.Tensor, d: int) -> Params: ...
    def stats_to_flat(self, stats: Params) -> torch.Tensor: ...

    def calc_posterior(self, prior: Params, stats: Params) -> Params: ...
    def log_marginal(
        self, prior: Params, posterior: Params, stats: Params,
        mask: torch.Tensor, cache: Params = None,
    ) -> torch.Tensor: ...
    def augment_prior(self, prior_k: Params) -> Params: ...
    def posterior_cache(self, posterior: Params,
                        mask: torch.Tensor) -> Params: ...

    def sample_params(
        self, gen: torch.Generator, hyper: Params, mask: torch.Tensor,
        cache: Params = None,
    ) -> Params: ...

    # posterior_predictive(x, hyper) ==
    # predictive_logpdf(x, predictive_factor(hyper, D)): the factor is per
    # model, the evaluation per chunk of points
    def predictive_factor(self, hyper: Params, d: int) -> Params: ...
    def predictive_logpdf(self, x: torch.Tensor,
                          factor: Params) -> torch.Tensor: ...
    def posterior_predictive(self, x: torch.Tensor,
                             hyper: Params) -> torch.Tensor: ...

    def default_prior(self, d: int, device=...) -> Params: ...
    def tile_prior(self, prior: Params, batch_shape: tuple) -> Params: ...
