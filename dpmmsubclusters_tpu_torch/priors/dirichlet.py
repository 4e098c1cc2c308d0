"""Dirichlet conjugate prior for multinomial-count clusters.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.priors.dirichlet`
(reference ``src/priors/multinomial_prior.jl`` +
``src/distributions/multinomial_dist.jl``):

* posterior: ``alpha' = alpha + sum_x``          (multinomial_prior.jl:16-21)
* sampled cluster parameters: ``log p ~ log Dirichlet(alpha')``       (:23-25)
* per-point log-likelihood ``log_p . x``: linear in the raw counts, so the
  feature rows are ``[1, x]`` with ``phi = [0, log p]``
* log marginal likelihood by lgamma sums                            (:34-39)
* posterior predictive: counts dotted with the log-normalized posterior
  mean                                                              (:45-48)
"""
from __future__ import annotations

import torch


class MultinomialFamily:
    name = "multinomial"

    # ---- shapes -----------------------------------------------------------
    def feature_dim(self, d: int) -> int:
        return 1 + d

    def stat_dim(self, d: int) -> int:
        return 1 + d

    # ---- per-point linear maps -------------------------------------------
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, 1 + D]: rows [1, x], shared by the ll product
        (phi = [0, log p]) and the statistics reduction."""
        return torch.cat([torch.ones_like(x[:, :1]), x], dim=1)

    def stat_features(self, x: torch.Tensor) -> torch.Tensor:
        """The statistics rows are the feature rows."""
        return self.features(x)

    # ---- sufficient statistics -------------------------------------------
    def empty_stats(self, batch_shape: tuple, d: int, device="cpu"):
        return {
            "n": torch.zeros(batch_shape, device=device),
            "sum_x": torch.zeros(batch_shape + (d,), device=device),
        }

    def stats_from_flat(self, flat: torch.Tensor, d: int):
        return {"n": flat[..., 0], "sum_x": flat[..., 1:1 + d]}

    def stats_to_flat(self, stats) -> torch.Tensor:
        return torch.cat([stats["n"][..., None], stats["sum_x"]], dim=-1)

    # ---- conjugate updates ------------------------------------------------
    def calc_posterior(self, prior, stats):
        has = (stats["n"] > 0)[..., None]
        return {"alpha": torch.where(has, prior["alpha"] + stats["sum_x"],
                                     prior["alpha"])}

    def augment_prior(self, prior_k):
        """No prior-only terms worth caching (lgamma sums are cheap)."""
        return prior_k

    def posterior_cache(self, posterior, mask):
        """No factorization to share between log_marginal and sampling."""
        return None

    @staticmethod
    def _dm_log_marginal(a0, a1):
        return (torch.lgamma(a0.sum(-1)) - torch.lgamma(a1.sum(-1))
                + (torch.lgamma(a1) - torch.lgamma(a0)).sum(-1))

    def log_marginal(self, prior, posterior, stats, mask,
                     cache=None) -> torch.Tensor:
        """Dirichlet-multinomial log marginal likelihood (without the
        multinomial coefficient, as the reference); 0 where ``mask`` is
        False or N == 0."""
        valid = mask & (stats["n"] > 0)
        out = self._dm_log_marginal(prior["alpha"], posterior["alpha"])
        return torch.where(valid, out, torch.zeros_like(out))

    def log_marginal_pairwise(self, prior, stats, mask) -> torch.Tensor:
        """[K, K] log marginal likelihood of every merged pair (i, j) under
        prior_i."""
        sx = stats["sum_x"][:, None, :] + stats["sum_x"][None, :, :]
        n_m = stats["n"][:, None] + stats["n"][None, :]
        a0 = prior["alpha"][:, None, :]
        out = self._dm_log_marginal(a0, a0 + sx)
        pair_mask = mask[:, None] & mask[None, :] & (n_m > 0)
        return torch.where(pair_mask, out, torch.zeros_like(out))

    def merge_screen_score(self, post_w, params_w) -> torch.Tensor:
        """Cheap [K, K] mergeability score: negative log Bhattacharyya
        affinity of the posterior mean distributions (lower = closer)."""
        a = post_w["alpha"]
        p = a / a.sum(-1, keepdim=True)
        sq = torch.sqrt(torch.clamp(p, min=1e-30))
        return -torch.log(torch.clamp(sq @ sq.T, min=1e-30))

    # ---- sampling ---------------------------------------------------------
    def sample_params(self, gen: torch.Generator, hyper, mask, cache=None):
        """log p ~ log Dirichlet(alpha) by normalized log-Gamma draws.
        Returns ``{"phi" [..., 1 + D] = [0, log p], "log_p" [..., D]}``."""
        alpha = torch.clamp(hyper["alpha"], min=1e-6)
        g = torch.clamp(torch._standard_gamma(alpha, generator=gen),
                        min=1e-37)
        log_g = torch.log(g)
        log_p = log_g - torch.logsumexp(log_g, dim=-1, keepdim=True)
        return {"phi": torch.cat([torch.zeros_like(log_p[..., :1]), log_p],
                                 dim=-1),
                "log_p": log_p}

    # ---- prediction -------------------------------------------------------
    def posterior_predictive(self, x: torch.Tensor, hyper) -> torch.Tensor:
        """[N, D] x batched hyper [...] -> [N, ...]."""
        a = hyper["alpha"]
        v = torch.log(a / a.sum(-1, keepdim=True))
        return torch.einsum("nd,...d->n...", x, v)

    # ---- convenience ------------------------------------------------------
    def default_prior(self, d: int, device="cpu"):
        return {"alpha": torch.ones((d,), device=device)}

    def make_prior(self, alpha, device="cpu"):
        return {"alpha": torch.as_tensor(alpha, dtype=torch.float32,
                                         device=device)}

    def tile_prior(self, prior, batch_shape: tuple):
        return {k: v.expand(batch_shape + v.shape).clone()
                for k, v in prior.items()}

    def shift_prior(self, prior, shift):
        """Counts are never centered: a no-op."""
        return prior


MULTINOMIAL = MultinomialFamily()
