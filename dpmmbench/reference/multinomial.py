"""Plain float64 reference of the multinomial/Dirichlet sub-cluster
sampler's per-sweep arithmetic, and its control in a lower precision.

What it computes, from the raw counts and the sampler's state (its drawn
parameters and its table's statistics):

* a document's multinomial log-likelihood under a drawn probability
  vector p, as the inner product of its feature row [1, x] with the
  coefficients [0, log p] (``multinomial_dist.jl:13-15``);
* the sufficient statistics (count, sum x) of the documents by (label,
  sub-label), in the same row layout;
* the Dirichlet posterior ``alpha + sum x`` of a prior and statistics
  (``multinomial_prior.jl:16-21``).

Departures from the source: the log-likelihood leaves out the
multinomial coefficient, as ``multinomial_prior.jl:34-39`` leaves it out
of the marginal (it is the same for every cluster, so no label depends on
it); the drawn vector is read as the sampler keeps it, ``log p``.

``LOWER``, ``quantize``, ``sums_by_key`` and ``nmi`` are the Gaussian
reference's, which do not depend on the family.  Float32 products (the
control's) run without TF32.
"""
from __future__ import annotations

import torch

from dpmmbench.reference.gauss import (  # noqa: F401
    LOWER, nmi, quantize, sums_by_key)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def feature_dim(d: int) -> int:
    return 1 + d


def features(x: torch.Tensor) -> torch.Tensor:
    """float64 rows [1, x]."""
    x = x.to(torch.float64)
    one = torch.ones((x.shape[0], 1), dtype=torch.float64, device=x.device)
    return torch.cat([one, x], dim=1)


def coeffs(params: dict, side: int, slots=None) -> torch.Tensor:
    """[F, K] float64 coefficients [0, log p] of a table's drawn ``log_p``
    [K, 3, D] of ``side`` (0 whole, 1 left, 2 right), of ``slots`` alone
    where given."""
    log_p = params["log_p"][:, side].to(torch.float64)
    if slots is not None:
        log_p = log_p[slots]
    zero = torch.zeros((log_p.shape[0], 1), dtype=torch.float64,
                       device=log_p.device)
    return torch.cat([zero, log_p], dim=1).T.contiguous()


def posterior(prior: dict, stats: dict, dtype=torch.float64) -> dict:
    """Dirichlet posterior ``alpha + sum_x`` of per-slot ``prior`` {alpha
    [..., D]} and ``stats`` {n [...], sum_x [..., D]}, computed in
    ``dtype``; slots with n == 0 keep the prior."""
    alpha = prior["alpha"].to(dtype)
    post = alpha + stats["sum_x"].to(dtype)
    has = (stats["n"] > 0)[..., None]
    return {"alpha": torch.where(has, post, alpha)}


def default_prior(d: int, device) -> dict:
    """The configurations' prior, Dirichlet(1) in every coordinate."""
    return {"alpha": torch.ones(d, dtype=torch.float64, device=device)}
