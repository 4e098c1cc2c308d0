"""Drop-in style compatibility layer for users of the reference ecosystem.

The port's copy of :mod:`dpmmsubclusters_tpu.compat`.  The reference is
consumed from Julia (``DPMMSubClusters.fit``) or through the Python wrapper
``dpmmpython``, both on D x N data with 1-based labels; these functions
keep those conventions on top of the port, so a script switches by
changing an import::

    from dpmmsubclusters_tpu_torch import compat as DPMMPython
    labels, clusters, weights = DPMMPython.fit(data, 100.0, iterations=100)

Every entry point runs on the card unless ``device="cpu"`` is passed (it
flows through ``**extra`` / ``**kw`` to :func:`~.api.fit`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import api


def generate_gaussian_data(n: int, d: int, k: int, var: float, seed=None):
    """Reference layout: returns (x [D, N], labels 1-based, means, covs)."""
    from .utils.generators import generate_gaussian_data as gen

    x, labels, means, covs = gen(n, d, k, var, seed=seed)
    return x.T, labels + 1, means.T, np.moveaxis(covs, 0, -1)


def generate_mnmm_data(n: int, d: int, k: int, trials: int, seed=None):
    from .utils.generators import generate_mnmm_data as gen

    x, labels, clusters = gen(n, d, k, trials, seed=seed)
    return x.T, labels + 1, clusters.T


def fit(
    data,
    alpha: float,
    prior=None,
    *,
    iterations: int = 100,
    init_clusters: int = 1,
    seed: Optional[int] = None,
    verbose: bool = True,
    burnout: int = 20,
    gt=None,
    outlier_weight: float = 0.0,
    outlier_params=None,
    smart_splits: bool = False,
    **extra,
):
    """Reference-style fit: D x N data, 1-based labels.

    Returns (labels [N] 1-based, cluster_params list, weights), the
    essentials of the reference's 9-tuple (src/dp-parallel-sampling.jl:218);
    :func:`fit_full` returns the whole result.
    """
    result = fit_full(
        data, alpha, prior,
        iterations=iterations, init_clusters=init_clusters, seed=seed,
        verbose=verbose, burnout=burnout, gt=gt,
        outlier_weight=outlier_weight, outlier_params=outlier_params,
        smart_splits=smart_splits, **extra,
    )
    return result.labels + 1, result.model.cluster_params(), result.weights


def fit_full(
    data,
    alpha: float,
    prior=None,
    *,
    iterations: int = 100,
    init_clusters: int = 1,
    seed: Optional[int] = None,
    verbose: bool = True,
    burnout: int = 20,
    gt=None,
    outlier_weight: float = 0.0,
    outlier_params=None,
    smart_splits: bool = False,
    **extra,
) -> api.FitResult:
    return api.fit(
        np.asarray(data).T,
        alpha=alpha,
        prior=prior,
        gt=None if gt is None else np.asarray(gt),
        outlier_prior=outlier_params,
        iters=iterations,
        init_clusters=init_clusters,
        seed=seed,
        verbose=verbose,
        burnout=burnout,
        outlier_mod=outlier_weight,
        smart_splits=smart_splits,
        **extra,
    )


def predict(model: api.DPMMModel, data):
    """D x N in, 1-based labels out (reference predict,
    src/dp-parallel-sampling.jl:532)."""
    labels, probs = model.predict(np.asarray(data).T)
    return labels + 1, probs


def calculate_posterior(model_or_result) -> float:
    """Reference ``calculate_posterior`` (src/dp-parallel-sampling.jl:458):
    the DP-CRP + marginal-likelihood log posterior of a fitted model."""
    m = getattr(model_or_result, "model", model_or_result)
    return m.log_posterior()


def save_model(model_or_result, path: str) -> None:
    """Reference ``save_model`` (src/dp-parallel-sampling.jl:450): write a
    resumable checkpoint (the points are not stored, as in the reference's
    pts_less_group)."""
    m = getattr(model_or_result, "model", model_or_result)
    m.save(path)


def run_model_from_checkpoint(path: str, data, *, iterations=None, **kw):
    """Resume from a checkpoint (reference ``run_model_from_checkpoint``,
    src/dp-parallel-sampling.jl:428); returns the same triple as
    :func:`fit`.  ``data`` is D x N (reference layout).

    Diverges from the reference, as the JAX package does: the reference
    takes the path alone and reloads the points from the params file the
    checkpoint names; here the caller passes them (checkpoints store no
    data and no data path).  ``iterations`` is the total sweep count to run
    to; ``device=`` and config overrides go through ``**kw``."""
    result = api.run_from_checkpoint(
        path, np.asarray(data).T, iters=iterations, **kw
    )
    return result.labels + 1, result.model.cluster_params(), result.weights


def dp_parallel(model_params: str, *, device="cuda"):
    """Reference advanced mode ``dp_parallel(model_params::String)``
    (src/dp-parallel-sampling.jl:317): run a fit from a params file (JSON
    instead of Julia globals; see :mod:`dpmmsubclusters_tpu_torch.run` for
    the schema)."""
    from .run import fit_from_params

    result = fit_from_params(model_params, device=device)
    return result.labels + 1, result.model.cluster_params(), result.weights


def get_labels_histogram(labels):
    """Reference ``get_labels_histogram`` (src/utils.jl:39-48) on 1-based
    labels: sorted (label, count) pairs."""
    from .utils.metrics import get_labels_histogram as _hist

    return sorted(_hist(np.asarray(labels)).items())
