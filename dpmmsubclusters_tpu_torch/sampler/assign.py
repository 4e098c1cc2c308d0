"""The assignment + sufficient-statistics pass (the hot path).

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.assign`.  The
points container is one of (``DPMMEngine.featurize``):

* the raw points ``[N, D]``, whose feature rows the kernels build
  themselves (the family's variant; ``x_is_features`` False);
* the f32 feature cache ``[N, F]`` (``x_is_features``: rows ``[1, x,
  triu(x x^T)]``, unpadded; "precomputed");
* the bf16 feature cache ``[N, F]`` ("bfloat16");
* the dict ``{"feat": bf16 [N, F], "raw": f32 [N, D]}`` ("hybrid": the
  cache feeds only the ll product, the statistics come from the raw points).

Every per-point stream is a flat ``[N]`` tensor (labels and sub-labels
int32, valid bool).  The kernels live in :mod:`..ops.sweep_kernels`; this
module adapts the table's layouts to theirs.
"""
from __future__ import annotations

import torch

from ..ops import sweep_kernels

HASH_TILE = 512  # rows per Gumbel-hash tile (the TPU kernel's point tile)


def _delta_phi(phi: torch.Tensor, log_lrw: torch.Tensor) -> torch.Tensor:
    """[K, 3, F] natural params -> [F, 2K] kernel columns
    [whole K | delta K]: delta = phi_r - phi_l with the sub-cluster
    log-weight ratio log(lrw_r/lrw_l) folded into the constant feature's row
    (feature 0 is the literal 1)."""
    whole = phi[:, 0]
    delta = phi[:, 2] - phi[:, 1]
    delta = torch.cat(
        [delta[:, :1] + (log_lrw[:, 1] - log_lrw[:, 0])[:, None],
         delta[:, 1:]], dim=1)
    return torch.cat([whole, delta], dim=0).T.contiguous()


def _variant(points, family, x_is_features: bool) -> str:
    """The kernels' variant for a points container."""
    if isinstance(points, dict):
        return "hybrid"
    if points.dtype == torch.bfloat16:
        return "bfloat16"
    return "precomputed" if x_is_features else family.name


def assign_and_stats(points, valid, phi, log_w, log_lrw, seed, hard,
                     tile_off: int = 0, tile: int = HASH_TILE, *,
                     family=None, x_is_features: bool = True,
                     ll_precision: str = "highest"):
    """One sweep's labels, sub-labels and statistics.

    points: a points container (module note) of ``family``; valid bool
    [N]; phi [K, 3, F]; log_w [K]; log_lrw [K, 2]; seed int or int32 [1]
    device tensor; hard bool; ll_precision: the ll product's precision
    (``DPMMConfig.ll_precision``).
    Returns ``(labels int32 [N], sublabels int32 [N], stats_lr [K, 2, F])``.
    """
    k = phi.shape[0]
    variant = _variant(points, family, x_is_features)
    hybrid = variant == "hybrid"
    labels, sub, stats2k = sweep_kernels.fused_assign(
        points["feat"] if hybrid else points, valid,
        _delta_phi(phi, log_lrw), log_w.contiguous(), seed, tile_off, hard,
        tile=tile, family_name=variant,
        x_raw=points["raw"] if hybrid else None, ll_precision=ll_precision,
    )
    return labels, sub, torch.stack([stats2k[:k], stats2k[k:]], dim=1)


def stats_only(points, valid, labels, sublabels, k_slots: int, *,
               family=None, x_is_features: bool = True):
    """Per-(slot, side) statistics from given labels/sub-labels (reference
    ``update_suff_stats_posterior!``, src/local_clusters_actions.jl:206-254).
    A hybrid container's statistics come from its raw points (the
    family's built rows), never from the bf16 cache.  Returns f32[K, 2,
    F]."""
    if isinstance(points, dict):
        points, x_is_features = points["raw"], False
    stats2k = sweep_kernels.stats_from_labels(
        points, labels, sublabels, valid, k_slots,
        family_name=_variant(points, family, x_is_features))
    return torch.stack([stats2k[:k_slots], stats2k[k_slots:]], dim=1)


def lr_to_full(stats_lr: torch.Tensor) -> torch.Tensor:
    """[K, 2, S] left/right partial stats -> [K, 3, S] with whole = l + r."""
    whole = stats_lr[:, 0] + stats_lr[:, 1]
    return torch.cat([whole[:, None], stats_lr], dim=1)


def raw_points(points, d: int, x_is_features: bool) -> torch.Tensor:
    """The raw f32 [N, D] points of a container: a hybrid container's raw
    plane, a cache's columns 1..D (upcast from a bf16 cache), or the points
    themselves when there is no cache."""
    if isinstance(points, dict):
        return points["raw"]
    if x_is_features:
        return points[:, 1:1 + d].to(torch.float32)
    return points
