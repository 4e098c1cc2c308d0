"""The assignment + sufficient-statistics pass (the hot path).

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.assign`.  The
points are either the precomputed f32 feature cache (``x_is_features``:
rows ``[1, x, triu(x x^T)]``, unpadded) or the raw points ``[N, D]``, whose
feature rows the kernels build themselves (the family's variant); every
per-point stream is a flat ``[N]`` tensor (labels and sub-labels int32,
valid bool).  The kernels live in :mod:`..ops.sweep_kernels`; this module
adapts the table's layouts to theirs.
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


def _variant(family, x_is_features: bool) -> str:
    return "precomputed" if x_is_features else family.name


def assign_and_stats(points, valid, phi, log_w, log_lrw, seed, hard,
                     tile_off: int = 0, tile: int = HASH_TILE, *,
                     family=None, x_is_features: bool = True):
    """One sweep's labels, sub-labels and statistics.

    points [N, F] feature cache (``x_is_features``) or [N, D] raw points of
    ``family``; valid bool [N]; phi [K, 3, F]; log_w [K]; log_lrw [K, 2];
    seed int or int32 [1] device tensor; hard bool.
    Returns ``(labels int32 [N], sublabels int32 [N], stats_lr [K, 2, F])``.
    """
    k = phi.shape[0]
    labels, sub, stats2k = sweep_kernels.fused_assign(
        points, valid, _delta_phi(phi, log_lrw), log_w.contiguous(), seed,
        tile_off, hard, tile=tile,
        family_name=_variant(family, x_is_features),
    )
    return labels, sub, torch.stack([stats2k[:k], stats2k[k:]], dim=1)


def stats_only(points, valid, labels, sublabels, k_slots: int, *,
               family=None, x_is_features: bool = True):
    """Per-(slot, side) statistics from given labels/sub-labels (reference
    ``update_suff_stats_posterior!``, src/local_clusters_actions.jl:206-254).
    Returns f32[K, 2, F]."""
    stats2k = sweep_kernels.stats_from_labels(
        points, labels, sublabels, valid, k_slots,
        family_name=_variant(family, x_is_features))
    return torch.stack([stats2k[:k_slots], stats2k[k_slots:]], dim=1)


def lr_to_full(stats_lr: torch.Tensor) -> torch.Tensor:
    """[K, 2, S] left/right partial stats -> [K, 3, S] with whole = l + r."""
    whole = stats_lr[:, 0] + stats_lr[:, 1]
    return torch.cat([whole[:, None], stats_lr], dim=1)


def raw_points(points: torch.Tensor, d: int,
               x_is_features: bool) -> torch.Tensor:
    """The raw [N, D] points: the feature cache's columns 1..D, or the
    points themselves when there is no cache."""
    return points[:, 1:1 + d] if x_is_features else points
