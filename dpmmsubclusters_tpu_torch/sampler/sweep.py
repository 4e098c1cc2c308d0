"""One full restricted-Gibbs sweep, and the block-boundary smart pass.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.sweep`, with the
sub-steps in the reference's order (``group_step``,
src/local_clusters_actions.jl:658-673):

  A. sample cluster params + weights                 (sample_clusters!)
  C-E. labels, sub-labels and statistics in one pass (kernel A)
  F. reset bad clusters (sub-stats -> their expectation)
  G. split moves, then merge moves
  H. deactivate empty slots

The TPU version's ``lax.cond`` gates and in-kernel ``enable`` flags become
Python ``if``s on host values, or go away where running the gated work
gives the same result.  A default sweep makes no host sync, so the host
can queue work ahead of the card; only ``exact_post_move_stats`` (and a
``max_clusters`` cap, in the driver) read device state per sweep.
"""
from __future__ import annotations

import torch

from ..utils import profiling
from . import assign as assign_mod
from . import moves
from . import smart as smart_mod
from .table import (active_count, compute_posteriors, data_dim, log_posterior,
                    side_tile)


def _set_stats(family, table, flat3):
    stats = family.stats_from_flat(flat3, data_dim(table["prior"]))
    return compute_posteriors(family, {**table, "stats": stats})


def _stats_pass(family, table, points, valid, labels, sublabels,
                x_is_features: bool, layout):
    """Table statistics recomputed from the given labels (kernel B), summed
    over the layout's ranks."""
    stats_lr = assign_mod.stats_only(points, valid, labels, sublabels,
                                     table["active"].shape[0], family=family,
                                     x_is_features=x_is_features)
    return _set_stats(family, table,
                      assign_mod.lr_to_full(layout.reduce(stats_lr)))


def make_smart_pass(family, cfg, layout):
    """The smart sub-label pass (PCA + 2-means init and a statistics
    refresh) for the slots marked ``needs_smart`` by split_move, clearing the
    marks.  Only newborn slots are (re)initialized, matching the reference's
    per-newborn ``smart_cluster_init!`` (src/local_clusters_actions.jl:
    374-378).  A no-op after one host sync when nothing is marked; the
    marks are replicated, so every rank takes the same branch."""
    x_is_features = bool(cfg.precompute_features)

    def smart_pass(table, labels, sublabels, points, valid):
        mask = table["needs_smart"] & table["active"] & ~table["is_outlier"]
        if not profiling.host_read(mask.any(), "smart_needed"):
            return table, sublabels
        with profiling.span("table_math.smart"):
            d = data_dim(table["prior"])
            stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
            sub2 = smart_mod.smart_sublabels(
                assign_mod.raw_points(points, d, x_is_features), valid,
                labels, sublabels, stats_w, mask, cfg.max_split_iter,
                layout=layout)
            table = _stats_pass(family, table, points, valid, labels, sub2,
                                x_is_features, layout)
            return ({**table, "needs_smart": table["needs_smart"] & ~mask},
                    sub2)

    return smart_pass


def make_sweep(family, cfg, layout):
    """Build the sweep function for one rank's
    :class:`~..parallel.distributed.RowLayout`:

      sweep(table, labels, sublabels, gen, points, valid, n_total,
            final, no_more_splits) -> (table, labels, sublabels, metrics)

    ``final`` and ``no_more_splits`` are host bools; ``metrics`` holds
    device scalars (``k``, ``log_posterior``) so a block of sweeps needs no
    host sync for them.  Across ranks kernel A's hash tiles start at the
    layout's ``tile_off``, every statistics pass is summed over ranks, and
    the per-point redraw takes this rank's slice of a global draw; every
    host branch reads the replicated table."""
    alpha = float(cfg.alpha)
    outlier_mod = float(cfg.outlier_mod)
    freeze_outlier = outlier_mod > 0 and not cfg.resample_outlier_params
    x_is_features = bool(cfg.precompute_features)

    def redraw_and_recompute(gen, flag, slot_mask, table, labels, sublabels,
                             points, valid):
        """Reference-exact chain (``exact_post_move_stats``): points of the
        flagged slots get fresh Bernoulli(1/2) sub-labels and the statistics
        are recomputed from realized labels (reset_bad_clusters! /
        split_cluster_local_worker!, :265-278,481-516)."""
        if not profiling.host_read(flag, "exact_flag"):
            return table, sublabels
        fresh = layout.per_point(
            lambda m: torch.randint(0, 2, (m,), generator=gen,
                                    device=sublabels.device,
                                    dtype=sublabels.dtype),
            sublabels.shape[0])
        sublabels = torch.where(slot_mask[labels.long()], fresh, sublabels)
        return (_stats_pass(family, table, points, valid, labels, sublabels,
                            x_is_features, layout),
                sublabels)

    def sweep(table, labels, sublabels, gen, points, valid, n_total,
              final: bool, no_more_splits: bool):
        profiling.count("sweeps")
        # A: parameter draws
        with profiling.span("table_math.sample_params", detail=True):
            table = moves.sample_params_step(
                gen, table, alpha, outlier_mod, family,
                reference_gate=bool(cfg.reference_splittable_gate),
                freeze_outlier=freeze_outlier,
            )

        # C + D + E: fused assignment & statistics (kernel A); the seed
        # stays on the device so drawing it needs no sync
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=valid.device, dtype=torch.int32)
        with profiling.span("kernel_a.assign_and_stats", detail=True):
            labels, sublabels, stats_lr = assign_mod.assign_and_stats(
                points, valid, table["params"]["phi"], table["log_weights"],
                torch.log(torch.clamp(table["lr_weights"], min=1e-37)),
                seed, bool(final or cfg.hard_clustering), layout.tile_off,
                family=family, x_is_features=x_is_features,
                ll_precision=cfg.ll_precision,
            )
        table = _set_stats(family, table,
                           assign_mod.lr_to_full(layout.reduce(stats_lr)))

        # F-H: the moves, timed as one span with the shared evaluation
        with profiling.span("table_math.moves", detail=True):
            # F: reset clusters with an empty sub-cluster
            table, any_bad, bad = moves.reset_bad(table, family)
            if cfg.exact_post_move_stats:
                table, sublabels = redraw_and_recompute(
                    gen, any_bad, bad, table, labels, sublabels, points,
                    valid)

            # G: split + merge moves, sharing one [K, 3] log-marginal
            # evaluation (slots whose stats change in between are
            # merge-ineligible)
            if not no_more_splits:
                k_slots = table["active"].shape[0]
                mask3 = table["active"][:, None].expand(k_slots, 3)
                lm3 = family.log_marginal(
                    side_tile(table["prior"]), table["post"],
                    table["stats"], mask3,
                    cache=family.posterior_cache(table["post"], mask3),
                )
                (table, labels, sublabels, any_split,
                 touched) = moves.split_move(gen, table, labels, sublabels,
                                             alpha, final, family, lm=lm3)
                if cfg.exact_post_move_stats:
                    table, sublabels = redraw_and_recompute(
                        gen, any_split, touched, table, labels, sublabels,
                        points, valid)
                table, labels, sublabels = moves.merge_move(
                    gen, table, labels, sublabels, alpha, final, family,
                    lm_w=lm3[:, 0], candidates=cfg.merge_candidates,
                )

            # H: drop empty slots
            table = moves.remove_empty(table, outlier_mod)
        metrics = {
            "k": active_count(table),
            "log_posterior": (
                log_posterior(family, table, alpha, float(n_total))
                if cfg.track_posterior else torch.zeros((), device=valid.device)
            ),
        }
        return table, labels, sublabels, metrics

    return sweep
