"""The padded fixed-capacity cluster table.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.table`, with the
same dict layout (leading dim K = table capacity):

  active      bool[K]    slot holds a live cluster
  is_outlier  bool[K]    slot is the fixed outlier component (never splits)
  prior       dict[K,...]      per-slot prior hyperparams (+ ld0/lgmv0 caches)
  stats       dict[K,3,...]    sufficient statistics; side 0=whole 1=left 2=right
  post        dict[K,3,...]    posterior hyperparams per side
  params      dict[K,3,...]    sampled distributions ('phi' feeds kernel A)
  lr_weights  f32[K,2]   sub-cluster mixture weights
  log_weights f32[K]     sampled global mixture log-weights (-inf inactive)
  hist        f32[K,B]   logsublikelihood ring buffer (B = burnout)
  splittable  bool[K]
  needs_smart bool[K]    newborn slots awaiting a smart sub-label init
"""
from __future__ import annotations

import math

import torch

from ..utils import profiling

NEG_INF = float("-inf")


def side_tile(prior_k):
    """Broadcast per-slot prior [K, ...] to per-side [K, 3, ...]."""
    return {k: v[:, None].expand((v.shape[0], 3) + v.shape[1:])
            for k, v in prior_k.items()}


def data_dim(prior) -> int:
    """D from any family's (per-slot) prior: NIW ``m`` or Dirichlet
    ``alpha``."""
    return (prior["m"] if "m" in prior else prior["alpha"]).shape[-1]


def compute_posteriors(family, table):
    """Recompute all posterior hyperparams from the current statistics
    (``update_splittable_cluster_params!``, for every slot and side)."""
    with profiling.family_span("posterior"):
        post = family.calc_posterior(side_tile(table["prior"]),
                                     table["stats"])
    return {**table, "post": post}


def init_table(family, prior, outlier_prior, cfg, d: int, device="cpu"):
    """The initial table: ``init_clusters`` active slots (plus slot 0 as the
    outlier component when ``outlier_mod > 0``), statistics empty
    (``init_first_clusters!`` minus the statistics pass)."""
    k = cfg.k_max
    has_outlier = cfg.outlier_mod > 0
    n_real = cfg.init_clusters
    n_active = n_real + (1 if has_outlier else 0)
    if n_active > k:
        raise ValueError(f"init_clusters={n_real} exceeds k_max={k}")

    idx = torch.arange(k, device=device)
    active = idx < n_active
    is_outlier = (idx == 0) & has_outlier

    prior_k = family.tile_prior(prior, (k,))
    if has_outlier:
        out_k = family.tile_prior(
            prior if outlier_prior is None else outlier_prior, (k,))
        prior_k = {
            name: torch.where(
                is_outlier.reshape((k,) + (1,) * (v.ndim - 1)),
                out_k[name], v)
            for name, v in prior_k.items()
        }
    prior_k = family.augment_prior(prior_k)

    stats = family.empty_stats((k, 3), d, device=device)
    with profiling.family_span("posterior"):
        post = family.calc_posterior(side_tile(prior_k), stats)
    return {
        "active": active,
        "is_outlier": is_outlier,
        "prior": prior_k,
        "stats": stats,
        "post": post,
        "params": None,  # filled by the first parameter-sampling step
        "lr_weights": torch.full((k, 2), 0.5, device=device),
        "log_weights": torch.where(active, 0.0, NEG_INF).float(),
        "hist": torch.full((k, cfg.burnout), NEG_INF, device=device),
        "splittable": torch.zeros(k, dtype=torch.bool, device=device),
        "needs_smart": torch.zeros(k, dtype=torch.bool, device=device),
    }


def active_count(table) -> torch.Tensor:
    return table["active"].sum()


def _map(fn, tree):
    return {k: fn(v) for k, v in tree.items()}


def retier(family, table, k_new: int):
    """Compact active slots to the front and resize the table to ``k_new``.

    Returns ``(table, lut)`` where ``lut`` (int32 [K_old]) maps old slot ids
    to new ones; apply it to labels with ``lut[labels]``.  Slot order is
    preserved, so the outlier component keeps slot 0.  The caller guarantees
    ``k_new >= #active``."""
    act = table["active"]
    k_old = act.shape[0]
    order = torch.argsort((~act).to(torch.int8), stable=True)
    lut = torch.empty(k_old, dtype=torch.int32, device=act.device)
    lut[order] = torch.arange(k_old, dtype=torch.int32, device=act.device)
    # donor row for padded prior/params rows: any active non-outlier slot
    # (all real slots carry the same base prior), else the first active one
    real = act & ~table["is_outlier"]
    donor = torch.where(real.any(), torch.argmax(real.to(torch.int8)),
                        torch.argmax(act.to(torch.int8)))

    def remap(a, fill):
        g = a[order]
        if k_new <= k_old:
            return g[:k_new]
        pad_shape = (k_new - k_old,) + a.shape[1:]
        if fill == "donor":
            pad = a[donor][None].expand(pad_shape)
        else:
            pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
        return torch.cat([g, pad], dim=0)

    new = {
        "active": remap(table["active"], False),
        "is_outlier": remap(table["is_outlier"], False),
        "prior": _map(lambda a: remap(a, "donor"), table["prior"]),
        "stats": _map(lambda a: remap(a, 0.0), table["stats"]),
        "params": _map(lambda a: remap(a, "donor"), table["params"]),
        "lr_weights": remap(table["lr_weights"], 0.5),
        "log_weights": remap(table["log_weights"], NEG_INF),
        "hist": remap(table["hist"], NEG_INF),
        "splittable": remap(table["splittable"], False),
        "needs_smart": remap(table["needs_smart"], False),
    }
    return compute_posteriors(family, new), lut


def whole_stats(table):
    return _map(lambda a: a[:, 0], table["stats"])


def log_posterior(family, table, alpha: float, n_total: float):
    """DP-CRP log posterior (reference ``calculate_posterior``,
    src/dp-parallel-sampling.jl:458-470)."""
    stats_w = whole_stats(table)
    post_w = _map(lambda a: a[:, 0], table["post"])
    mask = table["active"] & (stats_w["n"] > 0)
    with profiling.family_span("marginal"):
        lm = family.log_marginal(table["prior"], post_w, stats_w, mask)
    per_cluster = torch.where(
        mask,
        lm + math.log(alpha) + torch.lgamma(torch.clamp(stats_w["n"],
                                                        min=1e-30)),
        torch.zeros_like(lm),
    )
    # float32 constants made on the device by a fill (torch.tensor(...)
    # would copy from the host and synchronize the stream)
    lg = torch.lgamma(torch.stack([torch.full((), alpha, device=lm.device),
                                   torch.full((), n_total + alpha,
                                              device=lm.device)]))
    return lg[0] - lg[1] + per_cluster.sum()
