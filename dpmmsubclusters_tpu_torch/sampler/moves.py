"""Cluster-level sampler moves on the padded table.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.moves`, move for
move: parameter draws with the splittable gate, bad-cluster resets, MH
splits with free-slot allocation, MH merges (all pairs or screened
candidates) with a disjoint matching, and empty-slot removal.  Every draw
takes one ``torch.Generator`` on the table's device.

The JAX version skips the O(N) label rewrites and the merge scan with
``lax.cond`` when no move can be accepted; here they always run.  The result
is the same, and a sweep then needs no host sync at all: a Python ``if`` on
device state would drain the queue and idle the card while the host launches
the next few hundred table-math kernels.
"""
from __future__ import annotations

import math

import torch

from ..ops.linalg import sample_dirichlet
from ..utils import profiling
from .table import compute_posteriors, data_dim, side_tile

NEG_INF = float("-inf")


def _mask3(table):
    a = table["active"]
    return a[:, None].expand(a.shape[0], 3)


def _rows(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """[K] mask -> broadcastable against a [K, ...] tensor of ``ndim`` dims."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


def _scatter_rows(arr, dst, src):
    """arr[dst[i]] <- src[i] for dst[i] < K (index K is dropped)."""
    k = arr.shape[0]
    out = torch.cat([arr, arr[:1]], dim=0)
    out[dst] = src
    return out[:k]


def _mark(dst, k: int) -> torch.Tensor:
    """bool [K], True at every dst[i] < K.  (``index_fill_`` takes the
    scalar as is; ``out[dst] = True`` would copy it from the host and
    synchronize the stream.)"""
    out = torch.zeros(k + 1, dtype=torch.bool, device=dst.device)
    return out.index_fill_(0, dst, True)[:k]


def _uniform(gen, shape, device):
    """Uniform draws in [1e-37, 1) (finite logs)."""
    return torch.rand(shape, generator=gen, device=device).clamp_(min=1e-37)


def converged(hist: torch.Tensor, reference_gate: bool = False):
    """The splittable gate's test of a full history window [K, B]: its mean
    is at most 1e-2 above the newest value (``sample_clusters!``,
    src/shared_actions.jl:41-66).  The unbiased gate takes the mean less
    the newest value as the mean of the differences, which is exactly 0
    for a constant window; the JAX package's float32 sum of values near
    2.5e5 (resolution 0.03) can leave a constant window 0.016 above and the
    slot never splittable (ROADMAP R7).  ``reference_gate`` keeps the
    reference's 1/(B - 0.1) weight on the plain sum."""
    b = hist.shape[1]
    if reference_gate:
        excess = hist.sum(-1) / (b - 0.1) - hist[:, -1]
    else:
        excess = (hist - hist[:, -1:]).sum(-1) / b
    return torch.isfinite(excess) & (excess < 1e-2)


def sample_params_step(gen, table, alpha: float, outlier_mod: float, family,
                       reference_gate: bool = False,
                       freeze_outlier: bool = False):
    """Draw all cluster/sub-cluster distributions, lr-weights and global
    mixture weights; update the sub-likelihood history and splittable flags
    (``sample_clusters!``, src/shared_actions.jl:41-66).  The history mean is
    unbiased unless ``reference_gate`` (the reference's 1/(b - 0.1)
    window weight)."""
    k = table["active"].shape[0]
    active = table["active"]
    dev = active.device

    # one posterior-psi factorization serves the draw and the log-marginal
    mask3 = _mask3(table)
    with profiling.family_span("draw"):
        cache = family.posterior_cache(table["post"], mask3)
        params = family.sample_params(gen, table["post"], mask3, cache=cache)
    if freeze_outlier:
        is_out = table["is_outlier"]
        params = {name: torch.where(_rows(is_out, new.ndim),
                                    table["params"][name], new)
                  for name, new in params.items()}

    n = table["stats"]["n"]
    lr_alpha = torch.stack([n[:, 1], n[:, 2]], dim=-1) + alpha / 2.0
    lr_weights = sample_dirichlet(gen, lr_alpha)

    with profiling.family_span("marginal"):
        lm = family.log_marginal(side_tile(table["prior"]), table["post"],
                                 table["stats"], mask3, cache=cache)
    newest = lm[:, 1] + lm[:, 2]
    hist = torch.cat([table["hist"][:, 1:], newest[:, None]], dim=-1)
    splittable = (table["splittable"] | converged(hist, reference_gate)) \
        & active
    hist = torch.where(active[:, None], hist, NEG_INF)

    counts = n[:, 0]
    real = active & ~table["is_outlier"]
    gam_alpha = torch.cat([torch.where(real, counts, 0.0),
                           torch.full((1,), alpha, device=dev)])
    w = sample_dirichlet(gen, gam_alpha)[:k] * (1.0 - outlier_mod)
    log_w = torch.where(real, torch.log(torch.clamp(w, min=1e-37)), NEG_INF)
    if outlier_mod > 0:
        log_w = torch.where(table["is_outlier"] & active,
                            math.log(outlier_mod), log_w)
    return {
        **table,
        "params": params,
        "lr_weights": lr_weights,
        "log_weights": log_w.float(),
        "hist": hist,
        "splittable": splittable,
    }


def split_log_hastings(alpha, n, lm):
    """Split-move log Hastings ratio (``should_split_local!``,
    src/local_clusters_actions.jl:318-343):
    log a + lgamma(Nl) + L_l + lgamma(Nr) + L_r - lgamma(N) - L."""
    safe = torch.clamp(n, min=1e-30)
    return (
        math.log(alpha)
        + torch.lgamma(safe[:, 1]) + lm[:, 1]
        + torch.lgamma(safe[:, 2]) + lm[:, 2]
        - torch.lgamma(safe[:, 0]) - lm[:, 0]
    )


def merge_log_hastings(alpha, ni, nj, lm_i, lm_j, lm_m):
    """Merge-move log Hastings ratio (``should_merge!``,
    src/shared_actions.jl:21-38), for any broadcastable batch shape."""
    ni = torch.clamp(ni, min=1e-30)
    nj = torch.clamp(nj, min=1e-30)
    nm = torch.clamp(ni + nj, min=1e-30)
    lg = torch.lgamma
    return (
        -math.log(alpha) + math.lgamma(alpha) - 2.0 * math.lgamma(alpha / 2.0)
        + lg(nm) - lg(nm + alpha)
        + lg(ni + alpha / 2.0) - lg(ni)
        + lg(nj + alpha / 2.0) - lg(nj)
        + lm_m - lm_i - lm_j
    )


def reset_bad(table, family):
    """Clusters with an empty sub-cluster get their history reset and their
    sub-stats set to half the whole stats, the exact expectation of a random
    50/50 re-assignment (``reset_bad_clusters!``, :481-516, without its O(N)
    pass).  Returns ``(table, any_bad, bad)``."""
    n = table["stats"]["n"]
    bad = table["active"] & ((n[:, 1] == 0) | (n[:, 2] == 0))
    hist = torch.where(bad[:, None], NEG_INF, table["hist"])
    splittable = table["splittable"] & ~bad

    flat = family.stats_to_flat(table["stats"])          # [K, 3, S]
    half = flat[:, 0:1] * 0.5
    flat = torch.where(bad[:, None, None],
                       torch.cat([flat[:, 0:1], half, half], dim=1), flat)
    stats = family.stats_from_flat(flat, data_dim(table["prior"]))
    table = {**table, "stats": stats, "hist": hist, "splittable": splittable}
    return compute_posteriors(family, table), bad.any(), bad


def split_move(gen, table, labels, sublabels, alpha: float, final: bool,
               family, lm=None):
    """MH split proposals for every splittable slot at once
    (``check_and_split!``, :318-382).  An accepted slot moves its right
    sub-cluster's points to a free slot; both slots restart burnout with
    expectation-halved sub-stats and await a smart sub-label init.

    ``lm``: optional precomputed [K, 3] log marginals.  Returns ``(table,
    labels, sublabels, any_accepted, touched)``."""
    k = table["active"].shape[0]
    active = table["active"]
    dev = active.device
    n = table["stats"]["n"]
    if lm is None:
        with profiling.family_span("marginal"):
            lm = family.log_marginal(side_tile(table["prior"]),
                                     table["post"], table["stats"],
                                     _mask3(table))
    eligible = (
        active & table["splittable"] & ~table["is_outlier"]
        & (n[:, 0] > 1) & (n[:, 1] > 0) & (n[:, 2] > 0)
    )
    if final:
        eligible = torch.zeros_like(eligible)
    log_hr = split_log_hastings(alpha, n, lm)
    u = _uniform(gen, (k,), dev)
    accept = eligible & (log_hr > torch.log(u))

    # one free slot per accepted split, in slot order
    free = ~active
    rank = torch.cumsum(accept.int(), 0) - 1
    accept = accept & (rank < free.sum())
    free_rank = torch.cumsum(free.int(), 0) - 1
    slot_of_rank = torch.full((k + 1,), k, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free, free_rank, k)] = torch.arange(k, device=dev)
    new_slot = slot_of_rank[:k][torch.clamp(rank, 0, k - 1)]

    # right-side points of accepted slots move to the new slot (their
    # sub-labels are redrawn by the next sweep's assignment pass)
    lab = labels.long()
    labels = torch.where(accept[lab] & (sublabels == 1),
                         new_slot[lab].to(labels.dtype), labels)

    dst = torch.where(accept, new_slot, k)
    touched = accept | _mark(dst, k)
    active = active | _mark(dst, k)
    prior = {name: _scatter_rows(a, dst, a)
             for name, a in table["prior"].items()}

    # new slot's whole = the parent's right, the old slot's whole = its
    # left; sub-stats = half the new whole (create_splittable_from_params)
    def side3(a, side: int):
        w = a[:, side]
        h = w * 0.5
        return torch.stack([w, h, h], dim=1)

    stats = {}
    for name, a in table["stats"].items():
        moved = _scatter_rows(a, dst, side3(a, 2))
        stats[name] = torch.where(_rows(accept, a.ndim), side3(a, 1), moved)
    lr_fresh = sample_dirichlet(
        gen, torch.full((k, 2), alpha / 2.0, device=dev))
    table = {
        **table,
        "active": active,
        "prior": prior,
        "stats": stats,
        "lr_weights": torch.where(touched[:, None], lr_fresh,
                                  table["lr_weights"]),
        "hist": torch.where(touched[:, None], NEG_INF, table["hist"]),
        "splittable": table["splittable"] & ~touched,
        "needs_smart": table["needs_smart"] | touched,
    }
    return (compute_posteriors(family, table), labels, sublabels,
            accept.any(), touched)


def _accept(log_hr, u, final: bool):
    acc = log_hr > torch.log(u)
    if final:
        acc = acc | (log_hr > math.log(0.1))
    return acc


def _merge_pairs_full(gen, table, family, eligible, lm_w, n_w, alpha, final):
    """Exact log_HR for every (i, j) pair -> accepted-pair mask [K, K]."""
    k = eligible.shape[0]
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    with profiling.family_span("marginal"):
        lm_m = family.log_marginal_pairwise(table["prior"], stats_w,
                                            eligible)
    log_hr = merge_log_hastings(alpha, n_w[:, None], n_w[None, :],
                                lm_w[:, None], lm_w[None, :], lm_m)
    u = _uniform(gen, (k, k), eligible.device)
    upper = torch.ones(k, k, dtype=torch.bool, device=eligible.device).triu(1)
    return (eligible[:, None] & eligible[None, :] & upper
            & _accept(log_hr, u, final))


def _merge_pairs_screened(gen, table, family, eligible, lm_w, n_w, alpha,
                          final, m_cand: int, dim: int):
    """Exact log_HR for only the top-``m_cand`` screen-score pairs."""
    k = eligible.shape[0]
    dev = eligible.device
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    post_w = {name: a[:, 0] for name, a in table["post"].items()}
    params_w = {name: a[:, 0] for name, a in table["params"].items()}

    score = family.merge_screen_score(post_w, params_w)
    upper = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    valid_pair = eligible[:, None] & eligible[None, :] & upper
    score = torch.where(valid_pair, score, float("inf"))
    neg, idx = torch.topk(-score.reshape(-1), m_cand)
    ii, jj = idx // k, idx % k
    valid_m = torch.isfinite(neg)

    flat_w = family.stats_to_flat(stats_w)
    merged = family.stats_from_flat(flat_w[ii] + flat_w[jj], dim)
    prior_i = {name: a[ii] for name, a in table["prior"].items()}
    with profiling.family_span("posterior"):
        post_m = family.calc_posterior(prior_i, merged)
    with profiling.family_span("marginal"):
        lm_m = family.log_marginal(prior_i, post_m, merged, valid_m)
    log_hr = merge_log_hastings(alpha, n_w[ii], n_w[jj], lm_w[ii], lm_w[jj],
                                lm_m)
    acc = valid_m & _accept(log_hr, _uniform(gen, (m_cand,), dev), final)
    out = torch.zeros(k, k, dtype=torch.bool, device=dev)
    out[ii, jj] = acc
    return out


def merge_move(gen, table, labels, sublabels, alpha: float, final: bool,
               family, lm_w=None, candidates=None):
    """Masked pairwise MH merge scan (``check_and_merge!``, :385-413):
    accepted when log_HR > log U, or on a final sweep log_HR > log 0.1; a
    disjoint set of pairs merges per sweep.  ``candidates``: only the top-M
    screen-score pairs get the exact evaluation.  With fewer than two
    eligible slots no pair is accepted and the table is returned as it was
    (the JAX version skips the scan then; here it runs without a sync)."""
    k = table["active"].shape[0]
    active = table["active"]
    dev = active.device
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    post_w = {name: a[:, 0] for name, a in table["post"].items()}
    n_w = stats_w["n"]
    eligible = (active & table["splittable"] & (n_w > 0)
                & ~table["is_outlier"])
    if lm_w is None:
        with profiling.family_span("marginal"):
            lm_w = family.log_marginal(table["prior"], post_w, stats_w,
                                       eligible)
    lm_w = torch.where(eligible, lm_w, 0.0)
    dim = data_dim(table["prior"])

    if candidates is not None and candidates < (k * (k - 1)) // 2:
        pair_ok = _merge_pairs_screened(gen, table, family, eligible, lm_w,
                                        n_w, alpha, final, int(candidates),
                                        dim)
    else:
        pair_ok = _merge_pairs_full(gen, table, family, eligible, lm_w, n_w,
                                    alpha, final)
    slots = torch.arange(k, device=dev)

    # disjoint matching: each loser j takes its smallest winner i; each
    # winner keeps only its smallest loser; a winner that is itself a loser
    # is dropped
    has_w = pair_ok.any(0)
    winner = torch.argmax(pair_ok.to(torch.uint8), dim=0)      # first True
    m = (winner[None, :] == slots[:, None]) & has_w[None, :]
    first_j = torch.argmax(m.to(torch.uint8), dim=1)
    kept0 = has_w & (first_j[winner] == slots)
    kept = kept0 & ~kept0[winner]
    dsti = torch.where(kept, winner, k)
    kept_winner = _mark(dsti, k)

    # labels / sub-labels (merge_clusters_worker!, :293-304)
    lab = labels.long()
    pt_loser = kept[lab]
    sublabels = torch.where(
        pt_loser, 1, torch.where(kept_winner[lab], 0, sublabels)
    ).to(sublabels.dtype)
    labels = torch.where(pt_loser, winner[lab].to(labels.dtype), labels)

    # stats surgery (merge_clusters_to_splittable, shared_actions.jl:12-18)
    flat3 = family.stats_to_flat(table["stats"])               # [K, 3, S]
    old_whole = flat3[:, 0]
    f = torch.cat([flat3, torch.zeros_like(flat3[:1])], dim=0)
    f[:, 0].index_add_(0, dsti, old_whole)
    f[dsti, 1] = old_whole[winner]
    f[dsti, 2] = old_whole
    flat3 = torch.where(kept[:, None, None], 0.0, f[:k])
    stats = family.stats_from_flat(flat3, dim)

    lr_alpha = torch.stack([n_w[winner] + alpha / 2.0, n_w + alpha / 2.0],
                           dim=-1)
    lr_fresh = sample_dirichlet(gen, lr_alpha)
    lr_weights = _scatter_rows(table["lr_weights"], dsti, lr_fresh)

    touched = kept | kept_winner
    active = active & ~kept
    table = {
        **table,
        "active": active,
        "stats": stats,
        "lr_weights": lr_weights,
        "hist": torch.where(touched[:, None], NEG_INF, table["hist"]),
        "splittable": table["splittable"] & ~touched,
        # merge-touched slots keep the merge's winner/loser partition
        "needs_smart": table["needs_smart"] & active & ~touched,
    }
    return compute_posteriors(family, table), labels, sublabels


def remove_empty(table, outlier_mod: float):
    """Deactivate slots whose cluster lost all its points
    (``remove_empty_clusters!``, :446-471)."""
    n_w = table["stats"]["n"][:, 0]
    keep = (n_w > 0) | table["is_outlier"]
    if outlier_mod > 0:
        real = table["active"] & ~table["is_outlier"]
        keep = keep | (real & (real.sum() == 1))
    active = table["active"] & keep
    return {**table, "active": active,
            "splittable": table["splittable"] & active,
            "needs_smart": table["needs_smart"] & active}
