"""Host-side engine and training loop, one device a process.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.driver` without a
device mesh: across processes each rank runs this loop on its own rows,
with the replicated table and one sum of the statistics over ranks per
pass (the engine's :class:`~..parallel.distributed.RowLayout`).  PyTorch
runs eagerly, so a "fused block" is a Python loop of
``fused_block`` sweeps followed by one smart sub-label pass; the loop then
synchronizes once per block to read the cluster counts, stamp the block's
time and pick the next table-capacity tier.

Scheduling follows ``run_model`` (src/dp-parallel-sampling.jl:354-361):
``final`` = iter >= iters - argmax_sample_stop (argmax labels) and
``no_more_splits`` = iter >= iters - split_stop, or K >= max_clusters.
``verbose`` or a ``callback`` selects the per-sweep path instead, as in the
JAX package: one sweep at a time, each followed by a sync.

The bf16 feature caches (``feature_dtype`` "bfloat16" and "hybrid") are
built with stochastic rounding, as the JAX package builds them, but their
16 dither bits are the port's counter hash of (fit seed, global row,
column) (:func:`stochastic_bf16`), not JAX's threefry bits, which cannot be
reproduced without JAX; a torch generator's stream would depend on the
chunking.  So the two packages round the same values up or down with the
same probabilities, but not the same values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import DPMMConfig
from ..ops import sweep_kernels
from ..parallel.distributed import RowLayout
from . import assign as assign_mod
from . import moves as moves_mod
from .smart import smart_sublabels
from .sweep import make_smart_pass, make_sweep
from .table import (active_count, compute_posteriors, data_dim, init_table,
                    retier)


FEATURIZE_ROWS = 1 << 16   # rows per chunk of a bf16 cache build
_DITHER_SALT = 0x5EED      # the JAX package's dither key (driver.py:429)


def stochastic_bf16(feat: torch.Tensor, seed: int, row0: int = 0):
    """f32 rows [R, F] (global rows ``row0 ..``) as bf16 with stochastic
    rounding: 16 dither bits, the counter hash of (seed, global row,
    column), are added below the bf16 mantissa, then the low 16 bits are
    dropped.  Rounds up with probability (distance to the lower neighbour)
    / ulp, so the stored value is unbiased; bf16 values stay exact."""
    r, f = feat.shape
    dev = feat.device
    rows = torch.arange(row0, row0 + r, dtype=torch.int64, device=dev)
    s = sweep_kernels.tile_seeds(int(seed) ^ _DITHER_SALT, rows, 1)
    col = torch.arange(f, dtype=torch.int64, device=dev)
    dither = sweep_kernels.hash_bits(s[:, None], col[None, :]) & 0xFFFF
    bits = feat.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    top = ((bits + dither) >> 16) & 0xFFFF            # uint32 add, truncate
    return (top - ((top >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def bf16_features(family, points: torch.Tensor, seed: int,
                  row0: int = 0) -> torch.Tensor:
    """The bf16 feature cache [N, F] of ``points`` (global rows ``row0
    ..``), built FEATURIZE_ROWS rows at a time (a whole f32 cache of 10M x
    64-d points would be 86 GB); the bits do not depend on the chunk size.
    It is the first F columns of rows ``sweep_kernels.bf16_row_stride(F)``
    values apart, zeros past F (``sweep_kernels.empty_bf16_rows``: the
    layout that the kernel of one bf16 pass copies by a tensor map)."""
    n, d = points.shape
    f = family.feature_dim(d)
    out = sweep_kernels.empty_bf16_rows(n, f, points.device)
    for p0 in range(0, n, FEATURIZE_ROWS):
        p1 = min(n, p0 + FEATURIZE_ROWS)
        out[p0:p1] = stochastic_bf16(family.features(points[p0:p1]), seed,
                                     row0 + p0)
    return out


def tier_sequence(k_max: int) -> list:
    """Capacity tiers: powers of two from 16 up to (and including) k_max."""
    tiers = []
    t = 16
    while t < k_max:
        tiers.append(t)
        t *= 2
    tiers.append(k_max)
    return tiers


def desired_tier(k_act: int, cur: int, tiers: list) -> int:
    """Table capacity for the next block: grow when split headroom drops
    under 4x the live cluster count; shrink only when capacity exceeds 16x
    (to >= 8x), so the two thresholds never flap."""
    k_act = max(k_act, 1)
    if 4 * k_act > cur:
        cands = [t for t in tiers if t >= 4 * k_act]
        return cands[0] if cands else tiers[-1]
    if 16 * k_act <= cur:
        cands = [t for t in tiers if t >= 8 * k_act]
        t = cands[0] if cands else tiers[-1]
        if t < cur:
            return t
    return cur


@dataclasses.dataclass
class DPMMState:
    """The complete sampler state.  Per-point streams are flat int32 [N]."""

    table: Any                 # dict of tensors (the cluster table)
    labels: torch.Tensor       # int32 [N] slot ids
    sublabels: torch.Tensor    # int32 [N] in {0, 1}
    gen: torch.Generator       # every random draw of the run
    step: int = 0


@dataclasses.dataclass
class IterStats:
    """Per-iteration history (run_model's histories): cluster count, log
    posterior, wall time and, with ground truth, NMI and VI."""

    k: list
    log_posterior: list
    times: list
    nmi: list
    vi: list

    @staticmethod
    def empty():
        return IterStats([], [], [], [], [])


class DPMMEngine:
    """The sampler for one (family, config, device) and, across processes,
    one rank's :class:`~..parallel.distributed.RowLayout` (by default one
    process holding every row)."""

    def __init__(self, family, cfg: DPMMConfig, device="cuda",
                 layout: Optional[RowLayout] = None):
        self.family = family
        self.cfg = cfg
        self.device = torch.device(device)
        self.layout = RowLayout() if layout is None else layout
        self._x_is_features = bool(cfg.precompute_features)
        self._sweep = make_sweep(family, cfg, self.layout)
        self._smart_on = cfg.resolved_smart_splits(family.name)
        self._smart = (make_smart_pass(family, cfg, self.layout)
                       if self._smart_on else None)

    # -- data placement -----------------------------------------------------
    def shard_points(self, x: np.ndarray):
        """Place this rank's [N, D] host points on the device.  Returns
        ``(points, valid, n_total)``: across ranks the rows are padded to
        the layout's ``n_pad`` with invalid zero rows and ``n_total`` is
        the global count of real rows; in one process every row is
        valid."""
        x = torch.as_tensor(np.ascontiguousarray(x, np.float32))
        n, lay = x.shape[0], self.layout
        if lay.world == 1:
            valid = torch.ones(n, dtype=torch.bool, device=self.device)
            return x.to(self.device), valid, float(n)
        points = torch.zeros((lay.n_pad, x.shape[1]), dtype=torch.float32,
                             device=self.device)
        points[:n] = x.to(self.device)
        valid = torch.arange(lay.n_pad, device=self.device) < n
        return points, valid, float(lay.n_global)

    def featurize(self, points: torch.Tensor, seed: int = 0):
        """The feature cache (for the Gaussian family rows [1, x, triu(x
        x^T)]), built once per fit when ``cfg.precompute_features``; every
        kernel then streams its rows (F is not padded).  Without it the
        kernels build the rows from the raw points.  By ``feature_dtype``:

        * "float32": the f32 cache [N, F];
        * "bfloat16": the bf16 cache [N, F] (:func:`bf16_features`; ``seed``
          keys its rounding; its rows padded to a multiple of 8 values),
          which feeds the ll product and the statistics;
        * "hybrid" (Gaussian only): ``{"feat": bf16 [N, F], "raw":
          points}``: the bf16 cache feeds only the ll product, and the
          statistics are built in f32 from the raw points, held as they
          are (not copied)."""
        dt = self.cfg.feature_dtype
        if dt == "float32":
            return self.family.features(points)
        if dt == "hybrid" and self.family.name != "gaussian":
            raise ValueError(
                "feature_dtype='hybrid' requires the gaussian family (its "
                "statistics are the Gaussian rows built from the raw "
                f"points); got family {self.family.name!r}")
        feat = bf16_features(self.family, points, seed,
                             self.layout.row_start)
        return {"feat": feat, "raw": points} if dt == "hybrid" else feat

    # -- state --------------------------------------------------------------
    def _stats(self, points, valid, labels, sublabels, k: int):
        stats_lr = assign_mod.stats_only(
            points, valid, labels, sublabels, k, family=self.family,
            x_is_features=self._x_is_features)
        return assign_mod.lr_to_full(self.layout.reduce(stats_lr))

    def init_state(self, gen: torch.Generator, points, valid, prior,
                   outlier_prior=None,
                   init_labels: Optional[np.ndarray] = None) -> DPMMState:
        """Random first assignment, one statistics pass, the smart init of
        the first clusters and the first parameter draw (reference
        ``init_model_from_data`` + ``init_first_clusters!``,
        src/dp-parallel-sampling.jl:36-78)."""
        cfg, family = self.cfg, self.family
        n = valid.shape[0]
        d = data_dim(prior)
        offset = 1 if cfg.outlier_mod > 0 else 0
        # per-point draws of the replicated generator (the global padded
        # length across ranks, this rank's slice)
        def draw(lo, hi):
            return self.layout.per_point(
                lambda m: torch.randint(lo, hi, (m,), generator=gen,
                                        device=self.device,
                                        dtype=torch.int32), n)

        labels = draw(offset, offset + cfg.init_clusters)
        sublabels = draw(0, 2)
        if init_labels is not None:
            labels = torch.as_tensor(
                np.asarray(init_labels, np.int32) + offset).to(self.device)

        flat3 = self._stats(points, valid, labels, sublabels, cfg.k_max)
        if self._smart_on:
            stats = family.stats_from_flat(flat3, d)
            stats_w = {name: a[:, 0] for name, a in stats.items()}
            sublabels = smart_sublabels(
                assign_mod.raw_points(points, d, self._x_is_features), valid,
                labels, sublabels, stats_w, stats_w["n"] > 0,
                cfg.max_split_iter, reduce=self.layout.reduce)
            flat3 = self._stats(points, valid, labels, sublabels, cfg.k_max)

        prior = {k: v.to(self.device) for k, v in prior.items()}
        if outlier_prior is not None:
            outlier_prior = {k: v.to(self.device)
                             for k, v in outlier_prior.items()}
        table = init_table(family, prior, outlier_prior, cfg, d,
                           device=self.device)
        table = compute_posteriors(
            family, {**table, "stats": family.stats_from_flat(flat3, d)})
        table = moves_mod.sample_params_step(gen, table, cfg.alpha,
                                             cfg.outlier_mod, family)
        return DPMMState(table=table, labels=labels, sublabels=sublabels,
                         gen=gen, step=0)

    # -- sweeps -------------------------------------------------------------
    def step(self, state: DPMMState, points, valid, n_total, final: bool,
             no_more_splits: bool):
        """One Gibbs sweep; returns (new_state, metrics of device scalars)."""
        table, labels, sublabels, metrics = self._sweep(
            state.table, state.labels, state.sublabels, state.gen, points,
            valid, n_total, final, no_more_splits)
        return (DPMMState(table, labels, sublabels, state.gen, state.step + 1),
                metrics)

    def step_block(self, state: DPMMState, points, valid, n_total,
                   finals, no_more_splits):
        """``len(finals)`` sweeps, then one smart sub-label pass for the
        slots born in the block; metrics come back stacked [B] on the
        device."""
        cap = self.cfg.max_clusters
        ms = []
        for f, nm in zip(finals, no_more_splits):
            if cap is not None and not nm:
                nm = int(active_count(state.table)) >= cap
            state, m = self.step(state, points, valid, n_total, bool(f),
                                 bool(nm))
            ms.append(m)
        if self._smart is not None:
            table, sublabels = self._smart(state.table, state.labels,
                                           state.sublabels, points, valid)
            state = DPMMState(table, state.labels, sublabels, state.gen,
                              state.step)
        metrics = {name: torch.stack([m[name] for m in ms]) for name in ms[0]}
        return state, metrics

    def smart_refresh(self, state: DPMMState, points, valid) -> DPMMState:
        """The smart sub-label pass of :meth:`step_block` on its own, for
        the per-sweep path: the slots born since the last call get their
        smart init.  No-op when smart splits are resolved off; otherwise
        the pass reads its ``needs_smart`` flag once (one host sync)."""
        if self._smart is None:
            return state
        table, sublabels = self._smart(state.table, state.labels,
                                       state.sublabels, points, valid)
        return DPMMState(table, state.labels, sublabels, state.gen,
                         state.step)


def migrate(family, state: DPMMState, k_new: int) -> DPMMState:
    """Resize the table to ``k_new`` slots and remap the labels."""
    table, lut = retier(family, state.table, k_new)
    return DPMMState(table, lut[state.labels.long()], state.sublabels,
                     state.gen, state.step)


def _tier_step(family, state: DPMMState, k_now: int,
               tiers: list) -> DPMMState:
    """Migrate the table to ``desired_tier``, never below the live
    clusters."""
    cur = state.table["active"].shape[0]
    want = desired_tier(k_now, cur, tiers)
    if want < k_now:
        want = cur
    return migrate(family, state, want) if want != cur else state


def run_loop(engine: DPMMEngine, state: DPMMState, points, valid, n_total,
             iters: int, *, first_iter: int = 0,
             gt: Optional[np.ndarray] = None, n_valid: Optional[int] = None,
             callback: Optional[Callable] = None,
             verbose: Optional[bool] = None,
             tiers: Optional[list] = None) -> tuple:
    """The training loop (reference ``run_model``,
    src/dp-parallel-sampling.jl:336-404), in blocks of ``fused_block``
    sweeps.

    Every block ends with one synchronization: the block's wall time over
    its sweeps fills ``hist.times`` (no unfenced entries), and with ground
    truth the block's NMI/VI are computed from the labels afterwards (not
    timed).  ``tiers`` turns on adaptive table capacity: at each block
    boundary the table migrates to ``desired_tier``, never below the live
    cluster count.

    ``verbose`` or ``callback(it, state, metrics)`` (called after sweep
    ``it``, ``first_iter <= it < iters``) selects :func:`_run_each` instead,
    the per-sweep path."""
    cfg = engine.cfg
    verbose = cfg.verbose if verbose is None else verbose
    if verbose or callback is not None:
        return _run_each(engine, state, points, valid, n_total, iters,
                         first_iter=first_iter, gt=gt, n_valid=n_valid,
                         callback=callback, verbose=verbose, tiers=tiers)
    hist = IterStats.empty()
    block = max(1, cfg.fused_block)
    it = first_iter
    while it < iters:
        b = min(block, iters - it)
        rng_it = np.arange(it, it + b)
        finals = rng_it >= iters - cfg.argmax_sample_stop
        nms = rng_it >= iters - cfg.split_stop
        t0 = time.perf_counter()
        state, metrics = engine.step_block(state, points, valid, n_total,
                                           finals, nms)
        ks = metrics["k"].tolist()                 # the block's fence
        dt = time.perf_counter() - t0
        it += b
        hist.k.extend(int(k) for k in ks)
        hist.log_posterior.extend(metrics["log_posterior"].tolist())
        hist.times.extend([dt / b] * b)
        if gt is not None:
            from ..utils.metrics import nmi as nmi_fn, varinfo

            labels_h = state.labels.cpu().numpy()[:n_valid]
            hist.nmi.extend([nmi_fn(gt, labels_h)] * b)
            hist.vi.extend([varinfo(gt, labels_h)] * b)
        if tiers is not None and it < iters:
            state = _tier_step(engine.family, state, ks[-1], tiers)
    return state, hist


def _run_each(engine: DPMMEngine, state: DPMMState, points, valid, n_total,
              iters: int, *, first_iter: int, gt, n_valid, callback,
              verbose: bool, tiers) -> tuple:
    """The per-sweep path of :func:`run_loop` (the JAX package's
    ``run_loop`` with ``verbose`` or a callback): before each sweep a tier
    step and, after the first sweep and up to ``iters - split_stop``, the
    smart refresh of the slots the last sweep split off (the fused path
    runs it after each block instead); after each sweep one sync, one
    ``hist`` entry, a printed line when ``verbose``, then ``callback``."""
    cfg = engine.cfg
    cap = cfg.max_clusters
    hist = IterStats.empty()
    k_now = int(active_count(state.table))
    for it in range(first_iter, iters):
        t0 = time.perf_counter()
        if tiers is not None:
            state = _tier_step(engine.family, state, k_now, tiers)
        if first_iter < it <= iters - cfg.split_stop:
            state = engine.smart_refresh(state, points, valid)
        final = it >= iters - cfg.argmax_sample_stop
        no_more_splits = (it >= iters - cfg.split_stop
                          or (cap is not None and k_now >= cap))
        state, metrics = engine.step(state, points, valid, n_total, final,
                                     no_more_splits)
        k_now = int(metrics["k"])                  # the sweep's fence
        dt = time.perf_counter() - t0
        hist.k.append(k_now)
        hist.log_posterior.append(float(metrics["log_posterior"]))
        hist.times.append(dt)
        if gt is not None:
            from ..utils.metrics import nmi as nmi_fn, varinfo

            labels_h = state.labels.cpu().numpy()[:n_valid]
            hist.nmi.append(nmi_fn(gt, labels_h))
            hist.vi.append(varinfo(gt, labels_h))
        if verbose:
            msg = (f"iter {it + 1}: K={k_now} "
                   f"log_post={hist.log_posterior[-1]:.2f} "
                   f"t={dt * 1e3:.1f}ms")
            if gt is not None:
                msg += f" nmi={hist.nmi[-1]:.3f} vi={hist.vi[-1]:.3f}"
            print(msg, flush=True)
        if callback is not None:
            callback(it, state, metrics)
    return state, hist
