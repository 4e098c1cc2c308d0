"""The system under test, ``dpmmsubclusters_tpu_torch``, as the benchmark
drives it.  The only module of the benchmark that imports the port.

Besides the calls the timed path makes, it keeps what the judge needs
(:class:`Capture`: the last call of kernel A with the table that fed it,
the last statistics pass of kernel B), adds named spans around the calls
into each layer while a trace is taken (:class:`Spans`), and reads the
port's launch counters.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

import dpmmsubclusters_tpu_torch as dpmm
from dpmmsubclusters_tpu_torch import api, priors
from dpmmsubclusters_tpu_torch.config import DPMMConfig
from dpmmsubclusters_tpu_torch.ops import _build
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.parallel import distributed
from dpmmsubclusters_tpu_torch.sampler import (assign, driver, moves, smart,
                                              sweep)
from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine, DPMMState


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the kernels' library, which
    the port keeps in its fixed ``_build/`` directory."""
    if torch.device(device).type == "cuda":
        _build.load()


def make_engine(family: str, sampler: dict, device,
                layout=None) -> DPMMEngine:
    """The engine of the port's family named in the configuration
    (``gaussian`` is ``priors.GAUSSIAN``), over one rank's ``layout``
    (None: one process holding every row)."""
    return DPMMEngine(getattr(priors, family.upper()),
                      DPMMConfig(verbose=False, **sampler), device, layout)


def join(address: str, world: int, rank: int, backend: str) -> None:
    """Join the port's process group at the rendezvous ``address``
    (``host:port``); under NCCL this rank's card is ``cuda:<rank>``."""
    distributed.initialize(f"tcp://{address}", world, rank, backend=backend)


def leave() -> None:
    distributed.shutdown()


def row_layout(n_local: int):
    """This rank's row layout of ``n_local`` rows (a collective)."""
    return distributed.row_layout(n_local)


def place_shard(engine: DPMMEngine, x: torch.Tensor, n_local: int,
                seed: int) -> tuple:
    """(points container, valid, n_total) of this rank's device points
    ``x`` [n_pad, D], of which the first ``n_local`` rows are real and the
    rest the layout's padding; the cache built when the config asks for
    one (its rounding keyed on the global row)."""
    valid = torch.arange(x.shape[0], device=x.device) < n_local
    points = x
    if engine.cfg.precompute_features:
        points = engine.featurize(x, seed=seed)
    return points, valid, float(engine.layout.n_global)


def with_own_generator(state: DPMMState) -> DPMMState:
    """``state`` with a copy of its generator, so that driving it leaves
    the original's draws as they were."""
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    return DPMMState(state.table, state.labels, state.sublabels, gen,
                     state.step)


def place(engine: DPMMEngine, x: torch.Tensor, seed: int) -> tuple:
    """(points container, valid, n_total) of device points ``x`` in one
    process, the cache built when the config asks for one."""
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    points = x
    if engine.cfg.precompute_features:
        points = engine.featurize(x, seed=seed)
    return points, valid, float(x.shape[0])


def init_state(engine: DPMMEngine, points, valid, d: int, seed: int,
               init_labels=None):
    gen = torch.Generator(device=engine.device).manual_seed(int(seed))
    return engine.init_state(gen, points, valid,
                             engine.family.default_prior(d),
                             init_labels=init_labels)


def run_block(engine: DPMMEngine, state, points, valid, n_total,
              block: int, final: bool = False,
              no_more_splits: bool = False) -> tuple:
    """One block of ``block`` sweeps, fenced as the port's loop fences it:
    the block's cluster counts read on the host.  Returns (state, live K
    after the block)."""
    state, metrics = engine.step_block(
        state, points, valid, n_total, np.full(block, bool(final)),
        np.full(block, bool(no_more_splits)))
    return state, int(metrics["k"].tolist()[-1])


def fit(x: np.ndarray, sampler: dict, iters: int, seed: int, device):
    return dpmm.fit(x, device=device, verbose=False, iters=int(iters),
                    seed=int(seed), **sampler)


def table_view(table) -> dict:
    """The final table's parts the judge reads."""
    return {"active": table["active"] & ~table["is_outlier"],
            "stats": table["stats"], "post": table["post"]}


class Capture:
    """While installed, keeps the last call of kernel A (its seed, flags,
    outputs and the table whose drawn parameters fed it) and the last
    statistics pass of kernel B (the labels it was given and its output),
    by reference: nothing is copied, so the timed path's work is as it
    was.  Counts kernel B's calls (whether the window made one); kernel
    A's calls are not counted, so a sweep that stops calling through
    Python is judged by the state it leaves."""

    def __init__(self):
        self.table = self.assign = self.stats = None
        self.stats_calls = 0
        self._saved = None

    def install(self) -> None:
        sample, assign_and_stats, stats_only = self._saved = (
            moves.sample_params_step, assign.assign_and_stats,
            assign.stats_only)

        def sample_params_step(*a, **kw):
            self.table = sample(*a, **kw)
            return self.table

        def assign_wrapped(points, valid, phi, log_w, log_lrw, seed, hard,
                           tile_off=0, tile=assign.HASH_TILE, **kw):
            out = assign_and_stats(points, valid, phi, log_w, log_lrw, seed,
                                   hard, tile_off, tile, **kw)
            self.assign = dict(table=self.table, seed=seed, hard=bool(hard),
                               tile_off=int(tile_off), tile=int(tile),
                               out=out)
            return out

        def stats_wrapped(points, valid, labels, sublabels, k_slots, **kw):
            out = stats_only(points, valid, labels, sublabels, k_slots, **kw)
            self.stats = (labels, sublabels, out)
            self.stats_calls += 1
            return out

        moves.sample_params_step = sample_params_step
        assign.assign_and_stats = assign_wrapped
        assign.stats_only = stats_wrapped

    def uninstall(self) -> None:
        (moves.sample_params_step, assign.assign_and_stats,
         assign.stats_only) = self._saved

    def call(self) -> dict:
        """Kernel A's last call as the judge takes it."""
        a = self.assign
        params = a["table"]["params"]
        labels, sub, stats = a["out"]
        seed = a["seed"]
        return dict(params=params, log_w=a["table"]["log_weights"],
                    lr_w=a["table"]["lr_weights"],
                    seed=int(seed.reshape(-1)[0]) if torch.is_tensor(seed)
                    else int(seed),
                    hard=a["hard"], tile=a["tile"], tile_off=a["tile_off"],
                    labels=labels, sub=sub, stats=stats)


# the calls into each layer that a trace names (module, attribute, span)
SPANS = (
    (DPMMEngine, "step_block", "host_loop.step_block"),
    (DPMMEngine, "featurize", "cache_build.featurize"),
    (DPMMEngine, "init_state", "entry.init_state"),
    (api, "_standardize", "entry.standardize"),
    (api, "run_loop", "host_loop.run_loop"),
    (driver, "_tier_step", "host_loop.tier_step"),
    (moves, "sample_params_step", "table_math.sample_params"),
    (moves, "reset_bad", "table_math.reset_bad"),
    (moves, "split_move", "table_math.split_move"),
    (moves, "merge_move", "table_math.merge_move"),
    (moves, "remove_empty", "table_math.remove_empty"),
    (sweep, "compute_posteriors", "table_math.posteriors"),
    (smart, "smart_sublabels", "table_math.smart_sublabels"),
    (assign, "assign_and_stats", "kernel_a.assign_and_stats"),
    (assign, "stats_only", "kernel_b.stats_only"),
)


@contextlib.contextmanager
def spans():
    """Named ``record_function`` spans around each call of :data:`SPANS`
    while the block runs (a trace's host-side layer names)."""
    from torch.profiler import record_function

    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in SPANS]

    def wrap(fn, name):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    for (owner, attr, fn), (_, _, name) in zip(saved, SPANS):
        setattr(owner, attr, wrap(fn, name))
    try:
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def reset_counters() -> None:
    sk.reset_launches()


def counters() -> dict:
    """The port's launch counters: kernel A by variant and by kernel
    design, kernel B by variant."""
    fa = sk.fused_assign
    return {"kernel_a": dict(fa.launches),
            "kernel_a_tensor_core": dict(fa.tensor_core_launches),
            "kernel_a_ring": dict(fa.ring_launches),
            "kernel_a_tma": dict(fa.tma_launches),
            "kernel_b": dict(sk.stats_from_labels.launches)}
