"""Profiling: the port's spans and counters, device traces, and the two
measurements its benchmarks share.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.utils.profiling`.  The
reference's only instrumentation is wall-clock accumulation per iteration
(``src/dp-parallel-sampling.jl:363-366``); the port keeps the same
per-iteration host timings (``FitResult.history.times``) and adds:

* spans (:func:`span`): a named interval with its parent span, timed on
  the device clock (a CUDA event pair on the current stream, read against
  one origin event of the process; the host's ``time.perf_counter`` where
  CUDA is not initialized), so a span's time is its interval on the card's
  timeline.  While a torch profiler records, a span also opens a
  ``record_function`` range of its name, which names the trace's host
  intervals.  Events are resolved without a sync, at the fences the port
  already makes; the last :data:`MAX_SPANS` closed spans are kept in
  memory (:func:`spans`, :func:`reset`);
* counters (:func:`count`) and named host reads (:func:`host_read`: each
  device-to-host read of the sampling loop, counted and spanned by its
  site);
* :func:`phases`: the seconds by name of the spans a fit ran
  (``FitResult.history.phases``);
* :func:`trace` (a Chrome trace of a block), :func:`median_ms` (a
  kernel's median time) and :func:`card` (the card a measurement ran on).

Spans come in two granularities.  Block-level and coarser spans (the
entry points, the cache build, the init, each block of sweeps, each tier
step, each smart pass) are always recorded, at two event records each.
Per-sweep spans (``detail``), counters and host-read spans are recorded
only while tracing is on: while a torch profiler records, or after
:func:`enable`.  Off, each such site costs one flag check: no event, no
``record_function``, no device op and no host read.  Tracing never
changes a draw, an order of sums or a label.

Span names are ``<layer>.<thing>``: ``entry.fit``, ``entry.standardize``,
``entry.transfer``, ``entry.init_state``, ``cache_build.featurize``,
``host_loop.step_block``, ``host_loop.tier_step``, ``table_math.smart``;
per sweep ``table_math.sample_params``, ``kernel_a.assign_and_stats``,
``table_math.moves``; at the sampler's calls into its family's
conjugate math (:func:`family_span`), ``table_math.family.draw``,
``.posterior`` and ``.marginal``; and ``host_sync.<site>`` with the counters
``sweeps`` and ``smart_sums`` (the smart pass's per-slot sums taken by
kernel B on a card) and :data:`ROUTE_COUNTERS` (kernel A's tensor-core
launches and those of its resident kernel, counted on the host where the
route is chosen).  Kernel A's counters :data:`PASS_COUNTERS` are kept on
the card (:func:`pass_tally`: its launches add to them in stream order, so
counting waits for nothing) and read into :func:`counters` when it is
called.  The record belongs to the process and is not thread-safe: the
sampler drives one card from one thread.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

MAX_SPANS = 4096          # closed spans kept in memory, the newest
# kernel A's tensor-core launches at a pass width of 256 whose table width
# calls for more than one pass: the passes they ran (up to the highest live
# column) and the passes the width calls for
PASS_COUNTERS = ("kernel_a.passes_run", "kernel_a.passes_width")
# kernel A's tensor-core launches that the resident kernel takes, and all of
# them (counted on the host where the route is chosen)
ROUTE_COUNTERS = ("kernel_a.resident_launches", "kernel_a.tc_launches")
_TALLY = {}               # device -> int64 [2] of PASS_COUNTERS on the card

_autograd_profiler = torch.autograd.profiler


def _profiler_on() -> bool:
    """Whether a torch profiler records (the flag its start sets)."""
    return _autograd_profiler._is_profiler_enabled


@dataclasses.dataclass
class Span:
    """A closed span: its name, its id and its parent's (None at the top),
    whether it is a per-sweep (``detail``) span, and its start and length
    in seconds.  ``start`` is on the process's span clock: the host's
    ``perf_counter`` when the first device span opened, plus the card's
    time since then (device spans), or ``perf_counter`` itself."""

    name: str
    id: int
    parent: Optional[int]
    detail: bool
    owner: Optional[int] = None     # the enclosing ``phases`` span's id
    start: float = math.nan
    seconds: float = math.nan

    @property
    def end(self) -> float:
        return self.start + self.seconds


class _Record:
    """The process's spans and counters (module functions below)."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.enabled = False
        self.origins = {}          # device index -> (origin event, host s)
        self.reset()

    def reset(self) -> None:
        self.closed = collections.deque(maxlen=self.limit)
        self.pending = collections.deque()   # (span, device, start, end)
        self.counters = {}
        self.totals = {}           # phases span id -> {name: seconds}
        self.current = None        # innermost open span's id
        self.owner = None          # innermost open phases span's id
        self.next_id = 0

    def close(self, span: Span) -> None:
        self.closed.append(span)
        totals = self.totals.get(span.owner)
        if totals is not None and not span.detail:
            totals[span.name] = totals.get(span.name, 0.0) + span.seconds

    def resolve(self, wait: bool = False) -> None:
        """Close the pending device spans whose end event the card has
        passed, in the order they ended; with ``wait``, all of them,
        waiting on each end event."""
        while self.pending:
            span, dev, start, end = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            origin, host0 = self.origins[dev]
            span.start = host0 + origin.elapsed_time(start) / 1e3
            span.seconds = start.elapsed_time(end) / 1e3
            self.pending.popleft()
            self.close(span)


_REC = _Record()


class _Open:
    """An open span (what :func:`span` returns while it is recorded)."""

    __slots__ = ("span", "phases", "rf", "dev", "ev", "t0", "prev",
                 "prev_owner")

    def __init__(self, name: str, detail: bool, phases: bool):
        _REC.next_id += 1
        self.span = Span(name, _REC.next_id, None, detail)
        self.phases = phases

    def __enter__(self) -> Span:
        rec, span = _REC, self.span
        if not span.detail:
            rec.resolve()
        self.rf = None
        if _profiler_on():
            self.rf = _autograd_profiler.record_function(span.name)
            self.rf.__enter__()
        self.prev, self.prev_owner = rec.current, rec.owner
        span.parent = rec.current
        rec.current = span.id
        if self.phases:
            rec.owner = span.id
            rec.totals[span.id] = {}
        span.owner = rec.owner
        self.ev = None
        if torch.cuda.is_initialized():
            self.dev = torch.cuda.current_device()
            if self.dev not in rec.origins:
                origin = torch.cuda.Event(enable_timing=True)
                origin.record()
                rec.origins[self.dev] = (origin, time.perf_counter())
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t0 = time.perf_counter()
        return span

    def __exit__(self, *exc) -> bool:
        rec, span = _REC, self.span
        if self.ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.pending.append((span, self.dev, self.ev, end))
        else:
            t1 = time.perf_counter()
            span.start, span.seconds = self.t0, t1 - self.t0
            rec.close(span)
        rec.current, rec.owner = self.prev, self.prev_owner
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether per-sweep spans, counters and host-read spans are recorded:
    while a torch profiler records, or after :func:`enable`."""
    return _REC.enabled or _profiler_on()


def enable(on: bool = True) -> None:
    """Record per-sweep spans, counters and host reads outside a profiler
    too (``enable(False)`` stops)."""
    _REC.enabled = bool(on)


def span(name: str, *, detail: bool = False, phases: bool = False):
    """A context manager that records the span ``name`` around its block
    and yields its :class:`Span` (timed once resolved).  A ``detail``
    (per-sweep) span is recorded only while :func:`tracing`; otherwise
    this returns a shared no-op context.  A ``phases`` span totals the
    seconds of the spans under it by name (:func:`phases`)."""
    if detail and not tracing():
        return _OFF
    return _Open(name, detail, phases)


def family_span(kind: str):
    """The per-sweep span ``table_math.family.<kind>`` around one call of
    the sampler into its family's conjugate math, whatever the family:
    ``draw`` (``posterior_cache`` with ``sample_params``), ``posterior``
    (``calc_posterior``) or ``marginal`` (``log_marginal``, with its
    ``posterior_cache``, and ``log_marginal_pairwise``).  Recorded only
    while :func:`tracing`, as every ``detail`` span."""
    return span("table_math.family." + kind, detail=True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while :func:`tracing`."""
    if tracing():
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def _read(x: torch.Tensor):
    return x.item() if x.dim() == 0 else x.tolist()


def host_read(x: torch.Tensor, site: str):
    """``x`` on the host (``x.item()`` for a 0-d tensor, else
    ``x.tolist()``): a device-to-host read, which waits for the card.
    While :func:`tracing`, the read counts under ``host_sync.<site>`` and
    is spanned by that name."""
    if not tracing():
        return _read(x)
    name = "host_sync." + site
    _REC.counters[name] = _REC.counters.get(name, 0) + 1
    with _Open(name, True, False):
        return _read(x)


def resolve() -> None:
    """Time the spans whose end the card has passed, without a sync: call
    it after a host read (a fence)."""
    _REC.resolve()


def spans() -> list:
    """The closed spans, oldest first (the newest :data:`MAX_SPANS`),
    after waiting for the pending ones' ends."""
    _REC.resolve(wait=True)
    return list(_REC.closed)


def pass_tally(device) -> torch.Tensor:
    """The card's tally of :data:`PASS_COUNTERS`, int64 [2] on ``device``,
    to which kernel A's launches add while :func:`tracing` (made once a
    device, zeros)."""
    tally = _TALLY.get(device)
    if tally is None:
        tally = _TALLY[device] = torch.zeros(2, dtype=torch.int64,
                                             device=device)
    return tally


def counters() -> dict:
    """The counters, by name, with the cards' pass tallies added where
    they counted any (reading a tally waits for the card)."""
    out = dict(_REC.counters)
    for tally in _TALLY.values():
        counts = tally.tolist()
        if counts[1]:
            for name, n in zip(PASS_COUNTERS, counts):
                out[name] = out.get(name, 0) + n
    return out


def phases(root: Span) -> dict:
    """{span name: seconds} of the always-on spans under the closed
    ``phases`` span ``root``, ``root`` included, summed by name; asked once
    (the totals are then dropped)."""
    _REC.resolve(wait=True)
    return _REC.totals.pop(root.id, {})


def reset() -> None:
    """Drop every span and counter (open spans close as usual) and zero
    the cards' pass tallies."""
    _REC.reset()
    for tally in _TALLY.values():
        tally.zero_()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace around a block::

        with profiling.trace("traces/dpmm"):
            dpmm.fit(x, iters=10)

    Host activity is always traced, the card's kernels when CUDA is
    available; the port's spans name the host intervals.  On exit the
    trace is written to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing).
    Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def median_ms(fn, device, reps: int = 10) -> float:
    """Median time of ``fn()`` over ``reps`` runs after one warm-up: CUDA
    events around each run on a card, the host clock on the CPU."""
    cuda = torch.device(device).type == "cuda"
    fn()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def card(device) -> str:
    """What a measurement ran on: for a CUDA device the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (the card's name alone where
    nvidia-smi cannot be run), else the device type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(device)
