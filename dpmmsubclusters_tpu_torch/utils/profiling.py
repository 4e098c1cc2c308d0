"""Profiling helpers.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.utils.profiling`.  The
reference's only instrumentation is wall-clock accumulation per iteration
(``src/dp-parallel-sampling.jl:363-366``); the port exposes the same
per-iteration host timings (``FitResult.history.times``), device traces via
``torch.profiler`` (:func:`trace`), and the two measurements its benchmarks
share: a kernel's median time (:func:`median_ms`) and the card it ran on
(:func:`card`).
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace around a block::

        with profiling.trace("traces/dpmm"):
            dpmm.fit(x, iters=10)

    Host activity is always traced, the card's kernels when CUDA is
    available.  On exit the trace is written to ``log_dir`` as a Chrome
    trace (``trace_<pid>_<ns>.json``; open it in Perfetto or
    chrome://tracing).  Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulating wall-clock timer with named sections (host-side)."""

    def __init__(self):
        self.totals: dict = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync:
            # fence pending device work so the section is attributable
            _sync()
        self.totals[name] = self.totals.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        return "\n".join(
            f"{k:<{width}} {v * 1e3:10.1f} ms" for k, v in self.totals.items()
        )


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
