"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
with both configurations cut to a size the CPU runs in seconds
(``tinybench``), and one run of a cell there on the port's plain PyTorch
path."""
from __future__ import annotations

import time

import pytest

from tinybench import make_tiny


@pytest.fixture
def tiny(tmp_path):
    from dpmmbench import harness

    bench = make_tiny(tmp_path)
    return harness.Spec(bench, tmp_path / "dpmmbench")


@pytest.fixture
def run_cell(tiny):
    """``run_cell(cell, seed=..., seconds=..., trace=..., control=...)``:
    one run of a tiny cell on the CPU; returns the result's object."""
    from dpmmbench import harness

    def run(cell, seed=2**31 + 7, seconds=0.3, trace=False, control=False):
        return harness.run(tiny, cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), control=control)

    return run
