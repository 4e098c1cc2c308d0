"""A whole run of each kind of cell at a tiny size on the CPU: the result
line's keys, and sound runs judged correct."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from tinybench import REPO

CELLS = ["gauss-10Mx64d-k100.hybrid-steady", "gauss-1Mx32d-k64.fit",
         "gauss-10Mx64d-k100.nocache-steady"]


def test_result_line_keys(run_cell):
    out = run_cell(CELLS[0])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checked"
    assert set(out["metrics"]) == {"sweep_ms", "peak_mem_gb", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    assert all(set(v) == {"value", "limit"} for v in out["checked"].values())
    assert out["attempted"] % 16 == 0 and out["attempted"] > 0


def test_traced_result_carries_the_breakdown(run_cell):
    out = run_cell(CELLS[1], trace=True)
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the fit's program spans are read without a card
    assert {"loop_ms_per_sweep.fit", "outside_loop_s.fit"} <= set(
        out["metrics"])
    assert "fit_s" not in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(run_cell, cell):
    out = run_cell(cell, seed=2**31 + CELLS.index(cell))
    assert out["correct"], out["checked"]
    assert out["failed"] == 0


def test_the_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "dpmmbench", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
