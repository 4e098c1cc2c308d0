"""The roofline counts: equal to the kernel table's bounds where the shapes
agree, scaled with the live clusters, and independent of the kernel."""
from __future__ import annotations

import importlib.util
import json

import pytest

from tinybench import REPO

METRICS = REPO / "dpmmbench" / "metrics"
PEAKS = json.loads((REPO / "dpmmbench" / "peaks.json").read_text())


def count(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.least_s


def shape(n, d, k, rows, passes=3, peak="bf16"):
    return dict(n=n, d=d, f=1 + d + d * (d + 1) // 2, k_live=k, rows=rows,
                passes=passes, peak=peak)


def test_assign_bound_at_the_kernel_tables_shape():
    """PERF.md's kernel table: kernel A on the f32 cache at F=561, N=2^20,
    K=64 is bound by bytes at 0.705 ms; the bf16 cache at 0.354 ms."""
    least = count("assign_roofline")
    assert round(least(shape(2 ** 20, 32, 64, "f32_cache"), PEAKS) * 1e3,
                 3) == 0.705
    assert round(least(shape(2 ** 20, 32, 64, "bf16_cache", 1), PEAKS)
                 * 1e3, 3) == 0.354
    assert round(count("stats_roofline")(
        shape(2 ** 20, 32, 64, "f32_cache"), PEAKS) * 1e3, 3) == 0.705


def test_built_rows_are_bound_by_three_bf16_passes_at_live_k():
    """10M x 64-d without a cache at live K=100: three bf16 passes of
    2 F (K + 1) a point, 13.1 ms, and the row build at float32's peak."""
    least = count("assign_roofline")
    w = shape(10_000_000, 64, 100, "raw")
    product = 3 * 2.0 * 1e7 * 2145 * 101 / 989e12
    built = 1e7 * 2080 / 67e12
    assert least(w, PEAKS) == pytest.approx(product + built, rel=1e-12)
    assert 13.0e-3 < product < 13.3e-3


@pytest.mark.parametrize("name", ["assign_roofline", "stats_roofline",
                                  "sweep_mfu"])
@pytest.mark.parametrize("rows", ["f32_cache", "hybrid", "raw"])
def test_counts_follow_live_k(name, rows):
    """More live clusters never lower a count; where the product bounds it
    (rows built from the points), it grows with K + 1."""
    least = count(name)
    lo = least(shape(10_000_000, 64, 50, rows), PEAKS)
    hi = least(shape(10_000_000, 64, 100, rows), PEAKS)
    assert hi >= lo > 0
    if rows == "raw" and name == "assign_roofline":
        built = 1e7 * 2080 / 67e12
        assert (hi - built) / (lo - built) == pytest.approx(101 / 51)


def test_the_hybrid_sweep_reads_its_bf16_cache_and_raw_points_once():
    """10M x 64-d hybrid: 42.9 GB of bf16 rows and 2.56 GB of points, 13.6
    ms at 3.35 TB/s, the sweep's bound."""
    w = shape(10_000_000, 64, 100, "hybrid", passes=1)
    t = count("sweep_mfu")(w, PEAKS)
    assert 13.5e-3 < t < 13.7e-3
    assert count("assign_roofline")(w, PEAKS) < t
