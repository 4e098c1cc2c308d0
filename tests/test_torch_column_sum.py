"""Kernel C's walk (``csrc/column_sum.cu``, the column sums that kernel D's
``dma_only``, ``dot_only`` and ``stats_raw`` sets share) on the CPU: its
numpy model (``tests/torch_column_walk.py``: which block takes which
groups, the slot order, the partial rows and their fixed-order reduction,
the part-group of the last rows) against the port's plain version and
float64 sums, and against the TPU tile study's ``dma_only`` kernel
(``benchmarks/kernel_tile_study.py`` ``variant``) run through the Pallas
interpreter.  Tolerance: 1e-5 of the sum of the terms' magnitudes plus
1e-6 (float32 sums of the same terms in other orders).  The kernel runs on
the card: ``tests/test_torch_card_bench.py``, where its bits must equal the
model's."""
import torch_threads  # noqa: F401

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import torch_column_walk as walk  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import study_kernels as stk  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FS = (1, 3, 5, 128, 129, 561, 640, 1025)
# "stages": the groups of four stages and a part-group of 3 rows
NS = (1, 3, 4, 1025, "stages")
BLOCKS = (1, 7, 132)  # one run; runs of two lengths; an H100's B at 1M rows
RTOL, ATOL = 1e-5, 1e-6


def _rows(n, f: int) -> int:
    return 4 * 4 * walk.step_groups(f) + 3 if n == "stages" else n


def _assert_close(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - want)
    bad = err > RTOL * mag + ATOL
    assert not bad.any(), (int(bad.sum()), float(err.max()))


@pytest.mark.parametrize("f", FS)
@pytest.mark.parametrize("n", NS)
def test_walk_matches_plain_and_float64(rng, n, f):
    n = _rows(n, f)
    x = rng.standard_normal((n, f)).astype(np.float32)
    want = x.astype(np.float64).sum(0)
    mag = np.abs(x.astype(np.float64)).sum(0)
    plain = stk.column_sum_reference(torch.from_numpy(x)).numpy()[0]
    _assert_close(plain, want, mag)
    for blocks in BLOCKS:
        got = walk.column_sum(x, blocks)
        assert got.dtype == np.float32 and got.shape == (f,)
        _assert_close(got, want, mag)
        _assert_close(got, plain.astype(np.float64), mag)


@pytest.mark.parametrize("n,blocks", [(1, 1), (3, 1), (1025, 7),
                                      (1025, 300), (4 * 132 * 20 + 2, 132)])
def test_walk_partial_rows_hold_each_runs_rows(rng, n, blocks):
    """On small integers (exact float32 sums) partial row 4b + r holds
    column by column the sum of row r of every group of run b, and the last
    run also the part-group's rows; the runs cover the groups once, in
    order, their lengths at most one apart."""
    f = 7
    x = rng.integers(-8, 9, size=(n, f)).astype(np.float32)
    bounds = walk.runs(n, blocks)
    assert bounds[0] == 0 and bounds[-1] == n // 4
    assert np.all(np.diff(bounds) >= 0)
    assert np.ptp(np.diff(bounds)) <= 1
    part = walk.partials(x, blocks).reshape(blocks, 4, f)
    for b in range(blocks):
        rows = x[4 * bounds[b]:4 * bounds[b + 1]].reshape(-1, 4, f).sum(0)
        if b == blocks - 1:
            tail = x[4 * (n // 4):]
            rows[:len(tail)] += tail
        np.testing.assert_array_equal(part[b], rows)
    np.testing.assert_array_equal(walk.column_sum(x, blocks), x.sum(0))


def test_walk_blocks_and_stages():
    """B is the resident blocks once N gives every one a run of 16 groups,
    fewer below, at least one; a stage takes as many whole groups of the
    first 1024 slots as fit 32 KB (at least two)."""
    assert walk.column_blocks(1 << 20, 132) == 132
    assert walk.column_blocks(4 * 16 * 10, 132) == 10
    assert walk.column_blocks(3, 132) == walk.column_blocks(0, 132) == 1
    assert [walk.step_groups(f) for f in (1, 561, 640, 1024, 1025)] == [
        2048, 3, 3, 2, 2]


@pytest.fixture(scope="module")
def tile_study():
    """The JAX package's benchmarks/kernel_tile_study.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_kernel_tile_study_colsum",
        ROOT / "benchmarks" / "kernel_tile_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the test in the Pallas interpreter."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("f", FS)
def test_walk_matches_tpu_dma_only(rng, tile_study, interpret, f):
    """The model against the TPU tile study's dma_only kernel at N = four
    stages and 3 rows, padded with zero rows to whole 128-row tiles (zeros
    leave column sums as they are)."""
    n, k, tile = _rows("stages", f), 1, 128
    x = rng.standard_normal((n, f)).astype(np.float32)
    pad = -n % tile
    xp = np.concatenate([x, np.zeros((pad, f), np.float32)])
    _, _, stj = tile_study.variant(
        7, jnp.asarray(xp), jnp.ones(((n + pad) // 128, 128), jnp.float32),
        jnp.zeros((f, 2 * k), jnp.float32), jnp.zeros(k, jnp.float32),
        k_slots=k, tile=tile, vmem_mb=64, stats_prec="split2",
        dma_only=True)
    tpu = np.asarray(stj)[0]
    mag = np.abs(x.astype(np.float64)).sum(0)
    for blocks in BLOCKS:
        _assert_close(walk.column_sum(x, blocks), tpu.astype(np.float64),
                      mag)
    _assert_close(tpu, x.astype(np.float64).sum(0), mag)
