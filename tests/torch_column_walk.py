"""A numpy model of kernel C's walk (``csrc/column_sum.cu``), for the tests
on the CPU (``tests/test_torch_column_sum.py``) and on the card
(``tests/test_torch_card_bench.py``, where the kernel's bits must equal the
model's).  Imports numpy only.

The walk: the N / 4 whole groups of four rows (4F floats each, flat) are cut
into ``blocks`` runs, run b the groups [b G / B, (b + 1) G / B); a block adds
its run's groups in group order into 4F float32 sums, each flat position its
own sum, and the last block then adds the part-group of the N % 4 last
rows; the blocks' sums are 4B partial rows of F, which a second pass adds
in a fixed order: way w (of 32) sums the rows w, w + 32, ... in order, then
the 32 ways are added in order.  Every sum starts at 0 and adds one float32
term at a time, as the kernel does (no fused multiply-add, no reordering),
so the model's bits are the kernel's.
"""
import numpy as np

CHUNK_SLOTS = 1024     # float4 slots a block takes (more go to grid.y)
STAGE_SLOTS = 2048     # float4 a shared-memory stage holds (32 KB)
MIN_RUN_GROUPS = 16    # a run's least length where N allows it
RED_WAYS = 32          # partial rows the reduction sums side by side


def step_groups(f: int) -> int:
    """Whole groups one stage takes at F (the first chunk of slots)."""
    return STAGE_SLOTS // min(f, CHUNK_SLOTS)


def column_blocks(n: int, resident: int) -> int:
    """The walk's B at N rows where ``resident`` blocks fill the card."""
    runs = -(-(n // 4) // MIN_RUN_GROUPS)
    return max(1, min(runs, resident))


def runs(n: int, blocks: int) -> np.ndarray:
    """The run boundaries [B + 1]: block b takes groups [r[b], r[b + 1])."""
    return (n // 4) * np.arange(blocks + 1, dtype=np.int64) // blocks


def partials(x: np.ndarray, blocks: int) -> np.ndarray:
    """The blocks' partial rows [4B, F] (float32) of x [N, F] (float32)."""
    n, f = x.shape
    g = n // 4
    flat = x[:4 * g].reshape(g, 4 * f)
    bounds = runs(n, blocks)
    start, length = bounds[:-1], np.diff(bounds)
    acc = np.zeros((blocks, 4 * f), np.float32)
    for i in range(int(length.max(initial=0))):
        live = length > i
        acc[live] += flat[start[live] + i]
    tail = x[4 * g:].reshape(-1)
    acc[-1, :tail.size] += tail
    return acc.reshape(4 * blocks, f)


def reduce_rows(partial: np.ndarray) -> np.ndarray:
    """The fixed-order sum [F] of the partial rows [R, F]."""
    ways = np.zeros((RED_WAYS, partial.shape[1]), np.float32)
    for r in range(partial.shape[0]):
        ways[r % RED_WAYS] += partial[r]
    total = np.zeros(partial.shape[1], np.float32)
    for w in range(RED_WAYS):
        total += ways[w]
    return total


def column_sum(x: np.ndarray, blocks: int) -> np.ndarray:
    """Kernel C's column sums [F] of x [N, F] over ``blocks`` runs."""
    return reduce_rows(partials(np.ascontiguousarray(x, np.float32), blocks))
