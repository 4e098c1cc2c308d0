"""Stage-by-stage ablation of the round-3 assignment kernel, the port of the
JAX package's ``benchmarks/kernel_ablate.py``: where do the milliseconds
go?

Kernel D (:func:`..ops.study_kernels.kernel_ablate`) keeps the round-3
layout (phi [F, 3K] = [whole | left | right], loglrw [2, K]) with each
stage gated at compile time; cumulative timings attribute the time to the
product and to the later stages (Gumbel noise, the sub-label pick, the
statistics pass, the label writes).  Two parts, as on the TPU:

* the DMA-shape study: ``dma_only`` (column sums of x) and ``dot_only``
  (column sums of x @ phi) at F = 1 + D + D(D+1)/2 and F padded to 128,
  hash tiles 512 and 1024; rows ``study``, ``f``, ``tile``, ``ms``,
  ``GB_s``, ``device``;
* the 8 stage sets of VARIANTS at that F and tile 512; rows ``variant``,
  ``stages``, ``ms``, ``delta_ms`` (against the row before), ``device``.

Inputs: x and phi standard normal, log_w and loglrw 0, every point valid.
Times are medians of CUDA-event timings.  On the card ``stats_raw`` no
longer isolates a matmul: its 2K rows of column sums are one reduction.
Nor does ``dot_only`` time a product over the points: its output is
colsum(x) @ phi and is computed so, one read of x.  The product is the
exact float32 one of ``ll_precision="highest"``; the fits' default takes
the tensor cores (``chip_smoke.py`` times the two side by side).

    python -m dpmmsubclusters_tpu_torch.benchmarks.kernel_ablate \\
        [n] [d] [k] [--device cuda] [--reps 10]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import study_kernels
from ..utils import profiling
from .kernel_tile_study import padded_dim

VARIANTS = [
    ("dma_only", ("dma_only",)),
    ("dot_only", ("dot_only",)),
    ("ll+argmax", ()),
    ("+stats_raw", ("stats_raw",)),
    ("+stats", ("stats",)),
    ("+gumbel", ("stats", "gumbel")),
    ("+sub", ("stats", "gumbel", "sub")),
    ("+write(full)", ("stats", "gumbel", "sub", "write")),
]
TILE = 512


def variant(seed, x, valid, phi, log_w, loglrw, *, tile: int, stages):
    """One stage set over ``x`` [N, F]: ``(labels int32 [N], sub int32 [N],
    stats float32 [2K, F])``."""
    return study_kernels.kernel_ablate(x, valid, phi, log_w, loglrw, seed,
                                       tile=tile, stages=stages)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1_048_576)
    ap.add_argument("d", type=int, nargs="?", default=32)
    ap.add_argument("k", type=int, nargs="?", default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = profiling.card(device)
    n, k = args.n, args.k
    f = 1 + args.d + args.d * (args.d + 1) // 2
    gen = torch.Generator(device=device).manual_seed(0)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    log_w = torch.zeros(k, device=device)
    loglrw = torch.zeros((2, k), device=device)
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    rows = []

    def emit(row):
        row["device"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)

    # DMA shape study: does the unaligned lane count or the tile height
    # move the rate at which the rows stream in?
    for fp in (f, padded_dim(args.d)):
        x = torch.randn((n, fp), generator=gen, device=device)
        phi = torch.randn((fp, 3 * k), generator=gen, device=device)
        for tile in (512, 1024):
            for st in ("dma_only", "dot_only"):
                ms = profiling.median_ms(
                    lambda: variant(seed, x, valid, phi, log_w, loglrw,
                                    tile=tile, stages=(st,)),
                    device, args.reps)
                emit({"study": st, "f": fp, "tile": tile, "ms": ms,
                      "GB_s": n * fp * 4 / (ms * 1e-3) / 1e9})
        del x, phi

    x = torch.randn((n, f), generator=gen, device=device)
    phi = torch.randn((f, 3 * k), generator=gen, device=device)
    prev = None
    for name, stages in VARIANTS:
        ms = profiling.median_ms(
            lambda: variant(seed, x, valid, phi, log_w, loglrw, tile=TILE,
                            stages=stages),
            device, args.reps)
        emit({"variant": name, "stages": study_kernels.stage_key(stages),
              "ms": ms, "delta_ms": None if prev is None else ms - prev})
        prev = ms
    return rows


if __name__ == "__main__":
    main()
