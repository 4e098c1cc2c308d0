"""Tile-size / block-size study of the assignment kernel, the port of the
JAX package's ``benchmarks/kernel_tile_study.py``.

On the TPU the study asked whether larger tiles (512 to 4096 rows, with the
scoped VMEM limit lifted) amortize per-tile overheads against the stream
rate.  Here the hash tile T is a parameter of the Gumbel hash only and
costs nothing; what amortizes per-block overhead on the card is the point
block of a CUDA block, so each T is timed at blocks of 64, 128 and 256
points (kernel A's exact kernel at 4, 8 and 16 warps; the fits use 128).
The labels do not depend on the block.  Modes, per T:

* ``dma_only`` -- kernel C (:func:`..ops.study_kernels.column_sum`): stats
  row 0 = the column sums of x; the labels, sub-labels and other rows are 0.
* ``full`` -- kernel A ``precomputed`` at hash tile T.  The TPU study's
  ``full_split3`` and ``full_split2`` differ only in the bf16 split of the
  statistics dot, an MXU workaround; the port's statistics are exact f32,
  which meets both modes' tolerances, so there is one ``full`` row per
  block size.

Inputs: x standard normal [N, F] with F = 1 + D + D(D+1)/2 padded to a
multiple of 128 (640 at D=32), phi [F, 2K] standard normal x 0.01, log_w 0.
Prints one JSON row per (tile, mode, block): ``tile``, ``mode``,
``cta_points``, ``ms`` (median of CUDA-event timings), ``GB_s`` (x's bytes
over ms), ``pts_per_s_M``, ``device``.

    python -m dpmmsubclusters_tpu_torch.benchmarks.kernel_tile_study \\
        [n] [d] [k] [--device cuda] [--reps 10]
"""
from __future__ import annotations

import argparse
import json

import torch

from ..ops import study_kernels, sweep_kernels
from ..utils import profiling

TILES = (512, 1024, 2048, 4096)
MODES = ("dma_only", "full")


def variant(seed, x, valid, phi, log_w, *, tile: int, mode: str = "full",
            cta_points: int = sweep_kernels.FIT_CTA_POINTS):
    """One mode of the study over ``x`` [N, F]: ``(labels int32 [N], sub
    int32 [N], stats float32 [2K, F])`` (see the module note)."""
    if mode == "full":
        return sweep_kernels.fused_assign(x, valid, phi, log_w, seed, 0,
                                          False, tile=tile,
                                          cta_points=cta_points)
    if mode != "dma_only":
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    n, f = x.shape
    k = log_w.shape[0]
    labels = torch.zeros(n, dtype=torch.int32, device=x.device)
    sub = torch.zeros(n, dtype=torch.int32, device=x.device)
    stats = torch.zeros((2 * k, f), dtype=torch.float32, device=x.device)
    study_kernels.column_sum(x, out=stats[:1])
    return labels, sub, stats


def padded_dim(d: int) -> int:
    """The Gaussian feature width 1 + D + D(D+1)/2 padded to 128 lanes."""
    return ((1 + d + d * (d + 1) // 2 + 127) // 128) * 128


def inputs(n: int, d: int, k: int, device, seed: int = 0):
    """The study's inputs, drawn on ``device``: x, valid, phi, log_w."""
    f = padded_dim(d)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, f), generator=gen, device=device)
    phi = torch.randn((f, 2 * k), generator=gen, device=device) * 0.01
    return (x, torch.ones(n, dtype=torch.bool, device=device), phi,
            torch.zeros(k, device=device))


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
    x, valid, phi, log_w = inputs(args.n, args.d, args.k, device)
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    n, f = x.shape
    rows = []
    for tile in TILES:
        if n % tile:
            continue
        for mode, cta in [("dma_only", None)] + [
                ("full", c) for c in sweep_kernels.CTA_POINTS]:
            def fn(tile=tile, mode=mode,
                   cta=cta or sweep_kernels.FIT_CTA_POINTS):
                return variant(seed, x, valid, phi, log_w, tile=tile,
                               mode=mode, cta_points=cta)

            ms = profiling.median_ms(fn, device, args.reps)
            row = {"tile": tile, "mode": mode, "cta_points": cta, "ms": ms,
                   "GB_s": n * f * 4 / (ms * 1e-3) / 1e9,
                   "pts_per_s_M": n / (ms * 1e-3) / 1e6, "device": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
