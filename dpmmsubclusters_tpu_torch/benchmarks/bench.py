"""Benchmark: Gibbs-sweep throughput on the flagship 1M x 32-d Gaussian
configuration, the port of the JAX package's ``bench.py``.

Prints ONE JSON line on stdout (diagnostics go to stderr)::

  {"metric": "gibbs_sweep_throughput_1Mx32d", "value": N, "unit":
   "points/s", "vs_baseline": N, "k": K, "ms_per_sweep": t, "device": "..."}

``device`` is the card's name and power limit from nvidia-smi ("cpu" on the
CPU).  The data, config and loop are ``bench.py``'s: a mixture of 64
separated Gaussians (means x8, unit covariances, ``default_rng(0)``),
centred; ``k_max=128`` at a fixed table width (the engine, not ``fit``:
no capacity tiers); the f32 feature cache (``BENCH_FDT`` picks another
layout); the config's default ``ll_precision`` (one bf16 pass for kernel
A's ll product); 5 warm-up blocks of 16 sweeps, then 5 timed blocks fenced once at
the end.  ``BENCH_SMALL=1`` runs 100k x 32-d (K=20, ``k_max=32``, blocks of
10 sweeps).  ``vs_baseline`` divides by ``bench.py``'s estimate of a 32-core
host running the reference (4.4e4 points/s).

    python -m dpmmsubclusters_tpu_torch.benchmarks.bench [--device cuda]
        [--trace DIR]

``--trace DIR`` profiles one more sweep after the timed window
(:func:`..utils.profiling.trace`) and writes its trace into DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import DPMMConfig
from ..priors import GAUSSIAN
from ..sampler.driver import DPMMEngine
from ..utils import profiling

BASELINE_PTS_PER_S = 4.4e4
T0 = time.time()


def log(msg: str) -> None:
    print(f"[bench {time.time() - T0:6.1f}s] {msg}", file=sys.stderr,
          flush=True)


def run(device="cuda", small: bool = False, fdt=None, n=None,
        trace_dir=None) -> dict:
    """The benchmark; returns the JSON line's object.  ``n`` overrides the
    point count (a rehearsal at a small size); ``fdt`` the cache layout."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: CUDA is not available; pass --device cpu "
                           "for a rehearsal on the plain PyTorch path")
    if small:
        n0, d, k_true, k_max, warmup, timed = 100_000, 32, 20, 32, 10, 10
    else:
        # block length 16 = DPMMConfig.fused_block; warm-up runs 5 blocks
        # (the chain reaches K=64 around sweep 60), then 5 timed blocks
        n0, d, k_true, k_max, warmup, timed = 1_000_000, 32, 64, 128, 80, 16
    n = n0 if n is None else int(n)

    rng = np.random.default_rng(0)
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    labels = rng.integers(0, k_true, size=n)
    x = means[labels] + rng.standard_normal((n, d)).astype(np.float32)
    log(f"data generated: {n} x {d}, K={k_true}, on {device}")

    cfg = DPMMConfig(k_max=k_max, chunk_size=16384, burnout=5, alpha=10.0,
                     verbose=False, track_posterior=False,
                     merge_candidates=k_max, precompute_features=True,
                     **({"feature_dtype": fdt} if fdt else {}))
    engine = DPMMEngine(GAUSSIAN, cfg, device)
    points, valid, n_total = engine.shard_points(x - x.mean(0))
    points = engine.featurize(points)
    prior = GAUSSIAN.default_prior(d)
    gen = torch.Generator(device=device).manual_seed(0)
    state = engine.init_state(gen, points, valid, prior)
    log("points placed + featurized, init done")

    off = np.zeros(timed, bool)
    for _ in range(max(1, warmup // timed)):
        state, metrics = engine.step_block(state, points, valid, n_total,
                                           off, off)
    log(f"warm-up blocks done: K={int(metrics['k'][-1])}")

    blocks = 5
    t0 = time.perf_counter()
    for _ in range(blocks):
        state, metrics = engine.step_block(state, points, valid, n_total,
                                           off, off)
    k_final = int(metrics["k"][-1])  # the one fence, after all blocks
    dt = time.perf_counter() - t0
    sweeps = timed * blocks
    pts_per_s = n * sweeps / dt
    log(f"timed: {dt / sweeps * 1e3:.3f} ms/sweep, K={k_final}")
    if trace_dir is not None:
        with profiling.trace(trace_dir):
            state, metrics = engine.step(state, points, valid, n_total,
                                         False, False)
            metrics["k"].item()
        log(f"one sweep traced into {trace_dir}")
    return {
        "metric": "gibbs_sweep_throughput_1Mx32d",
        "value": round(pts_per_s, 1),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / BASELINE_PTS_PER_S, 2),
        "k": k_final,
        "ms_per_sweep": dt / sweeps * 1e3,
        "device": profiling.card(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile one sweep after the timed window into DIR")
    args = ap.parse_args(argv)
    out = run(args.device,
              small=os.environ.get("BENCH_SMALL", "") not in ("", "0"),
              fdt=os.environ.get("BENCH_FDT", "") or None,
              trace_dir=args.trace)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
