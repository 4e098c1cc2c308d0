"""How often the 4-corner chain reaches K=4, in the PyTorch port on the
CPU under each ``ll_precision`` and in the JAX package, on the same seeds
(ROADMAP Queue 3, P8).

Two measurements, one JSON object printed at the end:

* ``chain``: 1000 points on the 4 corners (250 each at (+-10, +-10)),
  ``alpha=100``, ``burnout=5``, 60 sweeps, ``smart_splits=False``, seeds
  0..N-1: the count of seeds whose final K is 4;
* ``smart``: 2000 corner points, smart splits on (the default), the same
  config, seeds 0..M-1: for each seed the first sweep (0-based index into
  ``history.k``) at K > 1, and the final K;
* with ``--dense``: 2^20 corner points (``chip_smoke.py``'s distributed
  phase (c): smart splits on, 100 sweeps, seed 12345), ``history.k``.

    python scripts/corner_chain_counts.py port   # each ll_precision
    python scripts/corner_chain_counts.py jax
    python scripts/corner_chain_counts.py port --dense

The port runs with ``device="cpu"`` (its plain versions of the kernels);
the JAX package on the CPU (its Pallas kernel's f32 dot there).  Runs
``--workers`` processes with one thread each.
"""
import argparse
import json
import multiprocessing
import os

import numpy as np

PORT_PRECISIONS = ("default", "high", "highest", "bf16")


def corners(n: int) -> np.ndarray:
    x = np.zeros((n, 2), np.float32)
    q = n // 4
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * q:(i + 1) * q] = c
    return x


def _first_split(ks) -> int:
    return next((i for i, k in enumerate(ks) if k > 1), -1)


def _run(job):
    package, kind, prec, seed = job
    kw = dict(alpha=100.0, iters=60, seed=seed, burnout=5, verbose=False)
    if kind == "chain":
        kw["smart_splits"] = False
    if kind == "dense":
        kw["iters"] = 100
    x = corners({"chain": 1000, "smart": 2000, "dense": 1 << 20}[kind])
    if package == "port":
        import torch
        torch.set_num_threads(1)
        import dpmmsubclusters_tpu_torch as dpmm
        res = dpmm.fit(x, device="cpu", ll_precision=prec, **kw)
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import dpmmsubclusters_tpu as dpmm
        res = dpmm.fit(x, **kw)
    ks = [int(k) for k in res.history.k]
    if kind == "dense":
        return ks
    return int(res.k) if kind == "chain" else (_first_split(ks), int(res.k))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("port", "jax"))
    ap.add_argument("--chain-seeds", type=int, default=100)
    ap.add_argument("--smart-seeds", type=int, default=20)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    precs = PORT_PRECISIONS if args.package == "port" else ("default",)
    out = {}
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        if args.dense:
            hist = pool.map(_run, [(args.package, "dense", prec, 12345)
                                   for prec in precs])
            print(json.dumps({"package": args.package, "dense": dict(
                zip(precs, hist))}))
            return
        for prec in precs:
            ks = pool.map(_run, [(args.package, "chain", prec, s)
                                 for s in range(args.chain_seeds)])
            out[f"chain {prec}"] = {"k4": sum(k == 4 for k in ks),
                                    "seeds": len(ks)}
            smart = pool.map(_run, [(args.package, "smart", prec, s)
                                    for s in range(args.smart_seeds)])
            out[f"smart {prec}"] = {"first_split": [f for f, _ in smart],
                                    "k": [k for _, k in smart]}
            print(json.dumps({prec: [out[f"chain {prec}"],
                                     out[f"smart {prec}"]]}), flush=True)
    print(json.dumps({"package": args.package, **out}))


if __name__ == "__main__":
    main()
