"""Time kernel A over the bf16 feature caches on the card, for A/B runs of
its one-bf16-pass kernels: the whole call of each shape under
``"default"`` (one bf16 pass over a bf16 cache) with each kernel's device
time, or, with ``--pitches``, the exact route (``"highest"``) and one bf16
pass over the flagship's bf16 cache (F=561, K=128) laid out at each row
pitch (the cache's values the same, rows that many values apart).  One
JSON line a measurement, with the card's name and power limit; ``--tag``
names the tree.

    python scripts/bf16_cache_timing.py [--tag NAME] \\
        [--shapes "bfloat16 K=128,hybrid K=256"] [--pitches 561,568,576] \\
        [--rounds 2]

It drives the ``dpmmsubclusters_tpu_torch`` and ``chip_smoke.py`` of the
tree it lies in (``chip_smoke.Case``'s inputs: the flagship's 1M x 32-d
rows, or the 10M x 64-d fit's rows at 1M points): copy it into another
tree (a ``git archive`` of an earlier commit) to time that one in turns.
Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = ("bfloat16 K=128", "hybrid K=256")


def main() -> int:
    import torch

    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default=ROOT.name)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--pitches", default="")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_cache_timing: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    x, _ = cs.separated_data(cs.N_CHECK, cs.D_FLAG, cs.K_TRUE_FLAG)
    x = (x - x.mean(0)) / x.std(0)

    def emit(**row):
        print(json.dumps(dict(row, tree=args.tag, card=smi)), flush=True)

    def timed(case, prec):
        def call():
            return sk.fused_assign(*case.args(), False, **case.kw(),
                                   ll_precision=prec)
        kernels = {k: v for k, v in cs.device_ms_by_kernel(
            torch, call).items() if "assign" in k or "stage_phi" in k}
        return cs.time_ms(torch, call), kernels

    if args.pitches:
        case = cs.Case(torch, dev, x, "gaussian", cs.K_MAX_FLAG,
                       cache="bfloat16")
        base, f = case.x, case.x.shape[1]
        views = {}
        for ld in (int(v) for v in args.pitches.split(",")):
            buf = torch.zeros((base.shape[0], ld), dtype=torch.bfloat16,
                              device=dev)
            buf[:, :f] = base
            views[ld] = buf[:, :f]
        for _ in range(args.rounds):
            for ld, view in views.items():
                case.x = view
                for prec in ("highest", "default"):
                    if prec == "default" and ld % sk.BF16_ROW_ALIGN:
                        continue   # its kernel copies such a cache first
                    ms, kernels = timed(case, prec)
                    emit(pitch=ld, ll_precision=prec, ms=ms, kernels=kernels)
        return 0

    x64, _ = cs.separated_data(cs.N_CHECK, 64, 100)
    x64 = (x64 - x64.mean(0)) / x64.std(0)
    for _ in range(args.rounds):
        for shape in args.shapes.split(","):
            variant, k = shape.split(" K=")
            rows = x64 if variant == "hybrid" else x
            case = cs.Case(torch, dev, rows, "gaussian", int(k),
                           cache="bfloat16")
            if variant == "hybrid":
                case = case.as_hybrid()
            ms, kernels = timed(case, "default")
            emit(shape=shape, ll_precision="default", ms=ms, kernels=kernels)
            del case
            cs.free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
