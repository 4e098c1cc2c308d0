"""Run one cell of the port's benchmark once, on the card::

    python3 -m dpmmbench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

Prints the result as the last line of standard output (one JSON object)
and each compared number beside its limit as the last lines of standard
error.  Exits non-zero, with no result, without CUDA or with fewer cards
than the cell asks for, and when a module of JAX or of the JAX package
is loaded once the window has closed.  ``--control 1`` judges, in the
port's place, the reference computed one precision below the stated one
(the control): a sound benchmark prints ``correct`` false for it.  The
benchmark's own runs leave it off.
"""
import time

T_ENTRY = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 where it cannot
    be read): the interpreter's start-up counts as set-up."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    t_proc = T_ENTRY - _process_age()
    ap = argparse.ArgumentParser(prog="python3 -m dpmmbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from dpmmbench import harness

    spec = harness.Spec(Path("BENCHMARK.json"))
    chips = int(spec.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(spec, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", t_proc,
                         control=bool(args.control))
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"modules of JAX or the JAX package are loaded: {loaded}")
        return 3
    for key, v in result["checked"].items():
        print(f"{key} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
