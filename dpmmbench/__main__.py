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

A cell on ``chips`` > 1 cards runs one rank a card (``ranks.py``): this
process is rank 0, builds the kernels' library, starts the other ranks
as children with the hidden ``--rank`` arguments, prints the result once
every rank has exited 0, and exits non-zero without one where a rank
fails, finds JAX loaded, or the run passes its deadline.
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


def main(argv=None, device=None) -> int:
    """The command; ``device`` "cpu" drives a run without the look for a
    card (the benchmark's own tests)."""
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
    # a child rank's own (ranks.Launcher)
    for flag, kind in (("--rank", int), ("--world", int),
                       ("--rendezvous", str), ("--device", str),
                       ("--parent", int)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from dpmmbench import harness

    spec = harness.Spec(Path("BENCHMARK.json"))
    chips = int(spec.cell(args.workload)["chips"])
    if args.rank is not None:
        return _child_rank(spec, args, t_proc)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            harness.log(f"needs {chips} CUDA card(s); torch sees "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
    if chips == 1:
        result = harness.run(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), device, t_proc,
                             control=bool(args.control))
    else:
        result = _rank0(spec, args, chips, device, t_proc,
                        sys.argv[1:] if argv is None else list(argv))
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"modules of JAX or the JAX package are loaded: {loaded}")
        return 3
    for key, v in result["checked"].items():
        print(f"{key} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _rank0(spec, args, chips: int, device: str, t_proc: float,
           argv: list) -> dict:
    """Rank 0 of a cell on ``chips`` cards (``device`` "cuda" or "cpu"):
    the kernels' library built before any other rank starts, the children
    started and watched, this rank's run, and every child ended before
    the result."""
    from dpmmbench import harness, ranks, system

    system.load_kernels(device)
    traffic = harness.plan(spec, args.workload).traffic
    launcher = ranks.Launcher(argv, chips, device,
                              args.seconds + traffic["margin_s"])
    launcher.start()
    try:
        result = harness.run(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), launcher.ranks(0).device,
                             t_proc, control=bool(args.control),
                             ranks=launcher.ranks(0))
    except BaseException:
        launcher.kill()
        raise
    launcher.wait()
    return result


def _child_rank(spec, args, t_proc: float) -> int:
    """Rank ``args.rank`` of a cell on several cards: its run, whose
    numbers reach rank 0 through the process group, then the look for
    JAX in this process."""
    from dpmmbench import harness, ranks

    ranks.die_with_parent(args.parent)
    me = ranks.Ranks(args.world, args.rank, args.rendezvous, args.device)
    harness.run(spec, args.workload, args.seed, args.seconds,
                bool(args.trace), me.device, t_proc,
                control=bool(args.control), ranks=me)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"rank {args.rank}: modules of JAX or the JAX package "
                    f"are loaded: {loaded}")
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
