"""The benchmark's harness: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration (its file of sizes,
family, sampler settings and reference module, ``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``), whose ``kind`` names the
runner that drives it (``traffic_kinds/<kind>.py``).  A run sets up (the
kernels' library, the data made on the device from ``--seed``, the cache
and initial state, a warm-up of the cell's own shapes), measures for
``--seconds``, then, with ``--trace 1``, traces a short span after the
window, and last judges the timed path's outputs (``check.py``, with the
configuration's reference module) against ``limits/<cell>.json``.
Per-layer metrics are read by the files of ``metrics/``, one a metric.
Every one of these is found by its name: a new configuration, traffic
mix, kind, reference or metric is a new file and new entries.

A cell on more than one card runs this once a rank (``ranks.py``): every
rank's kind runs the cell on its own card and rows, and rank 0's run
prints the result, with the numbers its kind gathered from the others.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dpmmsubclusters_tpu")


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    the name alone where it cannot be run."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name()


def log(msg: str) -> None:
    print(f"[dpmmbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared as whole names."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Spec:
    """``BENCHMARK.json`` and the files it names, found by name under
    ``root`` (the benchmark's folder)."""

    def __init__(self, bench_path, root=HERE):
        self.path = Path(bench_path)
        self.bench = json.loads(self.path.read_text())
        self.root = Path(root)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.path.parent / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        p = self.root / "limits" / f"{cell}.json"
        return json.loads(p.read_text())["limits"] if p.exists() else {}

    def data(self, name: str) -> dict:
        return json.loads((self.root / name).read_text())

    def _reports(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if self._reports(m, cell)]

    def per_layer(self, cell: str) -> list:
        """Per-layer metrics of a cell: those whose ``workloads`` list it."""
        return [m for m in self.bench["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py``, or of the file of
        the name without its last ``.`` suffix where the metric has no file
        of its own (one quantity split by the cells that report it)."""
        path = self.root / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.root / "metrics" / f"{base_name(metric)}.py"
        return _load(path, f"dpmmbench_metric_{metric}").read

    def runner(self, kind: str):
        """The ``run`` of ``traffic_kinds/<kind>.py``."""
        return _load(self.root / "traffic_kinds" / f"{kind}.py",
                     f"dpmmbench_kind_{kind}").run

    def reference(self, config: dict):
        """The configuration's reference module (its ``reference`` key, a
        path from the checkout's root)."""
        path = self.path.parent / config["reference"]
        return _load(path, f"dpmmbench_reference_{path.stem}")


def _load(path: Path, name: str):
    """The module of the file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def base_name(metric: str) -> str:
    """A split metric's quantity: its name without the last ``.`` suffix
    (``device_idle_pct.fit`` is ``device_idle_pct``)."""
    return metric.rsplit(".", 1)[0]


def plan(spec: Spec, cell_name: str) -> SimpleNamespace:
    """The cell's configuration and traffic merged: the sampler's settings
    and the stated precisions, the traffic's overriding the
    configuration's; with the reference module (``ref``)."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    sampler = {**config["sampler"], **traffic.get("sampler", {})}
    stated = {**config["stated_precision"],
              **traffic.get("stated_precision", {})}
    return SimpleNamespace(name=cell_name, cell=cell, config=config,
                           traffic=traffic, sampler=sampler, stated=stated,
                           limits=spec.limits(cell_name),
                           ref=spec.reference(config),
                           groups=spec.data("kernels.json")["groups"],
                           ranks=None)


def work(p: SimpleNamespace, k_live: int) -> dict:
    """The shapes and stated precision the roofline counts take: one
    card's points (the configuration's over its ``devices``, 1 where it
    states none), width, features, live clusters, the rows kernel A reads
    (an f32 or bf16 cache, the hybrid pair, or the raw points) and the ll
    product's passes at its peak (the three-pass bf16 split counts as
    three bf16 passes, one bf16 pass as one, exact float32 at float32's
    peak)."""
    d, s = p.config["data"], p.sampler
    cached = bool(s.get("precompute_features"))
    dtype = s.get("feature_dtype", "float32")
    rows = ({"float32": "f32_cache", "bfloat16": "bf16_cache",
             "hybrid": "hybrid"}[dtype] if cached else "raw")
    exact = s.get("ll_precision", "default") == "highest"
    return dict(n=d["n"] // p.config.get("devices", 1), d=d["d"],
                f=p.ref.feature_dim(d["d"]),
                k_live=int(k_live), rows=rows,
                passes=1 if exact or p.stated["ll"] == "bfloat16" else 3,
                peak="fp32" if exact else "bf16")


def sync(torch) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Phases:
    """Set-up phases on the run's clock, each ended by a device fence,
    logged as seconds since the process started."""

    def __init__(self, torch, clock, t_proc):
        self.torch, self.clock, self.t_proc = torch, clock, t_proc
        self.marks = [("python and torch", clock())]

    def mark(self, name: str) -> None:
        sync(self.torch)
        self.marks.append((name, self.clock()))

    def report(self) -> str:
        t = [self.t_proc] + [v for _, v in self.marks]
        return ", ".join(f"{name} {b - a:.3f}" for (name, _), a, b in
                         zip(self.marks, t, t[1:]))


def spread(values) -> str:
    v = sorted(values)
    return (f"min {v[0]:.4f} median {v[len(v) // 2]:.4f} max {v[-1]:.4f}"
            if v else "none")


def control_precisions(p) -> dict:
    """The control's precision of each stated one: the step below."""
    return {key: p.ref.LOWER[v] for key, v in p.stated.items()}


def judge(p, x, call, stats_calls, final, prior, control: bool,
          reduce=None):
    """The numbers of kernel A's last call, the statistics and the final
    table's posterior (``check.py``), and with ``control`` the control's
    (else None); ``reduce`` sums the reference's sums over the ranks."""
    from . import check

    ctl = control_precisions(p) if control else None
    if call is None:
        # kernel A never ran: nothing the timed path made can be judged
        nothing = dict.fromkeys(JUDGED, math.inf)
        return nothing, (dict(nothing) if control else None)
    a = check.AssignCall(p.ref, **call)
    sweep = check.judge_sweep(p.ref, x, a, stats_calls,
                              check.TIE_EPS[p.stated["ll"]], control=ctl,
                              reduce=reduce)
    post = check.judge_posterior(p.ref, final["active"], final["stats"],
                                 final["post"], prior,
                                 ctl["posterior"] if ctl else None)
    numbers = {key: sweep[key] for key in JUDGED if key in sweep}
    numbers["post_err"] = post["post_err"]
    control_numbers = ({**sweep["control"], **post["control"]}
                       if control else None)
    return numbers, control_numbers


JUDGED = ("assign_gap", "label_gap", "sub_gap", "sub_flip_rate",
          "label_flips", "stats_err", "post_err")


def limits_of(p) -> dict:
    """Each compared number's limit: the cell's limits file (set from
    readings, the recovery its traffic promises, or 0 for an exact count)
    and the exact check that the window moved the state."""
    out = {key: v["limit"] for key, v in p.limits.items()
           if key != "reported_only"}
    out["stale_state"] = 0.0
    return out


def within(p, numbers: dict) -> bool:
    """Every number the cell compares within its limit; a number the
    limits file neither limits nor names as reported only fails."""
    lim = limits_of(p)
    shown = p.limits.get("reported_only", {})
    return all((key in shown and key not in lim)
               or (key in lim and not math.isnan(v) and v <= lim[key])
               for key, v in numbers.items())


def run(spec: Spec, cell_name: str, seed: int, seconds: float,
        trace_on: bool, device, t_proc: float, clock=time.perf_counter,
        control: bool = False, ranks=None) -> dict:
    """One run of a cell; returns the result line's object.  With
    ``control`` the control's numbers stand in the port's place (the
    recovery and the state's check stay the port's), so that a sound
    benchmark reads the control not correct.  On more than one card
    ``ranks`` is this rank's (``ranks.Ranks``): rank 0 returns the result,
    every other rank None."""
    import torch

    from .trace import group_seconds

    p = plan(spec, cell_name)
    p.ranks = ranks
    out = spec.runner(p.traffic["kind"])(p, seed, seconds, trace_on, device,
                                         clock, t_proc, control)
    if ranks is not None and ranks.rank > 0:
        return None
    limits = limits_of(p)
    numbers = out["numbers"]
    if control:
        log("judging the control (the reference one precision below the "
            f"stated one, {control_precisions(p)}) in the port's place")
        numbers = {**numbers, **out["control"]}
    correct = within(p, numbers)
    groups = spec.data("kernels.json")["groups"]
    if trace_on:
        ctx = out["ctx"]
        ctx.peaks = spec.data("peaks.json")
        if ctx.trace is not None:
            ctx.trace["group_s"] = group_seconds(ctx.trace, groups)
        metrics = {}
        for m in spec.per_layer(cell_name):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec.end_to_end(cell_name)}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": max(out["bad"], int(not correct)),
              "metrics": metrics}
    count = ranks.world if ranks is not None else 1
    if torch.device(device).type == "cuda":
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(),
                            "count": count,
                            "memory_peak_bytes": int(out["peak"]),
                            "card": card()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": count,
                            "memory_peak_bytes": 0}
    if "peak_by_rank" in out:
        result["device"]["memory_peak_bytes_by_rank"] = out["peak_by_rank"]
    if trace_on and out["ctx"].trace is not None:
        tr = out["ctx"].trace
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
        log(f"counters over the traced span: {json.dumps(tr['counters'])}")
        log(f"device seconds by kernel group: {json.dumps(tr['group_s'])}")
    shown = p.limits.get("reported_only", {})
    result["reported"] = {key: v for key, v in numbers.items()
                          if key in shown and key not in limits}
    result["checked"] = {key: {"value": v, "limit": limits.get(key)}
                         for key, v in numbers.items()
                         if key not in result["reported"]}
    return result
