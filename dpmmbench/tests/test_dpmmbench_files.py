"""The harness finds configurations, traffic mixes and per-layer metrics by
name: a new one is files and entries alone."""
from __future__ import annotations

import json
import re

import torch

from tinybench import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_name_resolves_to_its_files():
    from dpmmbench import harness

    spec = harness.Spec(REPO / "BENCHMARK.json")
    b = bench()
    for c in b["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
        assert c["file"].startswith("dpmmbench/")
    for w in b["workloads"]:
        p = harness.plan(spec, w["name"])
        assert callable(spec.runner(p.traffic["kind"]))
        # each reference's own row width ([1, x, ...]) at D=2
        assert p.ref.feature_dim(2) == p.ref.features(
            torch.zeros((1, 2))).shape[1] >= 3
        assert set(p.stated) == {"ll", "stats", "posterior"}
        assert (REPO / "dpmmbench" / "limits" / f"{w['name']}.json").exists()
    for m in b["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_names_units_and_links_keep_the_contract():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    assert "setup_s" in e2e and len(cells) == len(set(cells))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        # every cell that reports a per-layer metric reports what it moves
        mover = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in mover.get("workloads", cells)
    for cell in cells:
        from dpmmbench import harness

        spec = harness.Spec(REPO / "BENCHMARK.json")
        names = {m["name"] for m in spec.end_to_end(cell)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(cell)


def test_a_new_config_traffic_and_metric_are_files_alone(tmp_path):
    """A throwaway configuration (with its own reference module), traffic
    mix (of a kind of its own) and per-layer metric, added as files and
    entries, are picked up by the harness unchanged."""
    from tinybench import make_tiny

    from dpmmbench import harness

    bench_path = make_tiny(tmp_path)
    root = tmp_path / "dpmmbench"
    cfg = json.loads((root / "configs" / "gauss-1Mx32d-k64.json").read_text())
    cfg["name"] = "gauss-throwaway"
    cfg["reference"] = "dpmmbench/reference/throwaway.py"
    (root / "configs" / "gauss-throwaway.json").write_text(json.dumps(cfg))
    (root / "reference" / "throwaway.py").write_text(
        (root / "reference" / "gauss.py").read_text()
        + "\nTHROWAWAY = True\n")
    traffic = json.loads((root / "traffic" / "nocache-steady.json").read_text())
    del traffic["sampler"]     # the configuration's f32 cache
    traffic["block"] = 4
    traffic["kind"] = "steady_marked"
    (root / "traffic" / "steady-b4.json").write_text(json.dumps(traffic))
    (root / "traffic_kinds" / "steady_marked.py").write_text(
        "from dpmmbench.traffic_kinds import steady\n\n\n"
        "def run(p, *a, **kw):\n"
        "    assert p.ref.THROWAWAY\n"
        "    out = steady.run(p, *a, **kw)\n"
        "    out['ctx'].marked = 1\n"
        "    return out\n")
    (root / "metrics" / "sweeps_traced.py").write_text(
        "def read(ctx):\n    return ctx.sweeps * ctx.marked\n")
    b = json.loads(bench_path.read_text())
    b["configs"].append({"name": "gauss-throwaway", "source": "a test",
                         "file": "dpmmbench/configs/gauss-throwaway.json",
                         "reduced": [], "why": "a test"})
    cell = "gauss-throwaway.steady-b4"
    b["workloads"].append({"name": cell, "config": "gauss-throwaway",
                           "traffic": "steady-b4", "chips": 1, "why": "t"})
    for m in b["end_to_end"]:
        if m["name"] == "sweep_ms":
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "sweeps_traced", "unit": "sweeps",
                           "better": "higher", "source": "program_counter",
                           "layer": "host loop", "moves": "sweep_ms",
                           "workloads": [cell]})
    bench_path.write_text(json.dumps(b))
    spec = harness.Spec(bench_path, root)
    import time

    out = harness.run(spec, cell, 5, 0.2, True, "cpu", time.perf_counter())
    assert out["metrics"]["sweeps_traced"]["value"] == \
        traffic["trace"]["blocks"] * 4
    assert out["attempted"] % 4 == 0
    plain = harness.run(spec, cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert set(plain["metrics"]) == {"sweep_ms", "setup_s"}
