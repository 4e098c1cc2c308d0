"""A cell on several ranks, on the CPU: the command's rank 0 starts the
other ranks as child processes, which meet in a gloo process group (the
backend of ranks on the CPU; on cards NCCL), and prints one result for
them all.  Each run is a subprocess, so no checked process
imports JAX."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from tinybench import REPO, make_tiny

CELL = "gauss-40Mx64d-k100.dist4-steady"
ROWS = 4096                 # a rank's rows
MAIN = ("import sys; from dpmmbench.__main__ import main; "
        "sys.exit(main(sys.argv[1:], device='cpu'))")


def dist_copy(root, world: int, kind: str = None, margin_s: int = 120):
    """The tiny copy with the cell on ``world`` ranks of ``ROWS`` rows of
    4-d points, under gloo, its deadline margin ``margin_s``; ``kind``
    replaces its traffic kind."""
    bench = make_tiny(root)
    pkg = root / "dpmmbench"
    cfg_path = pkg / "configs" / "gauss-40Mx64d-k100.json"
    cfg = json.loads(cfg_path.read_text())
    # 16 clusters: a share of points such as sub_flip_rate is averaged
    # over many clusters in the cell, not over the tiny copy's four
    cfg["data"].update(n=ROWS * world, k_true=16)
    cfg["sampler"].update(k_max=64, merge_candidates=64)
    cfg["devices"] = world
    cfg_path.write_text(json.dumps(cfg))
    tr_path = pkg / "traffic" / "dist4-steady.json"
    tr = json.loads(tr_path.read_text())
    tr.update(margin_s=margin_s)
    if kind:
        tr["kind"] = kind
    tr_path.write_text(json.dumps(tr))
    b = json.loads(bench.read_text())
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["chips"] = world
    bench.write_text(json.dumps(b))
    return root


def command(root, *extra, seed=2**31 + 41, timeout=240, path=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO)] + ([path] if path
                                                          else [])))
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", MAIN, "--workload", CELL, "--seed", str(seed),
         "--seconds", "0.5", *extra], cwd=root, env=env,
        capture_output=True, text=True, timeout=timeout)
    return proc, time.monotonic() - t


def result(proc) -> dict:
    lines = proc.stdout.splitlines()
    assert proc.returncode == 0 and len(lines) == 1, (proc.returncode,
                                                      proc.stderr[-4000:])
    return json.loads(lines[0])


@pytest.mark.parametrize("world", [2, 4])
def test_the_ranks_print_one_correct_line(tmp_path, world):
    proc, _ = command(dist_copy(tmp_path, world), "--trace", "1")
    out = result(proc)
    assert out["device"]["count"] == world
    assert len(out["device"]["memory_peak_bytes_by_rank"]) == world
    assert out["correct"], out["checked"]
    assert out["checked"]["table_mismatch"]["value"] == 0.0
    assert out["checked"]["k_err"]["value"] == 0.0
    # a world of one timed on rank 0; the CPU's traces hold no device op,
    # so the readers of the ranks' device time read nothing
    assert out["metrics"]["scaling_eff_pct"]["value"] > 0
    assert not {"rank_skew_pct", "allreduce_ms"} & set(out["metrics"])


def test_the_control_on_two_ranks_is_not_correct(tmp_path):
    proc, _ = command(dist_copy(tmp_path, 2), "--control", "1")
    out = result(proc)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("world", [2, 4])
def test_the_shards_joined_are_world_ones_rows(world):
    """Every split of the rows (whole blocks or not) draws the same
    points and labels as one rank holding them all."""
    from dpmmbench import data

    n, block = 10_007, 1_000
    whole = data.shard_of_separated_data(0, n, 3, 5, 8.0, 2**31 + 3, "cpu",
                                         block=block)
    for cuts in ([n * r // world for r in range(world + 1)],
                 [0, *sorted({1, 999, 1000, 4321, 9999} - {n})[:world - 1],
                  n]):
        parts = [data.shard_of_separated_data(a, b - a, 3, 5, 8.0,
                                              2**31 + 3, "cpu", block=block,
                                              pad_to=b - a + 7)
                 for a, b in zip(cuts, cuts[1:])]
        for got, want in zip(zip(*parts), whole):
            rows = [g[:b - a] for g, a, b in zip(got, cuts, cuts[1:])]
            assert torch.equal(torch.cat(rows), want)
        assert all(not g[b - a:].any() for (g, _), a, b in
                   zip(parts, cuts, cuts[1:]))


PLANTED = '''from dpmmbench import system
from dpmmbench.traffic_kinds import dist_steady


def run(p, *a, **kw):
    if p.ranks.rank == 1:
        if WHEN == "before it joins":
            raise RuntimeError("a planted fault")
        orig = system.run_block

        def run_block(*b, **bk):
            if WHEN == "in a collective":
                raise RuntimeError("a planted fault")
            import time
            time.sleep(3600)

        system.run_block = run_block
    return dist_steady.run(p, *a, **kw)
'''


@pytest.mark.parametrize("when", ["before it joins", "in a collective",
                                  "hung in a collective"])
def test_a_failing_rank_ends_the_command_without_a_result(tmp_path, when):
    """A rank that raises, before it joins the group or while the others
    wait for it in a collective, or that hangs, makes the command exit
    non-zero with no result line, within its deadline."""
    margin = 30
    root = dist_copy(tmp_path, 2, kind="planted", margin_s=margin)
    (root / "dpmmbench" / "traffic_kinds" / "planted.py").write_text(
        f"WHEN = {when!r}\n" + PLANTED)
    proc, took = command(root, timeout=margin + 120)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr[-4000:]
    assert took < margin + 60
    if when == "hung in a collective":
        assert "deadline" in proc.stderr
    else:
        assert "a planted fault" in proc.stderr


def test_a_one_card_cell_starts_no_process_and_no_group(tmp_path,
                                                        monkeypatch, capsys):
    import torch.distributed

    from dpmmbench import __main__ as entry

    def refuse(*a, **kw):
        raise AssertionError("a one-card cell started a process or a group")

    make_tiny(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    rc = entry.main(["--workload", "gauss-10Mx64d-k100.hybrid-steady",
                     "--seed", str(2**31 + 43), "--seconds", "0.3"],
                    device="cpu")
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and out["device"]["count"] == 1
    assert "memory_peak_bytes_by_rank" not in out["device"]


def test_the_collectives_are_kept_apart_in_a_trace():
    """``trace.reduce`` with the "allreduce" group apart: its kernels count
    in the busy time but not in ``compute_busy_s``, which
    ``device_idle_pct`` reads; a trace without them reads as before."""
    import importlib.util

    from dpmmbench import trace

    def x(name, ts, dur, cat="kernel"):
        return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur,
                "tid": 1}

    events = [x(trace.SPAN, 0.0, 100.0, "user_annotation"),
              x("assign_tma_kernel", 0.0, 30.0),
              x("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 25.0, 50.0),
              x("stats_partial_tri_kernel", 80.0, 10.0)]
    plain = trace.reduce(events)
    apart = trace.reduce(events, ["nccl"])
    assert "compute_busy_s" not in plain
    assert plain["busy_s"] == apart["busy_s"] == pytest.approx(85e-6)
    assert apart["compute_busy_s"] == pytest.approx(40e-6)
    path = REPO / "dpmmbench" / "metrics" / "device_idle_pct.py"
    spec = importlib.util.spec_from_file_location("idle", path)
    idle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(idle)
    ctx = SimpleNamespace(trace=apart, untraced_s=100e-6)
    assert idle.read(ctx) == pytest.approx(60.0)
    ctx.trace = plain
    assert idle.read(ctx) == pytest.approx(15.0)


def test_the_collectives_readers():
    from dpmmbench import harness

    spec = harness.Spec(REPO / "BENCHMARK.json")
    ctx = SimpleNamespace(trace=None, sweeps=32, sweep_s=0.032,
                          rank_ms=[29.0, 28.5, 28.3, 28.5],
                          one_rank_sweep_s=0.030, allreduce_ms=1.25)
    assert spec.reader("rank_skew_pct")(ctx) == pytest.approx(
        100 * 0.7 / 29.0)
    assert spec.reader("scaling_eff_pct")(ctx) == pytest.approx(93.75)
    assert spec.reader("allreduce_ms")(ctx) == 1.25
    one = SimpleNamespace(trace=None, sweeps=32, sweep_s=0.032)
    assert all(spec.reader(m)(one) is None for m in
               ("rank_skew_pct", "scaling_eff_pct", "allreduce_ms"))


FAULTY = '''from dpmmbench.traffic_kinds import dist_steady


class Patch:
    setattr = staticmethod(setattr)


def run(p, *a, **kw):
    from dpmmsubclusters_tpu_torch.parallel import distributed
    from test_dpmmbench_control import FAULTS

    if FAULT == "the exchange left out":
        distributed.all_reduce_sum = lambda t: t
    else:
        FAULTS[FAULT](Patch)
    return dist_steady.run(p, *a, **kw)
'''


@pytest.mark.parametrize("fault", ["the exchange left out", "state unchanged",
                                   "half the batch", "answer altered",
                                   "answer altered, statistics agreeing"])
def test_a_broken_timed_path_on_two_ranks_is_not_correct(tmp_path, fault):
    """Every rank's timed path broken underneath the run (the faults of
    ``test_dpmmbench_control.py``, and the port's sum over the ranks made
    the identity): the command prints ``correct`` false, or, where the
    ranks fall out of step, ends without a result."""
    root = dist_copy(tmp_path, 2, kind="faulty", margin_s=60)
    (root / "dpmmbench" / "traffic_kinds" / "faulty.py").write_text(
        f"FAULT = {fault!r}\n" + FAULTY)
    proc, _ = command(root, timeout=240,
                      path=str(REPO / "dpmmbench" / "tests"))
    if proc.returncode == 0:
        out = result(proc)
        assert not out["correct"], out["checked"]
        if fault == "the exchange left out":
            bad = [k for k, v in out["checked"].items()
                   if not v["value"] <= v["limit"]]
            assert {"stats_err", "table_mismatch"} <= set(bad), bad
    else:
        assert proc.stdout == "", proc.stderr[-4000:]
