"""The comparison fails what it must: the control (the reference one
precision below the stated one, in the port's place) and the timed path
broken underneath a run, at a tiny size on the CPU."""
from __future__ import annotations

import math

import pytest
import torch

from tinybench import REPO  # noqa: F401  (puts the repository on the path)

from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.sampler import assign
from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine
from dpmmsubclusters_tpu_torch.sampler.table import active_count

CELLS = ["gauss-10Mx64d-k100.hybrid-steady", "gauss-1Mx32d-k64.fit",
         "gauss-10Mx64d-k100.nocache-steady"]


def over_limit(out) -> list:
    return [k for k, v in out["checked"].items()
            if math.isnan(v["value"]) or v["value"] > v["limit"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(run_cell, cell):
    """``--control 1`` judges the control in the port's place."""
    out = run_cell(cell, control=True)
    assert not out["correct"] and out["failed"] >= 1
    assert over_limit(out), out["checked"]


def stuck_step_block(self, state, points, valid, n_total, finals, nms):
    """A step that returns its state unchanged."""
    k = active_count(state.table)
    return state, {"k": k.repeat(len(finals)),
                   "log_posterior": torch.zeros(len(finals))}


def half_batch(orig):
    """Kernel A on the first half of the points only, its statistics the
    mean over that half (scaled to the whole), the rest's labels copied."""
    def fused_assign_reference(x, valid, *a, x_raw=None, **kw):
        n, h = x.shape[0], x.shape[0] // 2
        lab, sub, stats = orig(x[:h], valid[:h], *a,
                               x_raw=None if x_raw is None else x_raw[:h],
                               **kw)
        rest = n - h
        return (torch.cat([lab, lab[:rest]]), torch.cat([sub, sub[:rest]]),
                stats * (n / h))
    return fused_assign_reference


def altered_answer(orig):
    """Kernel A with one point's label moved to the next slot."""
    def fused_assign_reference(x, valid, phi_mat, log_w, *a, **kw):
        lab, sub, stats = orig(x, valid, phi_mat, log_w, *a, **kw)
        lab = lab.clone()
        lab[0] = (lab[0] + 1) % log_w.shape[0]
        return lab, sub, stats
    return fused_assign_reference


def consistent_label(orig):
    """Kernel A with one point's label moved to the next live slot (a
    point further on at each call, so that no point is left on its own),
    and that point's feature row moved with it in the statistics, so that
    they agree."""
    calls = [0]

    def assign_and_stats(points, valid, phi, log_w, log_lrw, seed, hard,
                         tile_off=0, tile=assign.HASH_TILE, **kw):
        lab, sub, stats = orig(points, valid, phi, log_w, log_lrw, seed,
                               hard, tile_off, tile, **kw)
        i = calls[0] * 613 % lab.shape[0]
        calls[0] += 1
        if isinstance(points, dict):
            row = kw["family"].features(points["raw"][i:i + 1])[0]
        elif kw["x_is_features"]:
            row = points[i].float()
        else:
            row = kw["family"].features(points[i:i + 1])[0]
        live = torch.nonzero(torch.isfinite(log_w))[:, 0]
        old, side = int(lab[i]), int(sub[i])
        new = int(live[(int(torch.nonzero(live == old)[0, 0]) + 1)
                       % live.numel()])
        lab, stats = lab.clone(), stats.clone()
        lab[i] = new
        stats[old, side] -= row
        stats[new, side] += row
        return lab, sub, stats
    return assign_and_stats


FAULTS = {
    "state unchanged": lambda mp: mp.setattr(DPMMEngine, "step_block",
                                             stuck_step_block),
    "half the batch": lambda mp: mp.setattr(
        sk, "fused_assign_reference", half_batch(sk.fused_assign_reference)),
    "answer altered": lambda mp: mp.setattr(
        sk, "fused_assign_reference",
        altered_answer(sk.fused_assign_reference)),
    "answer altered, statistics agreeing": lambda mp: mp.setattr(
        assign, "assign_and_stats", consistent_label(assign.assign_and_stats)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(run_cell, monkeypatch, cell,
                                            fault):
    FAULTS[fault](monkeypatch)
    out = run_cell(cell)
    assert not out["correct"]
    bad = over_limit(out)
    assert bad
    if fault == "answer altered, statistics agreeing":
        assert "label_flips" in bad
