"""A small run of each kind of cell on the card: the port's CUDA kernels
under the harness, judged correct, with a traced span in which the card
was busy (and, in the steady cells, kernel A's group had device time).
The steady cells run 64 clusters, as the cells' shares of points (such
as ``sub_flip_rate``) are averaged over many clusters, not four.  Skips
without a card."""
from __future__ import annotations

import time

import pytest

from tinybench import make_tiny

STEADY = {"gauss-10Mx64d-k100": {
    "data": dict(n=1 << 17, d=8, k_true=64),
    "sampler": dict(k_max=128, merge_candidates=128)}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gauss-10Mx64d-k100.nocache-steady",
                                  "gauss-10Mx64d-k100.hybrid-steady",
                                  "gauss-1Mx32d-k64.fit"])
def test_a_tiny_cell_runs_on_the_card(tmp_path, card, cell):
    from dpmmbench import harness

    spec = harness.Spec(make_tiny(tmp_path, sizes=STEADY),
                        tmp_path / "dpmmbench")
    out = harness.run(spec, cell, 2**31 + 11, 0.5, True, card,
                      time.perf_counter())
    assert out["correct"], {k: v for k, v in out["checked"].items()
                            if not v["value"] <= v["limit"]}
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    if "steady" in cell:
        assert any(m.startswith("assign_ms") for m in out["metrics"])
