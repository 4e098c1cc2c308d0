"""``fit_distributed`` on the card: a world of one under NCCL is ``fit``
bit for bit, the smart pass's sums (the one reduction of a fit outside the
kernels) are the same bits every run, and two gloo ranks sharing the one
card give one process's ``fit`` trajectory on integer 4 corners (the CPU
twins: tests/test_torch_parallel.py).

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import numpy as np
import pytest
import torch

import dpmmsubclusters_tpu_torch as tdpmm
from dpmmsubclusters_tpu_torch.parallel import distributed as dist
from torch_dist_worker import spawn

CORNERS = dict(alpha=100.0, iters=60, seed=5, burnout=5, verbose=False)
MIXTURE = dict(alpha=10.0, iters=40, seed=3, burnout=5, verbose=False,
               smart_splits=True, exact_post_move_stats=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these)")
    return torch.device("cuda")


def four_corners(n):
    x = np.zeros((n, 2), np.float32)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * (n // 4):(i + 1) * (n // 4)] = c
    return x


def mixture():
    return tdpmm.generate_gaussian_data(3000, 3, 5, 50.0, seed=1)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("data, kw", [(lambda: four_corners(1000), CORNERS),
                                      (mixture, MIXTURE)],
                         ids=["corners", "mixture_smart_exact"])
def test_world_of_one_under_nccl_is_fit(cuda, tmp_path, data, kw):
    """One NCCL rank: labels, sub-labels, table and ``history.k`` equal
    ``fit``'s on the card."""
    x = data()
    want = tdpmm.fit(x, device=cuda, **kw)
    dist.initialize(f"file://{tmp_path}/rendezvous", 1, 0, "nccl")
    try:
        got = tdpmm.fit_distributed(x, device="cuda", **kw)
    finally:
        dist.shutdown()
    np.testing.assert_array_equal(got.model.labels_raw,
                                  want.model.labels_raw)
    np.testing.assert_array_equal(got.model.sublabels, want.model.sublabels)
    assert (dist.table_digest(got.model.table)
            == dist.table_digest(want.model.table))
    assert got.history.k == want.history.k


@pytest.mark.gpu
def test_smart_slot_sums_are_the_same_bits_every_run(cuda):
    """The smart pass's per-slot sums (1M rows into 64 slots, where float
    atomics would add in a new order each run) are the same bits in every
    call, so one seed gives one chain on the card."""
    from dpmmsubclusters_tpu_torch.sampler.smart import _slot_sums

    gen = torch.Generator(device=cuda).manual_seed(0)
    labels = torch.randint(0, 64, (1 << 20,), generator=gen, device=cuda)
    vals = torch.randn((1 << 20, 3), generator=gen, device=cuda)
    want = _slot_sums(labels, vals, 64)
    for _ in range(5):
        assert torch.equal(_slot_sums(labels, vals, 64), want)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_fit(cuda, tmp_path):
    """Two gloo ranks on the one card (1024 / 1024 rows of integer 4
    corners) give ``fit``'s labels, ``history.k`` and table."""
    x = four_corners(2048)
    one = tdpmm.fit(x, device=cuda, **CORNERS)
    outs = spawn(tmp_path, x, (1024, 1024), device="cuda", **CORNERS)
    labels = np.concatenate([o["labels_raw"] for o in outs])
    np.testing.assert_array_equal(labels, one.model.labels_raw)
    for o in outs:
        assert list(o["hist_k"]) == one.history.k
        assert str(o["digest"]) == dist.table_digest(one.model.table)
