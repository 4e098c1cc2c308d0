"""The smart pass's per-slot sums on the card: ``smart._slot_sums`` over
float32 rows takes the exact fixed-point route on kernel B
(``sweep_kernels.slot_sums``) and comes within float32 summation error of
float64 ``index_add_`` at 1M and 10M rows, absent slots and invalid rows
included; its launches count in ``slot_sums.launches`` and the
``smart_sums`` counter, never in ``stats_from_labels.launches`` (the
sweep's); two ranks split inside a chunk get one rank's bits.  The host's
contract: tests/test_torch_slot_sums.py.

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import torch_threads  # noqa: F401

import pytest
import torch

from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.sampler import smart
from dpmmsubclusters_tpu_torch.sampler.smart import _slot_sums
from dpmmsubclusters_tpu_torch.utils import profiling

from test_torch_slot_sums import _two_ranks

# against float64 sums, relative to each slot's sum of magnitudes: about
# 170 float32 roundings, the error of float32 sums (the fixed-point sums
# round once)
SUM_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("n", [1 << 20, 10_000_000], ids=["1M", "10M"])
def test_smart_slot_sums_on_kernel_b_match_float64(cuda, n, c, k):
    gen = torch.Generator(device=cuda).manual_seed(n + 10 * c + k)
    labels = torch.randint(0, k - 16, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    labels[labels == 3] = 4                 # slot 3 and the top 16: absent
    vals = torch.randn((n, c), generator=gen, device=cuda)
    vals[:, 0] = vals[:, 0].abs()           # a count-like column
    keep = (torch.rand(n, generator=gen, device=cuda) > 0.25) & (labels != 9)

    sk.reset_launches()
    profiling.reset()
    profiling.enable()
    try:
        got = _slot_sums(labels, vals, k, keep)
        again = _slot_sums(labels, vals, k, keep)
    finally:
        profiling.enable(False)
    assert sk.slot_sums.launches == 2
    assert profiling.counters().get("smart_sums") == 2
    assert sum(sk.stats_from_labels.launches.values()) == 0
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))

    lab, v64 = labels[keep].long(), vals[keep].double()
    want = torch.zeros((k, c), dtype=torch.float64,
                       device=cuda).index_add_(0, lab, v64)
    mag = torch.zeros((k, c), dtype=torch.float64,
                      device=cuda).index_add_(0, lab, v64.abs())
    assert got.shape == (k, c) and got.dtype == torch.float32
    err = (got.double() - want).abs()
    assert bool((err <= SUM_RTOL * mag).all()), float((err / mag.clamp(
        min=1e-300)).max())
    absent = [3, 9] + list(range(k - 16, k))
    assert torch.equal(got[absent], torch.zeros((len(absent), c),
                                                device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 4])
def test_smart_slot_sums_do_not_depend_on_the_split(cuda, c):
    """One process and two ranks cut where the 4-corner gate of
    chip_smoke.py cuts 2^20 rows (700 hash tiles, inside a chunk of kernel
    B) read the same bits."""
    n, k = 1 << 20, 64
    gen = torch.Generator(device=cuda).manual_seed(c)
    labels = torch.randint(0, k, (n,), generator=gen, device=cuda,
                           dtype=torch.int32)
    vals = torch.randn((n, c), generator=gen, device=cuda)
    keep = torch.rand(n, generator=gen, device=cuda) > 0.1
    one = _slot_sums(labels, vals, k, keep)
    ranks = _two_ranks(lambda lab, v, kp, lay: _slot_sums(lab, v, k, kp, lay),
                       358_400, labels, vals, keep)
    for got in ranks:
        assert torch.equal(got.view(torch.int32), one.view(torch.int32))
    assert torch.equal(one, smart._exact_slot_sums(
        labels, vals, k, keep, smart._same, smart._same))
