"""The smart pass's per-slot sums on the host.  ``sweep_kernels.slot_sums``
is kernel B on one side's keys with its chunk partials added in int64: on
whole-number rows, exact sums (the left half of kernel B's
``"precomputed"`` statistics with every sub-label 0, whose plain version is
``index_add_`` over the valid rows).  ``smart._slot_sums`` on the CPU is
still plain ``index_add_`` over every row; the card's route,
``smart._exact_slot_sums``, run here on the host's ``slot_sums``, gives the
same bits in any order of the rows and at any split of them over ranks.
The card's route on the card: tests/test_torch_card_slot_sums.py."""
import threading

import pytest
import torch

from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.sampler import smart


def _bits(t):
    return t.contiguous().view(torch.int32)


def _rows(c, k):
    """Rows crossing kernel B's chunks and the plain version's row steps;
    slots 5 and the top eight hold no point, about a fifth of the rows are
    invalid, and slot 6 holds only invalid rows."""
    gen = torch.Generator().manual_seed(1000 * c + k)
    n = 4 * sk.STATS_CHUNK + 777
    labels = torch.randint(0, k - 8, (n,), generator=gen, dtype=torch.int32)
    labels[labels == 5] = 7
    vals = torch.randn((n, c), generator=gen)
    valid = (torch.rand(n, generator=gen) > 0.2) & (labels != 6)
    return labels, vals, valid


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("c", [3, 4])
def test_slot_sums_are_index_add_on_the_host(c, k):
    labels, vals, valid = _rows(c, k)
    want = torch.zeros((k, c)).index_add_(0, labels[valid], vals[valid])
    st = sk.stats_from_labels(vals, labels, torch.zeros_like(labels), valid,
                              k, "precomputed")
    assert torch.equal(_bits(st[:k]), _bits(want))
    assert torch.equal(_bits(st[k:]), _bits(torch.zeros((k, c))))
    for absent in [5, 6] + list(range(k - 8, k)):
        assert torch.equal(_bits(want[absent]), _bits(torch.zeros(c)))

    # whole numbers below 2**LIMB_BITS: exact int64 sums, which kernel B's
    # plain version gives too while every sum stays below 2**24
    top = (1 << sk.LIMB_BITS) - 1
    whole = torch.randint(-top, top + 1, vals.shape,
                          generator=torch.Generator().manual_seed(c + k))
    exact = torch.zeros((k, c), dtype=torch.int64).index_add_(
        0, labels[valid].long(), whole[valid])
    got = sk.slot_sums(whole.float(), labels, valid, k)
    assert got.dtype == torch.int64 and torch.equal(got, exact)
    assert torch.equal(sk.stats_from_labels(
        whole.float(), labels, torch.zeros_like(labels), valid, k,
        "precomputed")[:k], exact.float())

    every = torch.zeros((k, c)).index_add_(0, labels.long(), vals)
    assert torch.equal(_bits(smart._slot_sums(labels, vals, k)),
                       _bits(every))
    assert torch.equal(_bits(smart._slot_sums(labels.long(), vals, k,
                                              valid)), _bits(every))
    masked = vals * valid[:, None].to(vals.dtype)
    assert torch.equal(_bits(smart._slot_sums(labels, masked, k, valid)),
                       _bits(want))


class _Rank:
    """One of two ranks run as threads of one process: ``reduce`` and
    ``reduce_max`` add (take the larger of) both ranks' tensors in rank
    order, as an all_reduce gives every rank the same result."""

    def __init__(self, rank, box, barrier):
        self.rank, self.box, self.barrier = rank, box, barrier

    def _all(self, t, op):
        self.box[self.rank] = t.clone()
        self.barrier.wait()
        out = op(self.box[0], self.box[1])
        self.barrier.wait()
        return out

    def reduce(self, t):
        return self._all(t, torch.add)

    def reduce_max(self, t):
        return self._all(t, torch.maximum)


def _two_ranks(fn, cut, *tensors):
    """``fn(*rows, layout)`` on the rows before and from ``cut``, as two
    ranks; each rank's result."""
    box, barrier, out = [None, None], threading.Barrier(2), [None, None]

    def run(r):
        part = [t[:cut] if r == 0 else t[cut:] for t in tensors]
        out[r] = fn(*part, _Rank(r, box, barrier))

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("c", [3, 4])
def test_exact_slot_sums_do_not_depend_on_order_or_split(c, k):
    labels, vals, valid = _rows(c, k)
    vals[labels == 3] *= 1e-6                 # slots far apart in scale
    vals[labels == 4] *= 1e6
    vals[::7, 0] = 0.0
    one = smart._exact_slot_sums(labels, vals, k, valid, smart._same,
                                 smart._same)

    perm = torch.randperm(len(labels), generator=torch.Generator()
                          .manual_seed(c * k))
    assert torch.equal(_bits(smart._exact_slot_sums(
        labels[perm], vals[perm], k, valid[perm], smart._same, smart._same)),
        _bits(one))
    # a cut inside a chunk of kernel B, as an uneven split of ranks makes
    for cut in (358, sk.STATS_CHUNK + 4321):
        ranks = _two_ranks(
            lambda lab, v, keep, lay: smart._exact_slot_sums(
                lab, v, k, keep, lay.reduce, lay.reduce_max),
            cut, labels, vals, valid)
        for got in ranks:
            assert torch.equal(_bits(got), _bits(one))

    # each value rounds to 2**-41 of its slot and column's largest
    # magnitude's power of two, then the sum once to float32
    lab, v64 = labels[valid].long(), vals[valid].double()
    want = torch.zeros((k, c), dtype=torch.float64).index_add_(0, lab, v64)
    count = torch.zeros(k, dtype=torch.float64).index_add_(
        0, lab, torch.ones_like(lab, dtype=torch.float64))
    top = torch.zeros((k, c), dtype=torch.float64).scatter_reduce_(
        0, lab[:, None].expand(-1, c), v64.abs(), "amax")
    err = (one.double() - want).abs()
    assert bool((err <= 2.0 ** -24 * want.abs()
                 + count[:, None] * top * 2.0 ** -40).all())
    for absent in [5, 6] + list(range(k - 8, k)):
        assert torch.equal(_bits(one[absent]), _bits(torch.zeros(c)))


def test_exact_slot_sums_take_float32_rows():
    labels, vals, valid = _rows(3, 64)
    with pytest.raises(TypeError, match="float32"):
        smart._exact_slot_sums(labels, vals.double(), 64, valid, smart._same,
                               smart._same)
