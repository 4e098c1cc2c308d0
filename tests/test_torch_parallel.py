"""The port's multi-process fit on the CPU: the row layout, a world of one
(``fit_distributed`` without a process group is ``fit`` bit for bit), and
two gloo ranks in subprocesses (``tests/torch_dist_worker.py``, a
``file://`` rendezvous under ``tmp_path``, 120 s a test) against one
process's ``fit``: mirrors of the JAX package's
``tests/test_fit_e2e.py::test_single_device_matches_multi`` (across ranks
in place of mesh sizes), ``::test_fit_distributed_single_process`` and
``tests/test_multiprocess.py::test_two_process_fit``.

Tolerances: labels, sub-labels, ``history.k`` and table digests exactly
(on integer data every float32 statistics sum is exact, so the chains are
bit-identical across rank counts); the moments to float32 rounding of the
float64 ones; sampled runs to the 4-corner gates (K=4, NMI >= 0.999)."""
import numpy as np
import pytest
import torch

import dpmmsubclusters_tpu_torch as tdpmm
from dpmmsubclusters_tpu_torch.parallel import distributed as dist
from dpmmsubclusters_tpu_torch.parallel.distributed import (RowLayout,
                                                            layout_of)
from torch_dist_worker import spawn

CORNERS = dict(alpha=100.0, iters=60, seed=5, burnout=5, verbose=False)


def four_corners(n=2048):
    """n points at 4 exact corners (reference test/module_tests.jl:1-8)."""
    x = np.zeros((n, 2), np.float32)
    labels = np.zeros(n, np.int64)
    corners = np.array([[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0],
                        [-10.0, -10.0]])
    for i in range(4):
        x[i * (n // 4):(i + 1) * (n // 4)] = corners[i]
        labels[i * (n // 4):(i + 1) * (n // 4)] = i
    return x, labels


def mixture():
    x, gt, _, _ = tdpmm.generate_gaussian_data(3000, 3, 5, 50.0, seed=1)
    return x, gt


MIXTURE = dict(alpha=10.0, iters=40, seed=3, burnout=5, verbose=False,
               smart_splits=True, exact_post_move_stats=True)


@pytest.mark.parametrize("counts, starts, pads, total", [
    ((1000,), (0,), (1000,), 1000),
    ((1024, 1024), (0, 1024), (1024, 1024), 2048),
    ((700, 1300), (0, 1024), (1024, 1300), 2324),
    ((100, 600, 5), (0, 512, 1536), (512, 1024, 5), 1541),
])
def test_layout_pads_every_shard_but_the_last_to_hash_tiles(counts, starts,
                                                            pads, total):
    """Each rank starts a hash tile: ``row_start`` is the padded rows of
    the ranks before it, ``tile_off = row_start / 512``; only the last
    shard keeps its own length."""
    for me, c in enumerate(counts):
        lay = layout_of(counts, me)
        assert (lay.row_start, lay.n_pad, lay.n_global_pad) == (
            starts[me], pads[me], total)
        assert lay.counts[me] == c and lay.n_global == sum(counts)
        assert lay.tile_off * 512 == lay.row_start
        assert lay.world == len(counts)
    with pytest.raises(ValueError, match="at least one row"):
        layout_of((512, 0), 0)


def test_per_point_draws_take_a_slice_of_the_global_draw():
    """Across ranks each rank's per-point draw is its slice of one draw at
    the global padded length, so the generator advances alike on every
    rank; in a world of one it is the local draw itself."""
    def draw(gen):
        return lambda m: torch.randint(0, 1 << 30, (m,), generator=gen)

    want = draw(torch.Generator().manual_seed(7))(2324)
    for me in (0, 1):
        lay = layout_of((700, 1300), me)
        gen = torch.Generator().manual_seed(7)
        got = lay.per_point(draw(gen), lay.counts[me])
        assert torch.equal(got, want[lay.row_start:lay.row_start
                                     + lay.n_pad])
        assert torch.equal(gen.get_state(),
                           _after(torch.Generator().manual_seed(7), 2324))
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(RowLayout().per_point(draw(gen), 300), want[:300])


def _after(gen, m):
    torch.randint(0, 1 << 30, (m,), generator=gen)
    return gen.get_state()


def test_moments_are_float64_sums():
    """The centering and standardization moments are float64 two-pass
    sums rounded to float32: equal to numpy's float64 moments, and exact
    on 2^20 corner points, where float32 sums gave an sd of 9.927739 for
    10."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5000, 4)) * [1.0, 3.0, 0.1, 7.0]
         + [1e3, -50.0, 0.0, 2.0]).astype(np.float32)
    mean, sd = RowLayout().moments(x)
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(mean, x64.mean(0).astype(np.float32))
    np.testing.assert_allclose(sd, x64.std(0), rtol=1e-6)
    mean, sd = RowLayout().moments(four_corners(1 << 20)[0])
    np.testing.assert_array_equal(mean, 0.0)
    np.testing.assert_array_equal(sd, 10.0)


@pytest.mark.parametrize("data, kw", [(four_corners, CORNERS),
                                      (mixture, MIXTURE)],
                         ids=["corners", "mixture_smart_exact"])
def test_world_of_one_is_fit(data, kw):
    """Without a process group ``fit_distributed`` is ``fit`` bit for bit:
    labels, sub-labels, table and ``history.k`` (the JAX package's
    ``test_fit_distributed_single_process``, held to ``fit``)."""
    x, gt = data()
    assert dist.world() == 1
    a = tdpmm.fit(x, device="cpu", **kw)
    b = tdpmm.fit_distributed(x, device="cpu", **kw)
    np.testing.assert_array_equal(b.model.labels_raw, a.model.labels_raw)
    np.testing.assert_array_equal(b.model.sublabels, a.model.sublabels)
    assert (dist.table_digest(b.model.table)
            == dist.table_digest(a.model.table))
    assert b.history.k == a.history.k
    assert b.model.n_points == len(x) and b.k == a.k
    assert tdpmm.nmi(gt, b.labels) > (0.999 if data is four_corners
                                      else 0.9)


def test_n_devices_other_than_one_is_refused(tmp_path):
    """One process drives one card: ``n_devices`` other than None or 1
    raises and names ``fit_distributed``; 1 is a plain fit."""
    x, _ = four_corners(400)
    kw = dict(CORNERS, iters=4)
    with pytest.raises(ValueError, match="fit_distributed"):
        tdpmm.fit(x, device="cpu", n_devices=2, **kw)
    res = tdpmm.fit(x, device="cpu", n_devices=1, **kw)
    path = str(tmp_path / "m.npz")
    res.model.save(path)
    with pytest.raises(ValueError, match="fit_distributed"):
        tdpmm.run_from_checkpoint(path, x, device="cpu", n_devices=8)


@pytest.mark.parametrize("counts", [(1024, 1024), (512, 1536)])
def test_two_ranks_match_one_process(tmp_path, counts):
    """Two gloo ranks whose first shard is whole hash tiles give one
    process's ``fit`` trajectory bit for bit on integer 4 corners: the
    same labels, ``history.k`` and table on both ranks."""
    x, _ = four_corners(2048)
    one = tdpmm.fit(x, device="cpu", **CORNERS)
    outs = spawn(tmp_path, x, counts, **CORNERS)
    labels = np.concatenate([o["labels_raw"] for o in outs])
    np.testing.assert_array_equal(labels, one.model.labels_raw)
    for o in outs:
        assert list(o["hist_k"]) == one.history.k
        assert str(o["digest"]) == dist.table_digest(one.model.table)
        assert int(o["n_points"]) == 2048


def test_two_ranks_unaligned_shards(tmp_path):
    """700 / 1300 rows (rank 1 starts after 324 pad rows): K=4, NMI >=
    0.999 on each rank's rows, equal tables on both ranks, and per-rank
    ``predict`` and ``cluster_statistics`` (the JAX package's
    ``test_two_process_fit``).  The ll product is exact float32: under one
    bf16 pass the 4-corner chain at 2000 points can sit at K=1 for most of
    its 60 sweeps (ROADMAP.md Queue 3, P8), whatever the layout."""
    x, gt = four_corners(2000)
    outs = spawn(tmp_path, x, (700, 1300), predict=True,
                 **dict(CORNERS, ll_precision="highest"))
    for o, rows in zip(outs, (slice(0, 700), slice(700, 2000))):
        assert int(o["k"]) == 4
        assert tdpmm.nmi(gt[rows], o["labels"]) >= 0.999
        assert len(set(o["digests"])) == 1
        np.testing.assert_array_equal(o["pred"], o["labels"])
        assert len(o["avg_ll"]) == 4 and np.isfinite(o["avg_ll"]).all()
        here = np.bincount(o["labels"], minlength=4) > 0   # on this rank
        assert o["avg_prob"][here].min() > 0.99


def test_two_ranks_smart_splits_and_exact_stats(tmp_path):
    """Smart splits (their Lloyd loop reads reduced sums on the host) and
    ``exact_post_move_stats`` (the redraw's host branch, a global draw)
    across unequal ranks: no rank waits on a collective the other skips,
    and both end with the same table."""
    x, gt = mixture()
    outs = spawn(tmp_path, x, (1100, 1900), **MIXTURE)
    assert len(set(outs[0]["digests"])) == 1
    assert list(outs[0]["hist_k"]) == list(outs[1]["hist_k"])
    labels = np.concatenate([o["labels"] for o in outs])
    assert int(outs[0]["k"]) > 1 and tdpmm.nmi(gt, labels) > 0.9
