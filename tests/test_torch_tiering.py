"""The reference's capacity-tier tests (tests/test_tiering.py) mirrored on
the port (``device="cpu"``): the tier rule and the tier setup against the
JAX package's on the same inputs (integers, exactly), a table migrated up
and back down that keeps sampling, and the reference tests' gates for the
sampled fits (the golden 4 corners with tiers on; a ``max_clusters`` cap
that bounds the table)."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu import api as japi  # noqa: E402
from dpmmsubclusters_tpu.config import DPMMConfig as JConfig  # noqa: E402
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from dpmmsubclusters_tpu.sampler import driver as JD  # noqa: E402
from dpmmsubclusters_tpu_torch import api as tapi  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig as TConfig  # noqa: E402,E501
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler import driver as TD  # noqa: E402


def test_desired_tier_grow_shrink_hysteresis():
    for D in (JD, TD):
        tiers = D.tier_sequence(128)
        assert D.desired_tier(5, 16, tiers) == 32       # 4*5 > 16
        assert D.desired_tier(5, 32, tiers) == 32       # headroom ok
        assert D.desired_tier(40, 64, tiers) == 128     # 4*40 > 64
        assert D.desired_tier(40, 128, tiers) == 128    # capped at k_max
        assert D.desired_tier(2, 128, tiers) == 16      # 16*2 <= 128
        # no flapping: the grow threshold after a shrink is not adjacent
        assert D.desired_tier(2, 16, tiers) == 16
        assert D.desired_tier(4, 16, tiers) == 16


def _k(metrics) -> int:
    return int(metrics["k"][-1])


def test_retier_roundtrip_continues_sampling():
    """A settled state (6 components, 30 sweeps at 16 slots) migrated to
    32 slots keeps its per-cluster counts and labels, samples 10 sweeps
    there, migrates back to 16 and samples on (K >= 2, finite
    statistics), as the reference test's engine does."""
    rng = np.random.default_rng(0)
    means = rng.standard_normal((6, 4)).astype(np.float32) * 12
    lab = rng.integers(0, 6, 4000)
    x = means[lab] + rng.standard_normal((4000, 4)).astype(np.float32)
    cfg = TConfig(k_max=16, chunk_size=512, burnout=5, alpha=10.0,
                  verbose=False)
    eng = TD.DPMMEngine(GAUSSIAN, cfg, device="cpu")
    pts, valid, n_total = eng.shard_points(x - x.mean(0))
    st = eng.init_state(torch.Generator().manual_seed(0), pts, valid,
                        GAUSSIAN.default_prior(4))
    st, m = eng.step_block(st, pts, valid, n_total, [False] * 30,
                           [False] * 30)
    act0 = st.table["active"].clone()
    n0 = np.sort(st.table["stats"]["n"][act0, 0].numpy())
    assert int(act0.sum()) >= 2

    st32 = TD.migrate(GAUSSIAN, st, 32)
    act1 = st32.table["active"]
    assert st32.table["active"].shape[0] == 32
    k1 = int(act1.sum())
    assert torch.equal(torch.nonzero(act1)[:, 0], torch.arange(k1))
    np.testing.assert_allclose(
        np.sort(st32.table["stats"]["n"][act1, 0].numpy()), n0)
    hist = np.bincount(st32.labels.numpy(), minlength=32)
    np.testing.assert_allclose(hist[:k1],
                               st32.table["stats"]["n"][:k1, 0].numpy())

    eng32 = TD.DPMMEngine(GAUSSIAN, cfg.replace(k_max=32), device="cpu")
    st32, m = eng32.step_block(st32, pts, valid, n_total, [False] * 10,
                               [False] * 10)
    assert _k(m) >= 2
    st16 = TD.migrate(GAUSSIAN, st32, 16)
    st16, m2 = eng.step_block(st16, pts, valid, n_total, [False] * 10,
                              [False] * 10)
    assert _k(m2) >= 2
    assert torch.isfinite(st16.table["stats"]["n"]).all()


def _tier_setups(**kw):
    """(starting width, ceiling) of the port's and the JAX package's tier
    setup for one config."""
    t_start, tiers = tapi._tier_setup(TConfig(**kw))
    engine, _, ceiling = japi._tier_setup(jdpmm.GAUSSIAN, JConfig(**kw),
                                          make_data_mesh(1))
    return (t_start, tiers[-1]), (engine.cfg.k_max, ceiling)


def test_fit_with_auto_tier_golden():
    """The 4-corner golden gate with tier migrations on (reference
    test/module_tests.jl:10-32): K=4, 250 points a cluster, predict ==
    labels; the tier setup is the JAX package's."""
    x = np.zeros((1000, 2), np.float32)
    corners = np.array(
        [[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0], [-10.0, -10.0]])
    gt = np.zeros(1000, np.int64)
    for i in range(4):
        x[i * 250:(i + 1) * 250] = corners[i]
        gt[i * 250:(i + 1) * 250] = i
    port, ref = _tier_setups(k_max=64, auto_tier=True)
    assert port == ref
    res = tdpmm.fit(x, alpha=100.0, iters=200, seed=12345, verbose=False,
                    k_max=64, auto_tier=True, device="cpu")
    assert res.k == 4
    hist = tdpmm.get_labels_histogram(res.labels)
    assert sorted(hist.values()) == [250, 250, 250, 250]
    pred, _ = res.predict(x)
    assert np.array_equal(pred, res.labels)


def test_max_clusters_caps_tier_ceiling():
    """max_clusters shrinks the tier ceiling to the smallest tier covering
    the cap (16 for 14, in both packages; 32 with the outlier slot at 16),
    and the fit's table never grows past it."""
    for kw, want in ((dict(max_clusters=14), 16),
                     (dict(max_clusters=16, outlier_mod=0.05), 32)):
        port, ref = _tier_setups(k_max=64, auto_tier=True, **kw)
        assert port == ref and port[1] == want
    x, gt, _, _ = tdpmm.generate_gaussian_data(4_000, 2, 8, 80.0, seed=1)
    res = tdpmm.fit(x, alpha=10.0, iters=40, seed=1, verbose=False,
                    burnout=3, k_max=64, max_clusters=14, auto_tier=True,
                    device="cpu")
    assert res.model.table["active"].shape[0] <= 16
    assert res.k <= 14
