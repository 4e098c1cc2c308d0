"""The reference's config-knob tests (tests/test_config_behaviors.py)
mirrored on the port (``device="cpu"``): the same data (the JAX package's
generators, or the reference test's own construction) go to the port's
``fit``, and its sampled output is held to the reference test's gate (K,
NMI, predict against labels, where the outliers land); the deterministic
parts (the standardization's scale, the de-transformed parameters)
against the numbers the reference test states."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from tests.test_fit_e2e import four_corners  # noqa: E402

CPU = dict(verbose=False, device="cpu")


def test_hard_clustering_runs_and_recovers():
    """hard_clustering=True: argmax assignments from the first sweep; the
    splits still work and predict reproduces the labels."""
    x, gt = four_corners(400)
    res = tdpmm.fit(x, alpha=100.0, iters=60, seed=2, burnout=5,
                    hard_clustering=True, **CPU)
    assert res.k >= 2
    pred, _ = res.predict(x)
    assert tdpmm.nmi(pred, res.labels) > 0.999


def test_final_iterations_are_argmax():
    """The last argmax_sample_stop sweeps take argmax labels, so predict
    reproduces them exactly."""
    x, gt = four_corners(400)
    res = tdpmm.fit(x, alpha=100.0, iters=80, seed=3, burnout=5, **CPU)
    pred, _ = res.predict(x)
    assert np.array_equal(pred, res.labels)


def test_outlier_component_attracts_outliers():
    """outlier_mod > 0 keeps a fixed-weight outlier slot (slot 0) with a
    broad prior: the corners are found among the rest, few corner points
    and most uniform outliers land in it."""
    x, gt = four_corners(400)
    rng = np.random.default_rng(0)
    outliers = rng.uniform(-50, 50, size=(20, 2)).astype(np.float32)
    data = np.concatenate([x, outliers])
    res = tdpmm.fit(
        data, alpha=100.0, iters=80, seed=4, burnout=5, outlier_mod=0.05,
        outlier_prior={"kappa": 1.0, "m": [0.0, 0.0], "nu": 5.0,
                       "psi": [[600.0, 0.0], [0.0, 600.0]]}, **CPU)
    assert res.k >= 4
    raw = res.model.labels_raw
    assert (raw[:400] == 0).mean() < 0.2
    assert (raw[400:] == 0).mean() > 0.5


def test_k_max_overflow_suppresses_splits():
    """A full table drops further splits instead of corrupting state."""
    x, gt, _, _ = jdpmm.generate_gaussian_data(2_000, 2, 8, 80.0, seed=1)
    res = tdpmm.fit(x, alpha=10.0, iters=60, seed=1, burnout=3, k_max=4,
                    **CPU)
    assert 1 <= res.k <= 4
    assert res.model.table["active"].shape[0] == 4


def test_multinomial_predict_and_stats():
    x, gt, _ = jdpmm.generate_mnmm_data(1_500, 12, 3, 40, seed=2)
    res = tdpmm.fit(x, alpha=1.0, family="multinomial", iters=50, seed=5,
                    burnout=5, **CPU)
    pred, probs = res.predict(x)
    assert probs.shape == (1500, res.k)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-4)
    assert tdpmm.nmi(pred, res.labels) > 0.95
    avg_ll, avg_prob = res.model.cluster_statistics(x, res.labels)
    assert len(avg_ll) == res.k
    assert np.all(avg_prob > 0.3)


def test_merge_candidates_config_end_to_end():
    """The screened merge finds the same clustering on the golden data."""
    x, gt = four_corners(400)
    res = tdpmm.fit(x, alpha=100.0, iters=80, seed=6, burnout=5,
                    merge_candidates=8, **CPU)
    assert res.k == 4
    assert tdpmm.nmi(gt, res.labels) > 0.999


def test_standardize_data_invariance_and_detransform(tmp_path):
    """A badly anisotropic dataset (variance ratio ~1e8) is recovered with
    standardize_data, and cluster_params, predict and a checkpoint's
    resume live in the data space: the reference test's gates."""
    rng = np.random.default_rng(4)
    mus = np.array([[-300.0, 0.02], [300.0, -0.02], [0.0, 0.06]], np.float32)
    sd = np.array([40.0, 0.01], np.float32)
    x = np.concatenate(
        [rng.normal(mus[i], sd, (1500, 2)).astype(np.float32)
         for i in range(3)])
    gt = np.repeat(np.arange(3), 1500)
    prior = {"kappa": 1.0, "m": x.mean(axis=0), "nu": 6.0,
             "psi": np.diag(sd.astype(np.float64) ** 2).astype(np.float32)}
    r = tdpmm.fit(x, alpha=10.0, iters=80, seed=0, k_max=16,
                  standardize_data=True, prior=prior, gt=gt,
                  smart_splits=True, **CPU)
    assert r.k == 3
    assert tdpmm.nmi(gt, r.labels) > 0.95
    np.testing.assert_allclose(r.model.scale, 1.0 / x.std(axis=0),
                               rtol=1e-4)
    cp = r.model.cluster_params()
    found = np.sort([c["mu"][0] for c in cp])
    np.testing.assert_allclose(found, [-300.0, 0.0, 300.0], atol=15.0)
    for c in cp:
        np.testing.assert_allclose(np.sqrt(np.diag(c["cov"])), sd, rtol=0.5)
    lab, _ = r.model.predict(mus)
    assert len(set(lab.tolist())) == 3
    path = str(tmp_path / "std_ck.npz")
    r.model.save(path)
    r2 = tdpmm.run_from_checkpoint(path, x, iters=r.model.step + 3,
                                   verbose=False, device="cpu")
    assert r2.k == 3
    np.testing.assert_allclose(r2.model.scale, r.model.scale, rtol=1e-6)


def test_reference_splittable_gate_flag_runs():
    """reference_splittable_gate=True (with the reference's own
    smart_splits=False) behaves like the default gate on the corners."""
    x, gt = four_corners(400)
    r = tdpmm.fit(x, alpha=100.0, iters=60, seed=1, burnout=5,
                  reference_splittable_gate=True, smart_splits=False, **CPU)
    assert r.k == 4
    assert tdpmm.nmi(gt, r.labels) > 0.999
