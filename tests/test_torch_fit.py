"""The port's main path end to end on the CPU: the 4-corner golden gate
through ``fit(device="cpu")``, the log posterior of a JAX ``init_state``
table carried over by ``interop``, and the entry points' refusals."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from dpmmsubclusters_tpu.sampler.driver import DPMMEngine  # noqa: E402
from dpmmsubclusters_tpu.sampler.table import (  # noqa: E402
    log_posterior as j_log_posterior)
from dpmmsubclusters_tpu_torch.interop import table_from_jax  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.table import (  # noqa: E402
    log_posterior as t_log_posterior)


def four_corners(n=1000):
    """1000 points at 4 exact corners (reference test/module_tests.jl:1-8)."""
    x = np.zeros((n, 2), np.float32)
    labels = np.zeros(n, np.int64)
    corners = np.array([[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0],
                        [-10.0, -10.0]])
    for i in range(4):
        x[i * (n // 4):(i + 1) * (n // 4)] = corners[i]
        labels[i * (n // 4):(i + 1) * (n // 4)] = i
    return x, labels


class TestFourCorners:
    """The golden gate (tests/test_fit_e2e.py::TestFourCorners) on the
    port's plain PyTorch path."""

    @pytest.fixture(scope="class")
    def result(self):
        x, gt = four_corners()
        return (tdpmm.fit(x, alpha=100.0, iters=200, seed=12345,
                          verbose=False, device="cpu"), x, gt)

    def test_k_and_histogram(self, result):
        res, _, _ = result
        assert res.k == 4
        hist = tdpmm.get_labels_histogram(res.labels)
        assert sorted(hist.values()) == [250, 250, 250, 250]
        assert np.all(res.weights > 0.15)

    def test_nmi(self, result):
        res, _, gt = result
        assert tdpmm.nmi(gt, res.labels) > 0.999

    def test_predict_matches_training_labels(self, result):
        res, x, _ = result
        pred, probs = res.predict(x)
        assert np.array_equal(pred, res.labels)
        assert probs.shape == (len(x), 4)

    def test_history_and_log_posterior(self, result):
        res, _, _ = result
        h = res.history
        assert len(h.k) == len(h.times) == len(h.log_posterior) == 200
        assert h.k[-1] == 4 and all(t > 0 for t in h.times)
        assert np.isfinite(res.model.log_posterior())


def test_log_posterior_of_jax_init_state_matches():
    """A JAX ``init_state`` table, carried over by ``table_from_jax``, gives
    the same log posterior in both packages."""
    x, _ = four_corners()
    x = (x - x.mean(0)) / x.std(0)
    cfg = jdpmm.DPMMConfig(k_max=16, init_clusters=3, burnout=5,
                           verbose=False, precompute_features=False)
    engine = DPMMEngine(jdpmm.GAUSSIAN, cfg, make_data_mesh(1))
    points, valid, n_total = engine.shard_points(x)
    state = engine.init_state(jax.random.PRNGKey(3), points, valid,
                              jdpmm.GAUSSIAN.default_prior(2))
    table_np = jax.tree.map(np.asarray, jax.device_get(state.table))
    want = float(j_log_posterior(jdpmm.GAUSSIAN, state.table, 10.0,
                                 n_total))
    got = float(t_log_posterior(tdpmm.GAUSSIAN, table_from_jax(table_np),
                                10.0, float(len(x))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fit_runs_outlier_tiers_and_exact_stats():
    """Non-default config paths of the slice on a small mixture: outlier
    slot, a fixed table, exact post-move statistics, screened merges."""
    x, gt, _, _ = tdpmm.generate_gaussian_data(2000, 2, 3, 100.0, seed=0)
    res = tdpmm.fit(x, alpha=10.0, iters=40, seed=5, verbose=False,
                    device="cpu", outlier_mod=0.01, k_max=16,
                    exact_post_move_stats=True, merge_candidates=8,
                    burnout=5, max_clusters=6)
    assert 1 <= res.k <= 7
    assert tdpmm.nmi(gt, res.labels) > 0.5
    assert res.model.table["is_outlier"][0]


def test_fit_refusals():
    x, _ = four_corners(16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdpmm.fit(x, iters=1)
    for kw in ({"family": "multinomial"},
               {"feature_dtype": "bfloat16"},
               {"precompute_features": False}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdpmm.fit(x, iters=1, device="cpu", **kw)
