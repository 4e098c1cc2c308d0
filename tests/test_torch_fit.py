"""The port's fits end to end on the CPU: the 4-corner golden gate through
``fit(device="cpu")`` with and without the feature cache, the multinomial
family, table-capacity tiers past 128, the log posterior of a JAX
``init_state`` table carried over by ``interop``, and the entry points'
refusals."""
import torch_threads  # noqa: F401

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

    def test_predict_factors_once_and_ignores_chunking(self, result,
                                                      monkeypatch):
        """predict factors the Student-t scale once per call, and its
        labels and probabilities do not depend on the chunk, bit for bit."""
        res, x, _ = result
        xn = x + np.random.default_rng(1).normal(0, 3, x.shape).astype(
            np.float32)
        family = res.model.family
        calls = []
        factor = family.predictive_factor
        monkeypatch.setattr(family, "predictive_factor",
                            lambda *a: calls.append(1) or factor(*a))
        small = res.model.predict(xn, chunk=7)
        assert len(calls) == 1
        whole = res.model.predict(xn, chunk=1 << 16)
        np.testing.assert_array_equal(small[0], whole[0])
        np.testing.assert_array_equal(small[1].view(np.uint32),
                                      whole[1].view(np.uint32))

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


def test_fit_refusals(monkeypatch):
    """No card: ``device="cuda"`` raises.  The CLI's ``--distributed``
    without a launcher's environment or a ``--coordinator`` says what it
    needs; both bf16 cache layouts are ported, and fit takes them."""
    from dpmmsubclusters_tpu_torch import run

    x, _ = four_corners(16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdpmm.fit(x, iters=1)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        run.main(["params.json", "--distributed", "--device", "cpu"])
    with pytest.raises(ValueError, match="num_processes"):
        run.main(["params.json", "--distributed", "--device", "cpu",
                  "--coordinator", "localhost:1"])
    for dt in ("bfloat16", "hybrid"):
        res = tdpmm.fit(x, iters=1, device="cpu", verbose=False,
                        feature_dtype=dt)
        assert res.model.cfg.feature_dtype == dt and res.k >= 1


class TestFourCornersWithoutCache(TestFourCorners):
    """The golden gate with the feature rows built by the kernels' plain
    versions from the raw points (``precompute_features=False``)."""

    @pytest.fixture(scope="class")
    def result(self):
        x, gt = four_corners()
        return (tdpmm.fit(x, alpha=100.0, iters=200, seed=12345,
                          verbose=False, device="cpu",
                          precompute_features=False), x, gt)


def test_uncached_fit_equals_cached_fit():
    """On the CPU the plain "gaussian" variant builds exactly the cache's
    rows, so the two fits follow the same chain."""
    x, _, _, _ = tdpmm.generate_gaussian_data(600, 3, 4, 50.0, seed=2)
    kw = dict(alpha=10.0, iters=20, seed=4, verbose=False, device="cpu",
              burnout=5)
    cached = tdpmm.fit(x, precompute_features=True, **kw)
    built = tdpmm.fit(x, precompute_features=False, **kw)
    assert cached.model.cfg.precompute_features is True
    assert built.model.cfg.precompute_features is False
    np.testing.assert_array_equal(built.labels, cached.labels)
    np.testing.assert_array_equal(built.model.sublabels,
                                  cached.model.sublabels)


def test_multinomial_fit():
    """tests/test_fit_e2e.py::test_multinomial_fit on the port."""
    x, gt, _ = tdpmm.generate_mnmm_data(2_000, 20, 3, 50, seed=1)
    res = tdpmm.fit(x, alpha=1.0, prior={"alpha": np.ones(20, np.float32)},
                    family="multinomial", iters=60, seed=3, verbose=False,
                    device="cpu")
    assert res.k > 1
    assert tdpmm.nmi(gt, res.labels) > 0.5
    assert res.model.family is tdpmm.MULTINOMIAL
    assert res.model.cfg.precompute_features is False
    np.testing.assert_array_equal(res.model.shift, 0.0)   # counts as given
    pred, probs = res.predict(x)
    assert probs.shape == (len(x), res.k)
    assert (pred == res.labels).mean() > 0.95
    assert np.isfinite(res.model.log_posterior())


def test_log_posterior_of_jax_multinomial_init_state_matches():
    """A JAX multinomial ``init_state`` table, carried over by
    ``table_from_jax``, gives the same log posterior in both packages."""
    x, _, _ = jdpmm.generate_mnmm_data(1_000, 12, 3, 40, seed=5)
    cfg = jdpmm.DPMMConfig(k_max=16, init_clusters=3, burnout=5,
                           verbose=False, precompute_features=False)
    engine = DPMMEngine(jdpmm.MULTINOMIAL, cfg, make_data_mesh(1))
    points, valid, n_total = engine.shard_points(x)
    state = engine.init_state(jax.random.PRNGKey(3), points, valid,
                              jdpmm.MULTINOMIAL.default_prior(12))
    table_np = jax.tree.map(np.asarray, jax.device_get(state.table))
    want = float(j_log_posterior(jdpmm.MULTINOMIAL, state.table, 1.0,
                                 n_total))
    got = float(t_log_posterior(tdpmm.MULTINOMIAL, table_from_jax(table_np),
                                1.0, float(len(x))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_entry_points_take_multinomial_and_uncached_fits():
    from dpmmsubclusters_tpu_torch.api import (_resolve_family,
                                               _resolve_precompute)

    x, _ = four_corners(64)
    counts = np.abs(x)
    for data, kw in ((counts, {"family": "multinomial"}),
                     (counts, {"family": tdpmm.MULTINOMIAL}),
                     (counts, {"prior": {"alpha": np.ones(2)}}),
                     (x, {"precompute_features": False})):
        res = tdpmm.fit(data, iters=2, device="cpu", verbose=False, **kw)
        assert res.k >= 1
    assert _resolve_family(None, {"alpha": 1}) is tdpmm.MULTINOMIAL
    assert _resolve_family("gaussian", None) is tdpmm.GAUSSIAN
    cfg = tdpmm.DPMMConfig()
    auto = {(fam.name, n, d): _resolve_precompute(fam, cfg, n, d)
            .precompute_features
            for fam in (tdpmm.GAUSSIAN, tdpmm.MULTINOMIAL)
            for n, d in ((1_000_000, 32), (10_000_000, 64))}
    assert auto == {("gaussian", 1_000_000, 32): True,
                    ("gaussian", 10_000_000, 64): False,
                    ("multinomial", 1_000_000, 32): False,
                    ("multinomial", 10_000_000, 64): False}
    on = cfg.replace(precompute_features=True)
    assert _resolve_precompute(tdpmm.MULTINOMIAL, on, 10, 3) \
        .precompute_features is True
    with pytest.raises(ValueError, match="alpha"):
        tdpmm.fit(x, prior={"alpha": np.ones(3)}, iters=1, device="cpu")
    with pytest.raises(ValueError, match="smart_splits"):
        tdpmm.fit(counts, family="multinomial", smart_splits=True,
                  iters=1, device="cpu")


def test_fit_migrates_past_tier_128(monkeypatch):
    """With k_max=256 the table grows 16 -> 32 -> 128 -> 256 as K passes 32
    (4K above the tier), and the fit runs on at width 256."""
    from dpmmsubclusters_tpu_torch.sampler import driver

    widths = []
    migrate = driver.migrate

    def spy(family, state, k_new):
        widths.append(k_new)
        return migrate(family, state, k_new)

    monkeypatch.setattr(driver, "migrate", spy)
    rng = np.random.default_rng(0)
    means = rng.standard_normal((48, 8)).astype(np.float32) * 8.0
    gt = rng.integers(0, 48, size=4800)
    x = means[gt] + rng.standard_normal((4800, 8)).astype(np.float32)
    res = tdpmm.fit(x, alpha=10.0, iters=64, seed=1, verbose=False,
                    device="cpu", k_max=256, burnout=5)
    assert widths[-1] == 256 and 128 in widths
    assert res.model.table["active"].shape == (256,)
    assert res.k > 32
    assert tdpmm.nmi(gt, res.labels) > 0.95
