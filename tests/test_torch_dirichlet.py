"""The PyTorch port's multinomial/Dirichlet family against the JAX one on
identical inputs, both held to an independent float64 oracle of the
Dirichlet-multinomial marginal likelihood, and the parameter draws checked
by their moments."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from scipy.special import gammaln  # noqa: E402

from dpmmsubclusters_tpu.priors import MULTINOMIAL as JM  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TM  # noqa: E402

# deterministic float32 table math: lgamma and the sums round differently
# in the last bits in the two frameworks
RTOL, ATOL = 1e-5, 1e-4


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _counts(rng, k, d, empty=()):
    """Per-slot count matrices [n_i, D] and their [k] statistics."""
    xs = []
    for i in range(k):
        n = 0 if i in empty else 5 + 3 * i
        p = rng.dirichlet(np.ones(d) + i)
        xs.append(rng.multinomial(40, p, size=n).astype(np.float32))
    stats = {"n": np.array([len(x) for x in xs], np.float32),
             "sum_x": np.stack([x.sum(0) for x in xs]).astype(np.float32)}
    return xs, stats


def _prior(rng, k, d):
    return {"alpha": np.broadcast_to(
        rng.uniform(0.5, 2.0, size=d).astype(np.float32), (k, d)).copy()}


def _oracle(alpha0, x):
    """float64 Dirichlet-multinomial log marginal of the count rows ``x``
    (without the multinomial coefficient, as multinomial_prior.jl:34-39):
    lnG(sum a) - lnG(sum a + total) + sum_d [lnG(a_d + s_d) - lnG(a_d)]."""
    a = np.asarray(alpha0, np.float64)
    s = np.asarray(x, np.float64).sum(0)
    return (gammaln(a.sum()) - gammaln(a.sum() + s.sum())
            + (gammaln(a + s) - gammaln(a)).sum())


def test_features_and_stats_round_trip(rng):
    x = rng.integers(0, 9, size=(50, 6)).astype(np.float32)
    got = TM.features(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JM.features(x)))
    np.testing.assert_array_equal(TM.stat_features(torch.from_numpy(x)),
                                  got.numpy())
    assert TM.feature_dim(6) == TM.stat_dim(6) == JM.feature_dim(6) == 7
    _, stats = _counts(rng, 4, 6)
    flat = TM.stats_to_flat(_t(stats))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(JM.stats_to_flat(_j(stats))))
    _close(TM.stats_from_flat(flat, 6), stats, 0, 0)
    # lane-padded flat rows (zero columns past 1 + D) come back unpadded
    padded = torch.cat([flat, torch.zeros(4, 9)], dim=1)
    _close(TM.stats_from_flat(padded, 6), stats, 0, 0)
    empty = TM.empty_stats((3, 2), 6)
    assert empty["n"].shape == (3, 2) and empty["sum_x"].shape == (3, 2, 6)


def test_posterior_marginals_and_screen_match_jax(rng):
    k, d = 6, 5
    _, stats = _counts(rng, k, d, empty=(2,))
    prior = _prior(rng, k, d)
    mask = np.array([True, True, True, False, True, True])
    post_t = TM.calc_posterior(_t(prior), _t(stats))
    post_j = JM.calc_posterior(_j(prior), _j(stats))
    _close(post_t, post_j)
    np.testing.assert_array_equal(post_t["alpha"][2].numpy(),
                                  prior["alpha"][2])
    lm_t = TM.log_marginal(_t(prior), post_t, _t(stats),
                           torch.from_numpy(mask))
    lm_j = JM.log_marginal(_j(prior), post_j, _j(stats), jnp.asarray(mask))
    _close(lm_t, lm_j)
    assert float(lm_t[2]) == 0.0 and float(lm_t[3]) == 0.0
    pw_t = TM.log_marginal_pairwise(_t(prior), _t(stats),
                                    torch.from_numpy(mask))
    pw_j = JM.log_marginal_pairwise(_j(prior), _j(stats), jnp.asarray(mask))
    _close(pw_t, pw_j)
    sc_t = TM.merge_screen_score({"alpha": post_t["alpha"]}, None)
    sc_j = JM.merge_screen_score({"alpha": post_j["alpha"]}, None)
    _close(sc_t, sc_j)
    assert torch.all(sc_t.diagonal() <= sc_t + 1e-5)   # self is closest


def test_posterior_predictive_matches_jax(rng):
    k, d = 4, 7
    _, stats = _counts(rng, k, d)
    post = TM.calc_posterior(_t(_prior(rng, k, d)), _t(stats))
    x = rng.integers(0, 12, size=(33, d)).astype(np.float32)
    got = TM.posterior_predictive(torch.from_numpy(x), post)
    want = JM.posterior_predictive(jnp.asarray(x), _j(post))
    assert got.shape == (33, k)
    _close(got, want)
    # the per-model factor, then the evaluation: the one-call form's bits
    factor = TM.predictive_factor(post, d)
    assert torch.equal(TM.predictive_logpdf(torch.from_numpy(x), factor), got)


@pytest.mark.parametrize("family", ["torch", "jax"])
def test_log_marginal_matches_float64_oracle(rng, family):
    """Both packages' Dirichlet-multinomial marginal, and the merged-pair
    form, against scipy's float64 gammaln on the raw counts."""
    fam, conv = (TM, _t) if family == "torch" else (JM, _j)
    k, d = 5, 8
    xs, stats = _counts(rng, k, d)
    prior = _prior(rng, k, d)
    mask = np.ones(k, bool)
    mask_c = (torch.from_numpy(mask) if family == "torch"
              else jnp.asarray(mask))
    post = fam.calc_posterior(conv(prior), conv(stats))
    lm = np.asarray(fam.log_marginal(conv(prior), post, conv(stats), mask_c))
    want = [_oracle(prior["alpha"][i], xs[i]) for i in range(k)]
    np.testing.assert_allclose(lm, want, rtol=1e-5)
    pw = np.asarray(fam.log_marginal_pairwise(conv(prior), conv(stats),
                                              mask_c))
    for i in range(k):
        for j in range(k):
            merged = np.concatenate([xs[i], xs[j]])
            np.testing.assert_allclose(pw[i, j],
                                       _oracle(prior["alpha"][i], merged),
                                       rtol=1e-5)


@pytest.mark.parametrize("family", ["torch", "jax"])
def test_log_marginal_padding_invariance(rng, family):
    """Padding rows (all-zero counts, as the invalid rows of a padded shard
    add) and padding slots (masked out) change no active slot's value, and a
    masked slot gives exactly 0."""
    fam, conv = (TM, _t) if family == "torch" else (JM, _j)
    k, d = 4, 6
    xs, stats = _counts(rng, k, d)
    prior = _prior(rng, k + 3, d)
    padded_x = [np.concatenate([x, np.zeros((11, d), np.float32)]) for x in xs]
    padded = {"n": np.array([len(x) for x in padded_x], np.float32),
              "sum_x": np.stack([x.sum(0) for x in padded_x])}
    # three padding slots: empty statistics, masked out
    for name, fill in (("n", np.zeros(3, np.float32)),
                       ("sum_x", np.zeros((3, d), np.float32))):
        padded[name] = np.concatenate([padded[name], fill])
    mask = np.arange(k + 3) < k

    def lm(st, pr, m):
        m = torch.from_numpy(m) if family == "torch" else jnp.asarray(m)
        post = fam.calc_posterior(conv(pr), conv(st))
        return np.asarray(fam.log_marginal(conv(pr), post, conv(st), m))

    base = lm(stats, {"alpha": prior["alpha"][:k]}, np.ones(k, bool))
    got = lm(padded, prior, mask)
    np.testing.assert_array_equal(got[:k], base)
    np.testing.assert_array_equal(got[k:], 0.0)
    np.testing.assert_allclose(
        base, [_oracle(prior["alpha"][i], padded_x[i]) for i in range(k)],
        rtol=1e-5)


def test_sample_params_moments():
    """E[exp(log p)] = alpha / sum(alpha) for log p ~ log Dirichlet(alpha);
    phi = [0, log p] and the draws are normalized."""
    alpha = np.array([0.5, 1.0, 2.0, 4.0, 8.0], np.float32)
    n = 20000
    gen = torch.Generator().manual_seed(0)
    hyper = {"alpha": torch.from_numpy(np.broadcast_to(alpha, (n, 5)).copy())}
    out = TM.sample_params(gen, hyper, torch.ones(n, dtype=torch.bool))
    p = torch.exp(out["log_p"]).double().numpy()
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(out["phi"][:, 0].numpy(), 0.0)
    np.testing.assert_array_equal(out["phi"][:, 1:].numpy(),
                                  out["log_p"].numpy())
    mean = alpha / alpha.sum()
    a0 = alpha.sum()
    sd = np.sqrt(mean * (1 - mean) / (a0 + 1))       # Dirichlet marginal sd
    # the mean within 5 standard errors, the variance within 10%
    assert np.all(np.abs(p.mean(0) - mean) < 5 * sd / np.sqrt(n))
    np.testing.assert_allclose(p.var(0), sd ** 2, rtol=0.1)
    # a tiny alpha is clamped at 1e-6 and its log-Gamma draws stay finite
    tiny = TM.sample_params(gen, {"alpha": torch.full((64, 3), 1e-9)},
                            torch.ones(64, dtype=torch.bool))
    assert torch.isfinite(tiny["log_p"]).all()


def test_default_prior_tile_and_shift():
    prior = TM.default_prior(4)
    np.testing.assert_array_equal(prior["alpha"].numpy(),
                                  np.asarray(JM.default_prior(4)["alpha"]))
    tiled = TM.tile_prior(prior, (3,))
    assert tiled["alpha"].shape == (3, 4)
    tiled["alpha"][0, 0] = 7.0                      # a copy, not a view
    assert float(prior["alpha"][0]) == 1.0
    assert TM.shift_prior(prior, np.ones(4)) is prior
    np.testing.assert_array_equal(TM.make_prior([1.0, 2.0])["alpha"].numpy(),
                                  [1.0, 2.0])
