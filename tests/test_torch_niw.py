"""The PyTorch port's NIW family against the JAX one on identical inputs."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import scipy.stats as st  # noqa: E402

from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG  # noqa: E402

# deterministic float32 table math: the two frameworks round differently in
# the last bits (LAPACK vs XLA factorizations, fused vs separate ops)
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


def _stats(rng, k, d, empty=()):
    """Batched [k, 3] statistics of random point sets (side 0 = 1 + 2)."""
    n = np.zeros((k, 3), np.float32)
    sx = np.zeros((k, 3, d), np.float32)
    sxx = np.zeros((k, 3, d, d), np.float32)
    for i in range(k):
        if i in empty:
            continue
        for side in (1, 2):
            pts = (rng.standard_normal((20 + 7 * i + side, d)) + i).astype(
                np.float32)
            n[i, side] = len(pts)
            sx[i, side] = pts.sum(0)
            sxx[i, side] = pts.T @ pts
        n[i, 0], sx[i, 0], sxx[i, 0] = n[i, 1:].sum(), sx[i, 1:].sum(0), \
            sxx[i, 1:].sum(0)
    return {"n": n, "sum_x": sx, "sum_xx": sxx}


def _prior(k, d, batch=3):
    p = {k_: np.asarray(v) for k_, v in JG.default_prior(d).items()}
    p["kappa"] = np.float32(1.5)
    p["m"] = np.linspace(-1, 1, d).astype(np.float32)
    return {k_: np.broadcast_to(v, (k, batch) + v.shape).copy()
            for k_, v in p.items()}


@pytest.mark.parametrize("d", [2, 5])
def test_features_bit_identical(rng, d):
    x = rng.standard_normal((300, d)).astype(np.float32)
    got = TG.features(torch.from_numpy(x)).numpy()
    want = np.asarray(JG.features(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_and_flat_stats_match(rng):
    d = 4
    m = rng.standard_normal((5, d, d)).astype(np.float32)
    m = m + np.swapaxes(m, -1, -2)
    for dbl in (False, True):
        got = TG.pack_sym(torch.from_numpy(m), double_offdiag=dbl).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JG.pack_sym(jnp.asarray(m), double_offdiag=dbl)))
    packed = TG.pack_sym(torch.from_numpy(m), double_offdiag=False)
    np.testing.assert_array_equal(TG.unpack_sym(packed, d).numpy(), m)
    stats = _stats(rng, 3, d)
    flat = TG.stats_to_flat(_t(stats))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(JG.stats_to_flat(_j(stats))))
    _close(TG.stats_from_flat(flat, d), stats, 0, 0)


def test_posterior_marginals_and_caches_match(rng):
    k, d = 4, 3
    stats = _stats(rng, k, d, empty=(2,))
    prior = _prior(k, d)
    jpost = JG.calc_posterior(_j(prior), _j(stats))
    tpost = TG.calc_posterior(_t(prior), _t(stats))
    _close(tpost, jpost)
    mask = np.array([True, True, True, False])[:, None].repeat(3, 1)
    jprior_aug = JG.augment_prior(_j(prior))
    tprior_aug = TG.augment_prior(_t(prior))
    _close(tprior_aug, jprior_aug)
    jcache = JG.posterior_cache(jpost, jnp.asarray(mask))
    tcache = TG.posterior_cache(tpost, torch.from_numpy(mask))
    _close(tcache, jcache)
    for cache in (None, "cache"):
        want = JG.log_marginal(jprior_aug, jpost, _j(stats),
                               jnp.asarray(mask),
                               cache=jcache if cache else None)
        got = TG.log_marginal(tprior_aug, tpost, _t(stats),
                              torch.from_numpy(mask),
                              cache=tcache if cache else None)
        _close(got, want)
        assert np.all(got.numpy()[2:] == 0.0)   # empty / masked slots


def test_pairwise_marginal_and_screen_score_match(rng):
    k, d = 5, 3
    stats = {k_: v[:, 0] for k_, v in _stats(rng, k, d).items()}
    prior = {k_: v[:, 0] for k_, v in _prior(k, d).items()}
    mask = np.array([True, True, False, True, True])
    for aug in (False, True):
        jp, tp = _j(prior), _t(prior)
        if aug:
            jp, tp = JG.augment_prior(jp), TG.augment_prior(tp)
        want = JG.log_marginal_pairwise(jp, _j(stats), jnp.asarray(mask))
        got = TG.log_marginal_pairwise(tp, _t(stats), torch.from_numpy(mask))
        _close(got, want)
    post = JG.calc_posterior(_j(prior), _j(stats))
    a = rng.standard_normal((k, d, d)).astype(np.float32)
    prec = a @ np.swapaxes(a, -1, -2) + np.eye(d, dtype=np.float32)
    want = JG.merge_screen_score(post, {"prec": jnp.asarray(prec)})
    got = TG.merge_screen_score(_t(post), {"prec": torch.from_numpy(prec)})
    _close(got, want)


def test_posterior_predictive_matches(rng):
    k, d = 3, 2
    stats = {k_: v[:, 0] for k_, v in _stats(rng, k, d).items()}
    prior = {k_: v[:, 0] for k_, v in _prior(k, d).items()}
    hyper = JG.calc_posterior(_j(prior), _j(stats))
    x = rng.standard_normal((40, d)).astype(np.float32) * 3
    want = JG.posterior_predictive(jnp.asarray(x), hyper)
    got = TG.posterior_predictive(torch.from_numpy(x), _t(hyper))
    assert got.shape == (40, k)
    _close(got, want)


def test_posterior_predictive_factors_once_per_model(rng):
    """The per-model factor, evaluated per chunk of points, gives the
    one-call form bit for bit."""
    k, d = 3, 4
    stats = {k_: v[:, 0] for k_, v in _stats(rng, k, d).items()}
    prior = {k_: v[:, 0] for k_, v in _prior(k, d).items()}
    hyper = TG.calc_posterior(_t(prior), _t(stats))
    x = torch.from_numpy(rng.standard_normal((50, d)).astype(np.float32))
    factor = TG.predictive_factor(hyper, d)
    whole = TG.posterior_predictive(x, hyper)
    parts = torch.cat([TG.predictive_logpdf(x[p0:p0 + 7], factor)
                       for p0 in range(0, 50, 7)])
    assert torch.equal(TG.predictive_logpdf(x, factor), whole)
    assert torch.equal(parts, whole)


def test_prior_transforms_match():
    d = 3
    shift = np.array([1.0, -2.0, 0.5], np.float32)
    scale = np.array([0.5, 2.0, 1.0], np.float32)
    jp = JG.scale_prior(JG.shift_prior(JG.default_prior(d), shift), scale)
    tp = TG.scale_prior(TG.shift_prior(TG.default_prior(d), shift), scale)
    _close(tp, jp, 0, 0)


def test_sample_params_moments_and_phi():
    """E[mu] = m and E[Sigma] = nu*psi/(nu-D-1) (tests/test_priors.py's
    check), and feat(x) . phi is the Gaussian log-density of the draw."""
    d, b = 2, 6000
    psi = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)
    hyper = {
        "kappa": torch.full((b,), 4.0),
        "m": torch.tensor([1.0, -2.0]).expand(b, d),
        "nu": torch.full((b,), 9.0),
        "psi": torch.from_numpy(psi).expand(b, d, d),
    }
    params = TG.sample_params(torch.Generator().manual_seed(3), hyper,
                              torch.ones(b, dtype=torch.bool))
    np.testing.assert_allclose(params["mu"].mean(0).numpy(), [1.0, -2.0],
                               atol=0.05)
    sigmas = np.linalg.inv(params["prec"].numpy())
    np.testing.assert_allclose(sigmas.mean(0), 9.0 * psi / (9.0 - d - 1),
                               rtol=0.08)
    x = np.array([[0.3, 0.7]], np.float32)
    ll = TG.features(torch.from_numpy(x)).numpy() @ params["phi"][0].numpy()
    want = st.multivariate_normal(params["mu"][0].numpy(),
                                  sigmas[0]).logpdf(x)
    np.testing.assert_allclose(ll[0], want, rtol=1e-3, atol=1e-3)
