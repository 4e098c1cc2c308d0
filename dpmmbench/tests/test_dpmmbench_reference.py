"""The plain reference against float64 NumPy at a tiny size."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from tinybench import REPO  # noqa: F401  (puts the repository on the path)

from dpmmbench.reference import gauss, gumbel


def spd(rng, d):
    a = rng.standard_normal((d, d))
    return a @ a.T + d * np.eye(d)


def test_loglik_coeffs_give_the_gaussian_log_density():
    rng = np.random.default_rng(0)
    d, k = 3, 4
    mu = rng.standard_normal((k, d)) * 3
    prec = np.stack([spd(rng, d) for _ in range(k)])
    x = rng.standard_normal((50, d)) * 3
    got = (gauss.features(torch.tensor(x))
           @ gauss.loglik_coeffs(torch.tensor(mu), torch.tensor(prec))).numpy()
    for j in range(k):
        diff = x - mu[j]
        quad = np.einsum("ni,ij,nj->n", diff, prec[j], diff)
        want = -0.5 * (d * math.log(2 * math.pi)
                       - np.linalg.slogdet(prec[j])[1] + quad)
        np.testing.assert_allclose(got[:, j], want, rtol=1e-12, atol=1e-10)


def test_sums_by_key_and_posterior_match_numpy():
    rng = np.random.default_rng(1)
    d, k, n = 3, 3, 200
    x = rng.standard_normal((n, d))
    key = rng.integers(0, k, n)
    feats = gauss.features(torch.tensor(x))
    sums = gauss.sums_by_key(feats, torch.tensor(key), k).numpy()
    prior = dict(kappa=1.0, m=np.zeros(d), nu=d + 3.0, psi=np.eye(d))
    for j in range(k):
        xj = x[key == j]
        np.testing.assert_allclose(sums[j, 0], len(xj))
        np.testing.assert_allclose(sums[j, 1:1 + d], xj.sum(0), rtol=1e-12)
        iu = np.triu_indices(d)
        np.testing.assert_allclose(sums[j, 1 + d:], (xj.T @ xj)[iu],
                                   rtol=1e-12)
        stats = {"n": torch.tensor(float(len(xj))),
                 "sum_x": torch.tensor(xj.sum(0)),
                 "sum_xx": torch.tensor(xj.T @ xj)}
        post = gauss.niw_posterior({kk: torch.tensor(v) for kk, v in
                                    prior.items()}, stats)
        n_j = len(xj)
        kappa = 1.0 + n_j
        m = xj.sum(0) / kappa
        psi = ((d + 3.0) * np.eye(d) - kappa * np.outer(m, m)
               + xj.T @ xj) / (d + 3.0 + n_j)
        np.testing.assert_allclose(post["kappa"], kappa)
        np.testing.assert_allclose(post["m"].numpy(), m, rtol=1e-12)
        np.testing.assert_allclose(post["psi"].numpy(), psi, rtol=1e-10)


def test_nmi_matches_numpy_and_is_label_free():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 5, 1000)
    b = (a + (rng.random(1000) < 0.1)) % 5
    table = np.zeros((5, 5))
    np.add.at(table, (a, b), 1)
    p = table / 1000
    pa, pb = p.sum(1), p.sum(0)
    nz = p > 0
    mi = (p[nz] * np.log(p[nz] / np.outer(pa, pb)[nz])).sum()
    h = lambda q: -(q[q > 0] * np.log(q[q > 0])).sum()
    want = mi / math.sqrt(h(pa) * h(pb))
    assert gauss.nmi(torch.tensor(a), torch.tensor(b)) == pytest.approx(
        want, rel=1e-12)
    assert gauss.nmi(torch.tensor(a), torch.tensor(a * 7 + 3)) == \
        pytest.approx(1.0)


def test_noise_is_gumbel_and_bounded():
    rows = torch.arange(200_000)
    s = gumbel.tile_seeds(12345, rows, 512)
    g = gumbel.noise(s, rows % 512, torch.zeros_like(rows), 1)
    assert float(g.max()) <= gumbel.G_MAX
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    assert abs(float(g.var()) - math.pi ** 2 / 6) < 0.02


@pytest.mark.parametrize("precision,rel", [("bfloat16", 2 ** -8),
                                           ("float8", 2 ** -3)])
def test_quantize_rounds_to_the_stated_precision(precision, rel):
    t = torch.tensor(np.random.default_rng(3).standard_normal((100, 5))
                     * 50.0)
    q = gauss.quantize(t, precision).to(torch.float64)
    err = ((q - t).abs() / t.abs().amax(0)).max()
    assert 0 < float(err) <= rel
