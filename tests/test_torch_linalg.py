"""The PyTorch port's framework-free pieces and ``ops/linalg.py`` against
the JAX package: config, generators, metrics, special functions, masked
Cholesky, triangular solves, and the samplers' moments."""
import torch_threads  # noqa: F401

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dpmmsubclusters_tpu import config as jcfg  # noqa: E402
from dpmmsubclusters_tpu.ops import linalg as jl  # noqa: E402
from dpmmsubclusters_tpu.utils import generators as jgen  # noqa: E402
from dpmmsubclusters_tpu.utils import metrics as jmet  # noqa: E402
from dpmmsubclusters_tpu_torch import config as tcfg  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import linalg as tl  # noqa: E402
from dpmmsubclusters_tpu_torch.utils import generators as tgen  # noqa: E402
from dpmmsubclusters_tpu_torch.utils import metrics as tmet  # noqa: E402

# deterministic float32 table math: both sides round differently in the
# last bits (LAPACK vs XLA factorizations, fused vs separate ops)
RTOL, ATOL = 1e-5, 1e-4


def test_port_imports_no_jax():
    code = ("import sys, dpmmsubclusters_tpu_torch; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("kw", [
    {},
    {"alpha": 2.5, "k_max": 128, "burnout": 5, "merge_candidates": 128,
     "precompute_features": True, "seed": 7, "max_clusters": 30},
    "reference_verbatim",
])
def test_config_asdict_matches(kw):
    if kw == "reference_verbatim":
        a = jcfg.DPMMConfig.reference_verbatim(seed=3)
        b = tcfg.DPMMConfig.reference_verbatim(seed=3)
    else:
        a, b = jcfg.DPMMConfig(**kw), tcfg.DPMMConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.resolved_auto_tier() == b.resolved_auto_tier()
    assert (a.resolved_smart_splits("gaussian")
            == b.resolved_smart_splits("gaussian"))


@pytest.mark.parametrize("kw", [{"alpha": 0.0}, {"k_max": 1},
                                {"feature_dtype": "f16"},
                                {"stats_precision": "low"}])
def test_config_rejects_like_jax(kw):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.DPMMConfig(**kw)


def test_generators_and_metrics_match():
    a = jgen.generate_gaussian_data(500, 3, 4, 50.0, seed=2)
    b = tgen.generate_gaussian_data(500, 3, 4, 50.0, seed=2)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    rng = np.random.default_rng(0)
    p, q = rng.integers(0, 5, 300), rng.integers(0, 4, 300)
    assert tmet.nmi(p, q) == jmet.nmi(p, q)
    assert tmet.varinfo(p, q) == jmet.varinfo(p, q)


def test_log_multivariate_gamma_matches_jax():
    a = np.linspace(2.6, 400.0, 11).astype(np.float32)
    for d in (1, 3, 5):
        got = tl.log_multivariate_gamma(torch.from_numpy(a), d).numpy()
        want = np.asarray(jl.log_multivariate_gamma(jnp.asarray(a), d))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _spd(rng, batch, d):
    a = rng.standard_normal(batch + (d, d)).astype(np.float32)
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d, dtype=np.float32)


def test_masked_cholesky_and_logdet_match_jax(rng):
    mats = _spd(rng, (6,), 4)
    mats[2] = -np.eye(4, dtype=np.float32)   # not PD, but masked out
    mask = np.array([True, True, False, True, False, True])
    got = tl.masked_cholesky(torch.from_numpy(mats), torch.from_numpy(mask))
    want = jl.masked_cholesky(jnp.asarray(mats), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ld = tl.chol_logdet(got).numpy()
    np.testing.assert_allclose(ld, np.asarray(jl.chol_logdet(want)),
                               rtol=RTOL, atol=ATOL)
    assert ld[2] == 0.0 and ld[4] == 0.0   # masked slots contribute 0


@pytest.mark.parametrize("trans", [False, True])
def test_tri_solve_matches_jax(rng, trans):
    l = np.linalg.cholesky(_spd(rng, (3,), 5)).astype(np.float32)
    b = rng.standard_normal((3, 5, 2)).astype(np.float32)
    got = tl._batched_tri_solve(torch.from_numpy(l), torch.from_numpy(b),
                                trans=trans).numpy()
    want = np.asarray(jl._batched_tri_solve(jnp.asarray(l), jnp.asarray(b),
                                            trans=trans))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_wishart_precision_sampler_moments():
    """E[P] for P ~ Wishart(nu, (nu*Psi)^-1) is Psi^-1 (same check as
    tests/test_priors.py), batched over 4000 draws."""
    a = np.array([[2.0, 0.3, 0.0], [0.3, 1.5, 0.2], [0.0, 0.2, 1.0]],
                 np.float32)
    psi = torch.from_numpy(a).expand(4000, 3, 3)
    gen = torch.Generator().manual_seed(0)
    prec, _, lds = tl.sample_wishart_precision(
        gen, torch.tensor(12.0), psi, torch.ones(4000, dtype=torch.bool))
    np.testing.assert_allclose(prec.mean(0).numpy(), np.linalg.inv(a),
                               rtol=0.1, atol=0.02)
    # third output is log|Sigma| = -log|P|
    np.testing.assert_allclose(
        lds[:5].numpy(), -np.linalg.slogdet(prec[:5].numpy())[1], rtol=1e-3)


def test_dirichlet_sampler_mean():
    alpha = torch.tensor([1.0, 4.0, 10.0, 0.0]).expand(3000, 4)
    w = tl.sample_dirichlet(torch.Generator().manual_seed(2), alpha)
    mean = w.mean(0).numpy()
    np.testing.assert_allclose(mean[:3], np.array([1, 4, 10]) / 15.0,
                               atol=0.02)
    assert mean[3] == 0.0   # alpha <= 0 gets weight exactly 0
