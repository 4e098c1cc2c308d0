"""The reference's input-validation tests (tests/test_validation.py)
mirrored on the port: the same inputs go to ``dpmmsubclusters_tpu`` and to
``dpmmsubclusters_tpu_torch`` (``device="cpu"``), and both must refuse them
alike (the same exception type and message pattern), build the same
preset, and standardize alike (the scale within 1e-4; float32 two-pass
moments in the JAX package, float64 in the port).  The sampled fits are
held to the reference test's gate."""
import torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu.config import DPMMConfig as JConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig as TConfig  # noqa: E402,E501


def _data(n=256, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


def _counts():
    return np.random.default_rng(0).integers(0, 5, size=(128, 4)).astype(
        np.float32)


# the reference's prior checks (tests/test_validation.py:25-53): the data,
# the fit's keywords and the message each must raise
PRIOR_CASES = {
    "typo_key": (_data, dict(prior={"kappa": 1.0, "mu": np.zeros(3),
                                    "nu": 6.0, "psi": np.eye(3)}),
                 "exactly the keys"),
    "wrong_dim": (_data, dict(prior={"kappa": 1.0, "m": np.zeros(4),
                                     "nu": 6.0, "psi": np.eye(4)}), "shape"),
    "improper_nu": (_data, dict(prior={"kappa": 1.0, "m": np.zeros(3),
                                       "nu": 1.0, "psi": np.eye(3)}), "nu"),
    "outlier_prior": (_data, dict(outlier_mod=0.05,
                                  outlier_prior={"kappa": 1.0}),
                      "outlier_prior"),
    "multinomial_shape": (_counts, dict(family="multinomial",
                                        prior={"alpha": np.ones(3)}),
                          "shape"),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_bad_priors_raise_in_both_packages(case):
    make, kw, match = PRIOR_CASES[case]
    with pytest.raises(ValueError, match=match):
        jdpmm.fit(make(), iters=2, verbose=False, **kw)
    with pytest.raises(ValueError, match=match):
        tdpmm.fit(make(), iters=2, verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(alpha=0.0),
    dict(alpha=-1.0),
    dict(iters=0),
    dict(k_max=1),
    dict(burnout=0),
    dict(outlier_mod=1.0),
    dict(outlier_mod=-0.1),
    dict(feature_dtype="float16"),
    dict(ll_precision="fp8"),
    dict(ll_precision="split2"),     # a stats-only mode
    dict(stats_precision="bf16"),    # not a stats mode ("default" is)
    dict(max_clusters=0),
])
def test_config_rejects_bad_values(kw):
    for cls in (JConfig, TConfig):
        with pytest.raises(ValueError, match="DPMMConfig"):
            cls(**kw)


def test_multinomial_smart_splits_raises():
    x = np.random.default_rng(0).integers(0, 5, size=(256, 6)).astype(
        np.float32)
    with pytest.raises(ValueError, match="smart_splits"):
        jdpmm.fit(x, iters=2, verbose=False, family="multinomial",
                  smart_splits=True)
    with pytest.raises(ValueError, match="smart_splits"):
        tdpmm.fit(x, iters=2, verbose=False, family="multinomial",
                  smart_splits=True, device="cpu")
    for cls in (JConfig, TConfig):
        assert cls().resolved_smart_splits("multinomial") is False


def test_reference_verbatim_preset():
    got = TConfig.reference_verbatim(seed=3, iters=7)
    assert got.reference_splittable_gate is True
    assert got.standardize_data is False
    assert got.exact_post_move_stats is True
    assert got.seed == 3 and got.iters == 7
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JConfig.reference_verbatim(seed=3, iters=7))


def test_fit_large_offset_standardization():
    """|mean| >> sd: the two-pass variance keeps the standardization
    effective (scale ~ 1/sd ~ 100, not the clamp value 1), in both
    packages, and the port's scale is the JAX package's within 1e-4."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4096, 2)) * np.array([1e-2, 1e-2])
         + np.array([4096.0, -8192.0])).astype(np.float32)
    res = tdpmm.fit(x, iters=5, seed=0, verbose=False, k_max=8,
                    device="cpu")
    scale = res.model._scale
    assert np.all(scale > 10.0), scale
    ref = jdpmm.fit(x, iters=5, seed=0, verbose=False, k_max=8)
    np.testing.assert_allclose(scale, ref.model._scale, rtol=1e-4)


def test_transposed_layout_and_unknown_fit_kwarg():
    """transposed=True takes the reference's D x N layout (the reference
    test's gate: 600 labels, K=2); a misspelled keyword is a TypeError in
    both packages."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(-6, 1, (300, 2)), rng.normal(6, 1, (300, 2))
    ]).astype(np.float32)
    r = tdpmm.fit(x.T, alpha=10.0, iters=30, seed=0, verbose=False,
                  k_max=8, burnout=3, transposed=True, device="cpu")
    assert len(r.labels) == 600
    assert r.k == 2
    with pytest.raises(TypeError):
        jdpmm.fit(x, alpha=10.0, itres=30)  # typo'd kwarg
    with pytest.raises(TypeError):
        tdpmm.fit(x, alpha=10.0, itres=30, device="cpu")
