"""The bf16 feature cache's layout: rows a multiple of 8 values apart
(16 bytes, the row pitch the card's copy engine takes), zeros past F, its
first F columns the cache.  ``bf16_features`` builds it so,
``pad_bf16_rows`` and ``points_from_jax`` copy a cache into it, and the
plain kernels A and B give the same bits on it as on the unpadded cache;
the auto cache's budget counts the padded rows."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from dpmmsubclusters_tpu_torch.interop import points_from_jax  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.driver import (  # noqa: E402
    bf16_features, stochastic_bf16)

SEED = 5


def _points(n, d, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, d)).astype(
            np.float32))


def _padding(cache):
    """The whole rows under a cache view: ``[N, row pitch]``."""
    ld = cache.stride(0)
    return torch.as_strided(cache, (cache.shape[0], ld), (ld, 1))


@pytest.mark.parametrize("d", [2, 5, 32])
def test_bf16_features_layout(d):
    """F = 6, 21, 561: the rows lie bf16_row_stride(F) values apart on
    16-byte boundaries, the first F columns are the unpadded cache bit for
    bit, the rest zeros."""
    x = _points(300, d)
    f = GAUSSIAN.feature_dim(d)
    cache = bf16_features(GAUSSIAN, x, SEED, row0=7)
    ld = sk.bf16_row_stride(f)
    assert ld % 8 == 0 and f <= ld < f + 8
    assert cache.shape == (300, f) and cache.stride() == (ld, 1)
    assert cache.data_ptr() % 16 == 0
    want = stochastic_bf16(GAUSSIAN.features(x), SEED, 7)
    assert torch.equal(cache.view(torch.int16), want.view(torch.int16))
    whole = _padding(cache)
    assert not whole[:, f:].view(torch.int16).any()


def test_pad_bf16_rows_copies_any_layout():
    """A contiguous unpadded cache and a view off a 16-byte boundary both
    come out in the port's layout with the same values."""
    x = _points(50, 4)
    cache = stochastic_bf16(GAUSSIAN.features(x), SEED)          # [50, 15]
    wide = torch.zeros((50, 18), dtype=torch.bfloat16)
    wide[:, 1:16] = cache
    for src in (cache, wide[:, 1:16]):
        out = sk.pad_bf16_rows(src)
        assert out.stride() == (16, 1) and out.data_ptr() % 16 == 0
        assert torch.equal(out.view(torch.int16), src.view(torch.int16))
        assert not _padding(out)[:, 15:].view(torch.int16).any()


@pytest.mark.parametrize("variant", ["bfloat16", "hybrid"])
@pytest.mark.parametrize("ll_precision", ["default", "high", "highest"])
def test_plain_kernels_same_on_padded_and_unpadded(variant, ll_precision):
    """Kernel A's and kernel B's plain versions give identical labels,
    sub-labels and statistics on the padded cache and on the same values
    unpadded."""
    rng = np.random.default_rng(1)
    n, d, k = 700, 6, 12
    x = _points(n, d, 1)
    padded = bf16_features(GAUSSIAN, x, SEED)
    unpadded = stochastic_bf16(GAUSSIAN.features(x), SEED)
    assert unpadded.is_contiguous() and padded.stride(0) != unpadded.stride(0)
    f = padded.shape[1]
    phi = torch.from_numpy(
        (rng.standard_normal((f, 2 * k)) / np.sqrt(f)).astype(np.float32))
    log_w = torch.log(torch.full((k,), 1.0 / k))
    valid = torch.arange(n) < n - 9
    kw = dict(family_name=variant, ll_precision=ll_precision,
              x_raw=x if variant == "hybrid" else None)
    for hard in (True, False):
        a = sk.fused_assign(padded, valid, phi, log_w, SEED, 0, hard, **kw)
        b = sk.fused_assign(unpadded, valid, phi, log_w, SEED, 0, hard, **kw)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    labels, sub = a[0], a[1]
    if variant == "bfloat16":
        assert torch.equal(
            sk.stats_from_labels(padded, labels, sub, valid, k, "bfloat16"),
            sk.stats_from_labels(unpadded, labels, sub, valid, k,
                                 "bfloat16"))


def test_points_from_jax_pads_a_bf16_cache():
    """A JAX bf16 cache (padded to 128 columns) arrives as the port's: its
    first F columns, rows bf16_row_stride(F) apart, same bits; the hybrid
    dict's too."""
    x = np.random.default_rng(2).standard_normal((40, 130)).astype(
        np.float32)
    jcache = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16))
    got = points_from_jax(jcache, f=21)
    assert got.shape == (40, 21) and got.stride() == (24, 1)
    want = torch.from_numpy(np.array(jcache).view(np.int16)[:, :21])
    assert torch.equal(got.view(torch.int16), want)
    hyb = points_from_jax({"feat": jcache, "raw": x[:, :5]})
    assert hyb["feat"].shape == (40, 21) and hyb["feat"].stride(0) == 24


@pytest.mark.parametrize("dt,per_point", [("float32", 4 * 2145),
                                          ("bfloat16", 2 * 2152),
                                          ("hybrid", 2 * 2152 + 4 * 64)])
def test_cache_budget_counts_padded_rows(dt, per_point):
    """The auto cache's budget counts the bf16 rows at their padded pitch
    (F = 2145 at D = 64: 2152 values a row), the f32 cache unpadded."""
    from dpmmsubclusters_tpu_torch.api import _cache_row_bytes
    from dpmmsubclusters_tpu_torch.config import DPMMConfig

    cfg = DPMMConfig(feature_dtype=dt)
    assert _cache_row_bytes(GAUSSIAN, cfg, 64) == per_point
