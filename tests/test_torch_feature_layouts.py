"""The port's bf16 feature-cache layouts (``feature_dtype`` "bfloat16" and
"hybrid") on the CPU: the stochastically rounded cache build, the plain
kernels A and B over bf16 rows against the JAX package's jnp path and its
Pallas kernels run through the TPU interpreter on the same bf16 rows,
``fit`` with each layout, and ``interop.points_from_jax``.  The CUDA
kernels themselves run only on a card: tests/test_torch_card_feature_layouts.py,
and ``python3 chip_smoke.py`` at the fits' shapes."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu.sampler import assign as JA  # noqa: E402
from dpmmsubclusters_tpu_torch.api import _resolve_precompute  # noqa: E402
from dpmmsubclusters_tpu_torch.interop import points_from_jax  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TM  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler import assign as TA  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler import driver  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.driver import (  # noqa: E402
    DPMMEngine, bf16_features)

# statistics: float32 sums taken in another order (index_add_ against XLA's
# or the interpreter's matmuls); the Pallas kernel's ll product is true bf16
# (phi cast to bf16), the port's is f32 on the upcast rows, so hard labels
# only nearly agree there (tests/test_pallas.py asserts the same 0.98)
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
PALLAS_AGREE = 0.98
N, D, K = 1024, 4, 8


def _bits(t: torch.Tensor) -> np.ndarray:
    """The 32-bit patterns of f32 values (bf16 upcast exactly)."""
    return t.to(torch.float32).numpy().view(np.uint32)


def _case(rng, n=N, d=D, k=K):
    """Raw Gaussian points, their JAX-built bf16 cache (round to nearest,
    padded to 128 columns, as tests/test_pallas.py builds it), NIW natural
    params phi [K, 3, F] drawn by the JAX family, log-weights with one
    inactive slot, sub-cluster log-weights and valid."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    feat_j = JA.pad_features(JG.features(jnp.asarray(x))).astype(jnp.bfloat16)
    post = {
        "kappa": jnp.full((k, 3), 5.0),
        "m": jnp.asarray(rng.standard_normal((k, 3, d)).astype(np.float32)),
        "nu": jnp.full((k, 3), d + 5.0),
        "psi": jnp.broadcast_to(jnp.eye(d), (k, 3, d, d)).astype(jnp.float32),
    }
    phi = np.array(JG.sample_params(jax.random.PRNGKey(1), post,
                                    jnp.ones((k, 3), bool))["phi"])
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    log_lrw = np.log(rng.dirichlet([1.0, 1.0], size=k)).astype(np.float32)
    valid = np.arange(n) < n - 24
    return x, feat_j, phi, log_w, log_lrw, valid


def _container(layout, x, feat_j):
    """The same rows as the JAX container and the port's."""
    if layout == "hybrid":
        jpts = {"feat": feat_j, "raw": jnp.asarray(x)}
        return jpts, points_from_jax({"feat": np.asarray(feat_j), "raw": x})
    return feat_j, points_from_jax(np.asarray(feat_j), TG.feature_dim(D))


def _blk(a):
    return jnp.asarray(np.asarray(a).reshape(-1, 128))


# ---- the cache build -----------------------------------------------------
def _neighbours(f: np.ndarray):
    """(lower, upper) bf16 neighbours of f32 values by magnitude, as f32
    bit patterns (the lower is f truncated to bf16)."""
    lo = f.view(np.uint32) & np.uint32(0xFFFF0000)
    return lo, lo + np.uint32(0x10000)


def _features(rng, n):
    x = (rng.standard_normal((n, D))
         * 10.0 ** rng.uniform(-3, 3, size=(n, D))).astype(np.float32)
    # rows of small integers: every feature (products <= 64) is a bf16
    x[: n // 8] = rng.integers(-8, 9, size=(n // 8, D))
    return torch.from_numpy(x), TG.features(torch.from_numpy(x)).numpy()


def test_stochastic_rounding_stores_a_bf16_neighbour(rng):
    pts, f = _features(rng, 4096)
    got = _bits(bf16_features(TG, pts, seed=3))
    lo, hi = _neighbours(f)
    assert np.all((got == lo) | (got == hi))
    exact = (f.view(np.uint32) & np.uint32(0xFFFF)) == 0
    assert exact[: 4096 // 8].all()           # small integers and products
    np.testing.assert_array_equal(got[exact], f.view(np.uint32)[exact])
    assert (got == hi)[~exact].mean() > 0.3   # both neighbours occur


def test_stochastic_rounding_is_unbiased(rng):
    """The mean signed rounding error, in units of the local bf16 ulp, is
    within 4 sigma of 0 over >= 1e5 rounded values (round to nearest would
    be biased wherever the dropped bits lean one way)."""
    pts, f = _features(rng, 20_000)
    got = bf16_features(TG, pts, seed=11).to(torch.float32).numpy()
    lo, hi = _neighbours(f)
    lo_v = lo.view(np.float32).astype(np.float64)
    ulp = np.abs(hi.view(np.float32).astype(np.float64) - lo_v)
    inexact = (f.view(np.uint32) & np.uint32(0xFFFF)) != 0
    frac = np.abs(f.astype(np.float64) - lo_v)[inexact] / ulp[inexact]
    err = (np.abs(got.astype(np.float64)) - np.abs(f.astype(np.float64)))[
        inexact] / ulp[inexact]
    assert err.size >= 100_000
    sigma = np.sqrt(np.sum(frac * (1.0 - frac))) / err.size
    assert abs(err.mean()) < 4.0 * sigma, (err.mean(), sigma)


@pytest.mark.parametrize("chunk", [1, 333, 4096])
def test_bf16_cache_bits_do_not_depend_on_chunking(rng, monkeypatch, chunk):
    pts = torch.from_numpy(rng.standard_normal((1500, D)).astype(np.float32))
    whole = bf16_features(TG, pts, seed=5)
    monkeypatch.setattr(driver, "FEATURIZE_ROWS", chunk)
    assert torch.equal(bf16_features(TG, pts, seed=5).view(torch.int16),
                       whole.view(torch.int16))
    assert not torch.equal(bf16_features(TG, pts, seed=6).view(torch.int16),
                           whole.view(torch.int16))


def test_featurize_layouts(rng):
    """float32: the f32 cache; bfloat16: the bf16 cache; hybrid: the same
    bf16 cache beside the raw points, held as they are (not copied)."""
    pts = torch.from_numpy(rng.standard_normal((600, D)).astype(np.float32))
    cfg = tdpmm.DPMMConfig(precompute_features=True)
    out = {dt: DPMMEngine(TG, cfg.replace(feature_dtype=dt), "cpu")
           .featurize(pts, seed=9)
           for dt in ("float32", "bfloat16", "hybrid")}
    assert torch.equal(out["float32"], TG.features(pts))
    assert out["bfloat16"].dtype == torch.bfloat16
    assert torch.equal(out["hybrid"]["feat"].view(torch.int16),
                       out["bfloat16"].view(torch.int16))
    assert out["hybrid"]["raw"].data_ptr() == pts.data_ptr()
    assert TA._variant(out["bfloat16"], TG, True) == "bfloat16"
    assert TA._variant(out["hybrid"], TG, True) == "hybrid"
    np.testing.assert_array_equal(
        TA.raw_points(out["bfloat16"], D, True).numpy(),
        out["bfloat16"][:, 1:1 + D].float().numpy())
    assert TA.raw_points(out["hybrid"], D, True) is pts


def test_hybrid_needs_the_gaussian_family():
    counts = np.abs(np.random.default_rng(1).standard_normal((64, 3)))
    with pytest.raises(ValueError, match="gaussian"):
        tdpmm.fit(counts, family="multinomial", precompute_features=True,
                  feature_dtype="hybrid", iters=1, device="cpu")


# ---- plain kernels A and B against the JAX package ------------------------
@pytest.mark.parametrize("layout", ["bfloat16", "hybrid"])
def test_plain_kernel_a_matches_jnp_path(rng, layout):
    """Hard mode on the same bf16 rows: the labels of the JAX jnp path
    (bf16 as storage, f32 arithmetic, as the port); the statistics at the
    port's labels equal JAX ``stats_only`` on the raw points (hybrid) or on
    the bf16 rows (bfloat16)."""
    x, feat_j, phi, log_w, log_lrw, valid = _case(rng)
    jpts, tpts = _container(layout, x, feat_j)
    lj, _, _ = JA.assign_and_stats(
        jax.random.PRNGKey(5), jpts, _blk(valid), jnp.asarray(phi),
        jnp.asarray(log_w), jnp.asarray(log_lrw), jnp.asarray(True), JG, 128,
        x_is_features=True)
    lt, st, stats = TA.assign_and_stats(
        tpts, torch.from_numpy(valid), torch.from_numpy(phi),
        torch.from_numpy(log_w), torch.from_numpy(log_lrw), 77, True,
        tile=256, family=TG, x_is_features=True)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj).reshape(-1))
    assert not (lt.numpy() == K - 1).any()     # inactive slot unused
    if layout == "hybrid":
        want = JA.stats_only(jnp.asarray(x), _blk(valid), _blk(lt), _blk(st),
                             K, JG, 128)
    else:
        want = JA.stats_only(feat_j, _blk(valid), _blk(lt), _blk(st), K, JG,
                             128, x_is_features=True)
    f = TG.feature_dim(D)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want)[..., :f],
                               rtol=STATS_RTOL, atol=STATS_ATOL)


@pytest.mark.parametrize("layout", ["bfloat16", "hybrid"])
def test_plain_kernel_a_near_matches_pallas(rng, layout):
    """The Pallas kernel in interpret mode ("precomputed" on a bf16 cache,
    or "hybrid"), same seed, tile offset and hash tile: hard labels agree
    on >= 98% of the points (its ll is true bf16), and the Pallas
    statistics equal the plain version's at the Pallas labels."""
    x, feat_j, phi, log_w, log_lrw, valid = _case(rng)
    _, tpts = _container(layout, x, feat_j)
    phi_mat = np.asarray(JA._delta_phi(jnp.asarray(phi),
                                       jnp.asarray(log_lrw)))
    f = phi_mat.shape[0]
    phi_pad = np.pad(phi_mat, ((0, feat_j.shape[1] - f), (0, 0)))
    seed, tile_off, tile = 987654, 3, 256
    hybrid = layout == "hybrid"
    lj, sj, stj = ps.fused_assign(
        seed, feat_j, _blk(valid), jnp.asarray(phi_pad), jnp.asarray(log_w),
        1, k_slots=K, family_name="hybrid" if hybrid else "precomputed",
        tile=tile, interpret=True, ll_precision="bf16",
        stats_precision="highest", tile_off=tile_off,
        x_raw=jnp.asarray(x) if hybrid else None)
    feat = tpts["feat"] if hybrid else tpts
    lt, _, _ = sk.fused_assign(
        feat, torch.from_numpy(valid), torch.from_numpy(phi_mat),
        torch.from_numpy(log_w), seed, tile_off, True, tile=tile,
        family_name=layout, x_raw=tpts["raw"] if hybrid else None)
    lj = np.asarray(lj).reshape(-1)
    assert (lt.numpy() == lj).mean() >= PALLAS_AGREE
    lab, sub = (torch.from_numpy(np.asarray(a).reshape(-1).copy())
                for a in (lj, sj))
    if hybrid:
        want = sk.stats_from_labels(tpts["raw"], lab, sub,
                                    torch.from_numpy(valid), K, "gaussian")
    else:
        want = sk.stats_from_labels(feat, lab, sub, torch.from_numpy(valid),
                                    K, "bfloat16")
    np.testing.assert_allclose(np.asarray(stj)[:, :f], want.numpy(),
                               rtol=STATS_RTOL, atol=STATS_ATOL)


def test_plain_kernel_b_bfloat16_matches_jax(rng):
    """Kernel B's plain "bfloat16" version against JAX ``stats_only`` on the
    same bf16 rows: the jnp path and the Pallas kernel in interpret mode."""
    x, feat_j, _, _, _, valid = _case(rng)
    f = TG.feature_dim(D)
    feat = points_from_jax(np.asarray(feat_j), f)
    labels = rng.integers(0, K, size=N).astype(np.int32)
    sub = rng.integers(0, 2, size=N).astype(np.int32)
    got = sk.stats_from_labels(feat, torch.from_numpy(labels),
                               torch.from_numpy(sub),
                               torch.from_numpy(valid), K, "bfloat16")
    blk = [_blk(a) for a in (labels, sub, valid)]
    lr = np.asarray(JA.stats_only(feat_j, blk[2], blk[0], blk[1], K, JG, 512,
                                  x_is_features=True))[..., :f]
    np.testing.assert_allclose(got.numpy(),
                               np.concatenate([lr[:, 0], lr[:, 1]]),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    pal = ps.stats_from_labels(feat_j, *blk, k_slots=K,
                               family_name="precomputed", tile=256,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal)[:, :f],
                               rtol=STATS_RTOL, atol=STATS_ATOL)


def test_plain_bf16_variants_equal_their_f32_twins(rng, monkeypatch):
    """On the CPU, the twin gate of chip_smoke.py: "bfloat16" on the bf16
    cache equals "precomputed" on cache.float() bit for bit, chunk loop
    included; "hybrid" gives the same labels, and its statistics are the
    "gaussian" variant's on the raw points."""
    monkeypatch.setattr(sk, "_PLAIN_ROWS", 256)
    x, feat_j, phi, log_w, log_lrw, valid = _case(rng, n=700)
    phi_mat = TA._delta_phi(torch.from_numpy(phi), torch.from_numpy(log_lrw))
    raw = torch.from_numpy(x)
    cache = bf16_features(TG, raw, seed=2)
    args = (torch.from_numpy(valid), phi_mat, torch.from_numpy(log_w), 13, 1)
    for hard in (True, False):
        twin = sk.fused_assign(cache.float(), *args, hard)
        bf = sk.fused_assign(cache, *args, hard, family_name="bfloat16")
        hy = sk.fused_assign(cache, *args, hard, family_name="hybrid",
                             x_raw=raw)
        for a, b in zip(bf, twin):
            assert torch.equal(a, b)
        assert torch.equal(hy[0], twin[0]) and torch.equal(hy[1], twin[1])
        assert torch.equal(hy[2], sk.stats_from_labels(
            raw, hy[0], hy[1], args[0], K, "gaussian"))
    assert torch.equal(
        sk.stats_from_labels(cache, hy[0], hy[1], args[0], K, "bfloat16"),
        sk.stats_from_labels(cache.float(), hy[0], hy[1], args[0], K))


def test_wrappers_refuse_bad_bf16_calls():
    """x_raw comes with, and only with, "hybrid"; kernel B has no "hybrid"
    variant; a bf16 tensor off the CPU goes to the kernel or raises."""
    lab = torch.zeros(128, dtype=torch.int32)
    valid = torch.ones(128, dtype=torch.bool)
    feat = torch.zeros((128, 15), dtype=torch.bfloat16)
    raw = torch.zeros((128, 4))
    phi, log_w = torch.zeros((15, 8)), torch.zeros(4)
    with pytest.raises(ValueError, match="x_raw"):
        sk.fused_assign(feat, valid, phi, log_w, 1, family_name="hybrid")
    with pytest.raises(ValueError, match="x_raw"):
        sk.fused_assign(feat, valid, phi, log_w, 1, family_name="bfloat16",
                        x_raw=raw)
    with pytest.raises(ValueError, match="family_name"):
        sk.stats_from_labels(feat, lab, lab, valid, 4, "hybrid")
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        sk.fused_assign(torch.empty((128, 15), dtype=torch.bfloat16, **meta),
                        torch.empty(128, dtype=torch.bool, **meta),
                        torch.empty((15, 8), **meta),
                        torch.empty(4, **meta), 1, family_name="hybrid",
                        x_raw=torch.empty((128, 4), **meta))
    with pytest.raises(ValueError, match="expected cuda"):
        sk.stats_from_labels(
            torch.empty((128, 15), dtype=torch.bfloat16, **meta),
            *(torch.empty(128, dtype=dt, **meta)
              for dt in (torch.int32, torch.int32, torch.bool)), 4,
            "bfloat16")


# ---- fit and interop ------------------------------------------------------
def four_corners(n=1000):
    x = np.zeros((n, 2), np.float32)
    gt = np.repeat(np.arange(4), n // 4)
    x[:] = np.array([[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0],
                     [-10.0, -10.0]])[gt]
    return x, gt


@pytest.mark.parametrize("layout", ["bfloat16", "hybrid"])
def test_fit_four_corners_with_each_layout(layout):
    x, gt = four_corners()
    res = tdpmm.fit(x, alpha=100.0, iters=100, seed=12345, verbose=False,
                    device="cpu", feature_dtype=layout)
    assert res.model.cfg.precompute_features is True
    assert res.model.cfg.feature_dtype == layout
    assert res.k == 4 and tdpmm.nmi(gt, res.labels) == 1.0
    pred, _ = res.predict(x)
    np.testing.assert_array_equal(pred, res.labels)


def test_cache_bytes_by_layout_and_no_effect_without_a_cache():
    """The auto cache counts F x 4, F x 2 and F x 2 + D x 4 bytes a point
    (unpadded); 10M x 64-d: 86 GB, 42.9 GB and 45.5 GB.  Without a cache
    ``feature_dtype`` changes nothing."""
    cfg = tdpmm.DPMMConfig(feature_cache_bytes=44 * 10**9)
    on = {dt: _resolve_precompute(TG, cfg.replace(feature_dtype=dt),
                                  10_000_000, 64).precompute_features
          for dt in ("float32", "bfloat16", "hybrid")}
    assert on == {"float32": False, "bfloat16": True, "hybrid": False}
    assert _resolve_precompute(
        TG, cfg.replace(feature_dtype="hybrid",
                        feature_cache_bytes=46 * 10**9),
        10_000_000, 64).precompute_features is True
    assert _resolve_precompute(
        TM, cfg.replace(feature_dtype="bfloat16"), 10, 3
    ).precompute_features is False
    x, _, _, _ = tdpmm.generate_gaussian_data(400, 2, 3, 50.0, seed=3)
    kw = dict(alpha=10.0, iters=10, seed=4, verbose=False, device="cpu",
              precompute_features=False)
    a = tdpmm.fit(x, **kw)
    b = tdpmm.fit(x, feature_dtype="bfloat16", **kw)
    np.testing.assert_array_equal(a.labels, b.labels)


def test_points_from_jax_keeps_bf16_bits_and_drops_padding(rng):
    x, feat_j, _, _, _, _ = _case(rng, n=256)
    f = TG.feature_dim(D)
    want = np.asarray(feat_j.astype(jnp.float32))[:, :f]
    got = points_from_jax(np.asarray(feat_j), f)
    assert got.dtype == torch.bfloat16 and got.shape == (256, f)
    np.testing.assert_array_equal(got.float().numpy(), want)
    hy = points_from_jax({"feat": np.asarray(feat_j), "raw": x})
    assert torch.equal(hy["feat"].view(torch.int16), got.view(torch.int16))
    np.testing.assert_array_equal(hy["raw"].numpy(), x)
    f32 = points_from_jax(np.asarray(JA.pad_features(JG.features(
        jnp.asarray(x)))), f)
    assert f32.dtype == torch.float32 and f32.shape == (256, f)

