"""The port's sweep kernels on the CPU: the plain versions against the Pallas
kernels run through the TPU interpreter on identical inputs, the wrappers'
device dispatch, and the kernel build's failure mode.  The CUDA kernels
themselves run only on a card: tests/test_torch_card_kernels.py and
tests/test_torch_card_stats.py, and ``python3 chip_smoke.py`` at the
flagship shapes."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu.priors import MULTINOMIAL as JM  # noqa: E402
from dpmmsubclusters_tpu.sampler import assign as JA  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import _build  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402

# stats: float32 sums taken in another order (the interpreter's per-tile
# matmuls vs index_add_); labels: exact in hard mode, and in soft mode all
# but rows whose logits tie to within rounding
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
SOFT_AGREE = 0.995


def _raw_case(rng, family="gaussian", n=1024, d=4, k=8):
    """Raw points of a family, a [F, 2K] phi_mat drawn by the JAX family,
    log-weights with one inactive slot, and valid."""
    if family == "gaussian":
        x = rng.standard_normal((n, d)).astype(np.float32)
        fam = JG
        post = {
            "kappa": jnp.full((k, 3), 5.0),
            "m": jnp.asarray(rng.standard_normal((k, 3, d)).astype(np.float32)),
            "nu": jnp.full((k, 3), d + 5.0),
            "psi": jnp.broadcast_to(jnp.eye(d), (k, 3, d, d)).astype(
                jnp.float32),
        }
    else:
        x = rng.multinomial(30, rng.dirichlet(np.ones(d)), size=n).astype(
            np.float32)
        fam = JM
        post = {"alpha": jnp.asarray(
            rng.uniform(0.5, 3.0, size=(k, 3, d)).astype(np.float32))}
    phi = fam.sample_params(jax.random.PRNGKey(1), post,
                            jnp.ones((k, 3), bool))["phi"]
    lrw = rng.dirichlet([1.0, 1.0], size=k).astype(np.float32)
    phi_mat = np.asarray(JA._delta_phi(phi, jnp.log(jnp.asarray(lrw))))
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    log_w = np.log(w).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    valid = np.arange(n) < n - 24
    return x, phi_mat, log_w, valid


def _case(rng, n=1024, d=4, k=8):
    x, phi_mat, log_w, valid = _raw_case(rng, "gaussian", n, d, k)
    return np.asarray(JG.features(jnp.asarray(x))), phi_mat, log_w, valid


def _tt(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_fmix32_bits_match_pallas(rng):
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 2**32 - 1]
    want = np.asarray(ps._fmix32(jnp.asarray(x)))
    got = sk._fmix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_hash_bits_and_gumbel_match_pallas_formula():
    """Tile seeds and counter bits equal the TPU kernel's uint32 formulas
    (pallas_sweep.py:70-87, :299-302) evaluated in JAX."""
    seed, tile, tile_off, width = 2**31 - 5, 128, 7, 8
    rows = np.arange(3 * tile)
    gi = jnp.uint32(tile_off) + jnp.asarray(rows // tile, jnp.uint32)
    s_j = ps._fmix32(jnp.uint32(seed) + gi * jnp.uint32(0x9E3779B9))
    ctr = (jnp.asarray(rows % tile, jnp.uint32)[:, None] * jnp.uint32(width)
           + jnp.arange(width, dtype=jnp.uint32)[None, :])
    bits_j = ps._fmix32(ps._fmix32(ctr + s_j[:, None])
                        ^ (s_j[:, None] * jnp.uint32(0x9E3779B9)))
    rows_t = torch.from_numpy(rows)
    s_t = sk.tile_seeds(seed, rows_t, tile, tile_off)
    np.testing.assert_array_equal(s_t.numpy().astype(np.uint32),
                                  np.asarray(s_j))
    ctr_t = (rows_t % tile)[:, None] * width + torch.arange(width)[None, :]
    bits_t = sk.hash_bits(s_t[:, None], ctr_t)
    np.testing.assert_array_equal(bits_t.numpy().astype(np.uint32),
                                  np.asarray(bits_j))
    u = (np.asarray(bits_j) >> 8).astype(np.float32) * np.float32(2**-24) \
        + np.float32(1e-12)
    g = sk.gumbel_noise(s_t, rows_t % tile, width).numpy()
    np.testing.assert_allclose(g, -np.log(-np.log(u)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hard,tile", [(True, 512), (True, 128),
                                       (False, 512), (False, 128)])
def test_fused_assign_reference_matches_pallas(rng, hard, tile):
    feat, phi_mat, log_w, valid = _case(rng)
    seed, tile_off = 987654, 2
    lj, sj, stj = ps.fused_assign(
        seed, jnp.asarray(feat), jnp.asarray(valid.reshape(-1, 128)),
        jnp.asarray(phi_mat), jnp.asarray(log_w), int(hard),
        k_slots=len(log_w), family_name="precomputed", tile=tile,
        interpret=True, ll_precision="highest", stats_precision="highest",
        tile_off=tile_off)
    lt, st_, stt = sk.fused_assign_reference(
        *_tt(feat, valid, phi_mat, log_w), seed, tile_off, hard, tile=tile)
    lj, sj = np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)
    if hard:
        np.testing.assert_array_equal(lt.numpy(), lj)
    else:
        assert (lt.numpy() == lj).mean() >= SOFT_AGREE
        assert (st_.numpy() == sj).mean() >= SOFT_AGREE
    # [LEFT | RIGHT] statistics (every label agrees at these seeds)
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    assert lt.dtype == torch.int32 and st_.dtype == torch.int32
    assert not (lt.numpy() == len(log_w) - 1).any()  # inactive slot unused


def test_stats_from_labels_reference_matches_pallas_and_jnp(rng):
    feat, _, _, valid = _case(rng)
    k = 8
    labels = rng.integers(0, k, size=len(feat)).astype(np.int32)
    sub = rng.integers(0, 2, size=len(feat)).astype(np.int32)
    got = sk.stats_from_labels_reference(*_tt(feat, labels, sub, valid), k)
    blk = [jnp.asarray(a.reshape(-1, 128)) for a in (labels, sub, valid)]
    want = ps.stats_from_labels(jnp.asarray(feat), *blk, k_slots=k,
                                family_name="precomputed", tile=256,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    # the JAX package's portable path: [K, 2, S] = [left | right] per slot
    lr = JA.stats_only(jnp.asarray(feat), blk[2], blk[0], blk[1], k, JG, 512,
                       x_is_features=True)
    lr = np.asarray(lr)
    np.testing.assert_allclose(
        got.numpy(), np.concatenate([lr[:, 0], lr[:, 1]]),
        rtol=STATS_RTOL, atol=STATS_ATOL)


def test_cpu_wrappers_run_plain_versions_and_count_nothing(rng):
    feat, phi_mat, log_w, valid = _case(rng, n=256)
    args = _tt(feat, valid, phi_mat, log_w)
    a0 = dict(sk.fused_assign.launches)
    b0 = dict(sk.stats_from_labels.launches)
    got = sk.fused_assign(*args, torch.tensor([42], dtype=torch.int32))
    want = sk.fused_assign_reference(*args, 42)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    st = sk.stats_from_labels(args[0], got[0], got[1], args[1], len(log_w))
    assert torch.equal(st, want[2])
    assert (sk.fused_assign.launches, sk.stats_from_labels.launches) == (a0,
                                                                         b0)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the CUDA kernel or raises;
    it never silently takes the plain path."""
    meta = torch.empty((128, 15), device="meta")
    lab = torch.empty(128, dtype=torch.int32, device="meta")
    valid = torch.empty(128, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="expected cuda"):
        sk.stats_from_labels(meta, lab, lab, valid, 4)
    with pytest.raises(ValueError, match="expected cuda"):
        sk.fused_assign(meta, valid, torch.empty((15, 8), device="meta"),
                        torch.empty(4, device="meta"), 1)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.iterdir())   # no partial library left behind


# ---- the raw-point variants ("gaussian", "multinomial") and any K ----------
_D = {"gaussian": 4, "multinomial": 8}


@pytest.mark.parametrize("family,d", [("gaussian", 1), ("gaussian", 5),
                                      ("multinomial", 7)])
def test_feature_pairs_rebuild_family_rows_bit_for_bit(rng, family, d):
    """The kernels' column map, applied as X[a] * X[b] with X = [1, x],
    gives the port's feature rows bit for bit, subnormal products included,
    and the JAX family's rows wherever XLA keeps them (it flushes
    subnormals on the CPU)."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG
    from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TMN

    pairs = sk.feature_pairs(family, d, torch.device("cpu")).long()
    tfam, jfam = (TG, JG) if family == "gaussian" else (TMN, JM)
    for decades in (25, 5):
        x = (rng.standard_normal((64, d))
             * 10.0 ** rng.uniform(-decades, decades, size=(64, d))).astype(
                 np.float32)
        big = torch.cat([torch.ones(64, 1), torch.from_numpy(x)], dim=1)
        built = (big[:, pairs >> 16] * big[:, pairs & 0xFFFF]).numpy()
        want = tfam.features(torch.from_numpy(x)).numpy()
        assert built.shape == want.shape == (64, sk.feature_dim(family, d))
        np.testing.assert_array_equal(built.view(np.uint32),
                                      want.view(np.uint32))
    want = np.asarray(jfam.features(jnp.asarray(x)))
    np.testing.assert_array_equal(built.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("family,hard", [("gaussian", True),
                                         ("gaussian", False),
                                         ("multinomial", True),
                                         ("multinomial", False)])
def test_fused_assign_reference_built_rows_match_pallas(rng, family, hard):
    x, phi_mat, log_w, valid = _raw_case(rng, family, d=_D[family])
    seed, tile_off, tile = 987654, 3, 256
    lj, sj, stj = ps.fused_assign(
        seed, jnp.asarray(x), jnp.asarray(valid.reshape(-1, 128)),
        jnp.asarray(phi_mat), jnp.asarray(log_w), int(hard),
        k_slots=len(log_w), family_name=family, tile=tile, interpret=True,
        ll_precision="highest", stats_precision="highest", tile_off=tile_off)
    lt, st_, stt = sk.fused_assign_reference(
        *_tt(x, valid, phi_mat, log_w), seed, tile_off, hard, tile=tile,
        family_name=family)
    lj, sj = np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)
    if hard:
        np.testing.assert_array_equal(lt.numpy(), lj)
    else:
        assert (lt.numpy() == lj).mean() >= SOFT_AGREE
        assert (st_.numpy() == sj).mean() >= SOFT_AGREE
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    assert stt.shape == (2 * len(log_w), sk.feature_dim(family, x.shape[1]))


@pytest.mark.parametrize("family", ["gaussian", "multinomial"])
def test_stats_from_labels_reference_built_rows_match_pallas_and_jnp(
        rng, family):
    x, _, _, valid = _raw_case(rng, family, d=_D[family])
    k = 8
    labels = rng.integers(0, k, size=len(x)).astype(np.int32)
    sub = rng.integers(0, 2, size=len(x)).astype(np.int32)
    got = sk.stats_from_labels_reference(*_tt(x, labels, sub, valid), k,
                                         family)
    blk = [jnp.asarray(a.reshape(-1, 128)) for a in (labels, sub, valid)]
    want = ps.stats_from_labels(jnp.asarray(x), *blk, k_slots=k,
                                family_name=family, tile=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    jfam = JG if family == "gaussian" else JM
    lr = np.asarray(JA.stats_only(jnp.asarray(x), blk[2], blk[0], blk[1], k,
                                  jfam, 512, x_is_features=False))
    np.testing.assert_allclose(
        got.numpy(), np.concatenate([lr[:, 0], lr[:, 1]]),
        rtol=STATS_RTOL, atol=STATS_ATOL)


def test_plain_gaussian_rows_equal_plain_cache_rows(rng, monkeypatch):
    """The plain "gaussian" variant on x equals the plain "precomputed" one
    on GaussianFamily.features(x), chunk loop included."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG

    monkeypatch.setattr(sk, "_PLAIN_ROWS", 256)
    x, phi_mat, log_w, valid = _raw_case(rng, "gaussian", n=700)
    x, valid, phi_mat, log_w = _tt(x, valid, phi_mat, log_w)
    feat = TG.features(x)
    for hard in (True, False):
        built = sk.fused_assign_reference(x, valid, phi_mat, log_w, 11, 1,
                                          hard, family_name="gaussian")
        cache = sk.fused_assign_reference(feat, valid, phi_mat, log_w, 11, 1,
                                          hard)
        for b, c in zip(built, cache):
            assert torch.equal(b, c)
    labels, sub = built[0], built[1]
    assert torch.equal(
        sk.stats_from_labels(x, labels, sub, valid, 8, "gaussian"),
        sk.stats_from_labels(feat, labels, sub, valid, 8))


def test_fused_assign_reference_matches_pallas_at_k256(rng):
    """Above 128 slots (the one-pass width of the CUDA kernel A) the plain
    version still gives the Pallas kernel's labels."""
    feat, phi_mat, log_w, valid = _case(rng, n=512, d=2, k=256)
    seed = 4242
    for hard in (True, False):
        lj, sj, stj = ps.fused_assign(
            seed, jnp.asarray(feat), jnp.asarray(valid.reshape(-1, 128)),
            jnp.asarray(phi_mat), jnp.asarray(log_w), int(hard), k_slots=256,
            family_name="precomputed", tile=512, interpret=True,
            ll_precision="highest", stats_precision="highest")
        lt, st_, stt = sk.fused_assign_reference(
            *_tt(feat, valid, phi_mat, log_w), seed, 0, hard)
        lj, sj = np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)
        if hard:
            np.testing.assert_array_equal(lt.numpy(), lj)
        else:
            assert (lt.numpy() == lj).mean() >= SOFT_AGREE
            assert (st_.numpy() == sj).mean() >= SOFT_AGREE
        np.testing.assert_allclose(stt.numpy(), np.asarray(stj),
                                   rtol=STATS_RTOL, atol=STATS_ATOL)
    assert len(np.unique(lt.numpy())) > 128     # columns past one pass won


def test_wrappers_refuse_unknown_variants():
    meta = torch.empty((128, 4), device="meta")
    lab = torch.empty(128, dtype=torch.int32, device="meta")
    valid = torch.empty(128, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="family_name"):
        sk.stats_from_labels(meta, lab, lab, valid, 4, "bogus")
    with pytest.raises(ValueError, match="expected cuda"):
        sk.fused_assign(meta, valid, torch.empty((15, 8), device="meta"),
                        torch.empty(4, device="meta"), 1,
                        family_name="gaussian")


@pytest.mark.parametrize("k", [1, 8, 129])
def test_delta_rows_are_phis_delta_columns(rng, k):
    """The exact kernel's delta operand: row j of the contiguous [K, F] copy
    is phi_mat's delta column K + j, at every K."""
    phi = torch.from_numpy(rng.standard_normal((37, 2 * k)).astype(
        np.float32))
    rows = sk.delta_rows(phi, k)
    assert rows.shape == (k, 37) and rows.is_contiguous()
    for j in range(k):
        assert torch.equal(rows[j], phi[:, k + j])


def test_fit_block_size_takes_every_variant_and_precision(rng):
    """The fits' block (FIT_CTA_POINTS, the default) is accepted in every
    variant and at every ll_precision; the study's other sizes only for the
    f32 cache at K <= 128 under "highest"."""
    feat, phi_mat, log_w, valid = _case(rng, n=256, d=2, k=8)
    args = _tt(feat, valid, phi_mat, log_w)
    assert sk.FIT_CTA_POINTS in sk.CTA_POINTS
    for prec in sk.LL_PRECISIONS:
        want = sk.fused_assign(*args, 5, ll_precision=prec)
        got = sk.fused_assign(*args, 5, ll_precision=prec,
                              cta_points=sk.FIT_CTA_POINTS)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    wide = _case(rng, n=256, d=2, k=129)
    for cta in sk.CTA_POINTS:
        if cta == sk.FIT_CTA_POINTS:
            continue
        with pytest.raises(ValueError, match="cta_points"):
            sk.fused_assign(*_tt(*wide), 5, cta_points=cta)
        with pytest.raises(ValueError, match="cta_points"):
            sk.fused_assign(*args, 5, cta_points=cta, ll_precision="high")
