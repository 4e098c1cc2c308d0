"""``ll_precision`` in the port, on the CPU: the plain version of kernel A
under each setting against the Pallas kernel run through the TPU interpreter
on identical inputs, for every variant and above and below one pass of the
CUDA kernel's columns; the 4-corner fit under each setting; and
that the config's value reaches the kernel's wrapper.  The tensor-core
kernel itself runs only on a card: tests/test_torch_card_ll_precision.py,
and ``python3 chip_smoke.py`` at the fits' shapes under both settings."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu.priors import MULTINOMIAL as JM  # noqa: E402
from dpmmsubclusters_tpu.sampler import assign as JA  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.interop import points_from_jax  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG  # noqa: E402

VARIANTS = ("precomputed", "gaussian", "multinomial", "hybrid", "bfloat16")
N, TILE = 512, 256
# a hard label may differ only where the plain logits' top two tie to within
# this much: both sides round rows and phi to bf16 alike and take exact
# products, so only the order of the float32 sums differs
TIE_RTOL = 1e-4
# float32 sums of the same terms in another order: relative to the sum of
# the terms' magnitudes
SUM_RTOL = 1e-5


def _case(rng, variant, k, d=None):
    """Raw points of the variant's family, phi_mat [F, 2K] drawn by the JAX
    family, log-weights with one inactive slot, valid."""
    multinomial = variant == "multinomial"
    d = d or (8 if multinomial else 4)
    if multinomial:
        x = rng.multinomial(30, rng.dirichlet(np.ones(d)), size=N).astype(
            np.float32)
        fam = JM
        post = {"alpha": jnp.asarray(
            rng.uniform(0.5, 3.0, size=(k, 3, d)).astype(np.float32))}
    else:
        x = rng.standard_normal((N, d)).astype(np.float32)
        fam = JG
        post = {
            "kappa": jnp.full((k, 3), 5.0),
            "m": jnp.asarray(rng.standard_normal((k, 3, d)).astype(np.float32)),
            "nu": jnp.full((k, 3), d + 5.0),
            "psi": jnp.broadcast_to(jnp.eye(d), (k, 3, d, d)).astype(
                jnp.float32),
        }
    phi = fam.sample_params(jax.random.PRNGKey(1), post,
                            jnp.ones((k, 3), bool))["phi"]
    lrw = rng.dirichlet([1.0, 1.0], size=k).astype(np.float32)
    phi_mat = np.array(JA._delta_phi(phi, jnp.log(jnp.asarray(lrw))))
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    valid = np.arange(N) < N - 24
    return x, phi_mat, log_w, valid


def _both(variant, x, phi_mat, log_w, valid, seed, tile_off, hard,
          ll_precision):
    """Kernel A through the Pallas interpreter and through the port's plain
    version on the same rows.  Returns ``(jax labels, jax sub, jax stats),
    (port labels, sub, stats), rows, stats_rows``: the f32 rows the port's ll
    product sees and the rows its statistics sum (both torch)."""
    k = len(log_w)
    kw = dict(k_slots=k, tile=TILE, interpret=True,
              ll_precision=ll_precision, stats_precision="highest",
              tile_off=tile_off)
    args = (jnp.asarray(valid.reshape(-1, 128)),)
    tv, tphi, tlw = (torch.from_numpy(a) for a in (valid, phi_mat, log_w))
    f = phi_mat.shape[0]
    if variant in ("hybrid", "bfloat16"):
        # the JAX container: a bf16 cache padded to 128 columns (round to
        # nearest, as tests/test_pallas.py builds it), phi padded alike
        feat_j = JA.pad_features(JG.features(jnp.asarray(x))).astype(
            jnp.bfloat16)
        phi_j = jnp.asarray(np.pad(phi_mat, ((0, feat_j.shape[1] - f),
                                             (0, 0))))
        hybrid = variant == "hybrid"
        out_j = ps.fused_assign(
            seed, feat_j, *args, phi_j, jnp.asarray(log_w), int(hard),
            family_name="hybrid" if hybrid else "precomputed",
            x_raw=jnp.asarray(x) if hybrid else None, **kw)
        cache = points_from_jax(np.asarray(feat_j), f)
        out_t = sk.fused_assign_reference(
            cache, tv, tphi, tlw, seed, tile_off, hard, tile=TILE,
            family_name=variant,
            x_raw=torch.from_numpy(x) if hybrid else None,
            ll_precision=ll_precision)
        rows = cache.float()
        stats_rows = TG.features(torch.from_numpy(x)) if hybrid else rows
    else:
        rows_np = (np.asarray(JG.features(jnp.asarray(x)))
                   if variant == "precomputed" else x)
        out_j = ps.fused_assign(
            seed, jnp.asarray(rows_np), *args, jnp.asarray(phi_mat),
            jnp.asarray(log_w), int(hard), family_name=variant, **kw)
        out_t = sk.fused_assign_reference(
            torch.from_numpy(rows_np), tv, tphi, tlw, seed, tile_off, hard,
            tile=TILE, family_name=variant, ll_precision=ll_precision)
        rows = stats_rows = sk.feature_rows(torch.from_numpy(rows_np),
                                            variant)
    lj, sj, stj = (np.asarray(a) for a in out_j)
    return ((lj.reshape(-1), sj.reshape(-1), stj[:, :f]), out_t, rows,
            stats_rows)


def _assert_labels_equal_but_ties(lt, lj, rows, phi_mat, log_w,
                                  ll_precision):
    diff = np.nonzero(lt != lj)[0]
    if not len(diff):
        return
    k = len(log_w)
    ll = sk.ll_product(rows[diff], torch.from_numpy(phi_mat[:, :k]),
                       ll_precision).numpy() + log_w
    top2 = -np.sort(-ll, axis=-1)[:, :2]
    gap = top2[:, 0] - top2[:, 1]
    assert np.all(gap <= TIE_RTOL * np.maximum(1.0, np.abs(top2[:, 0]))), (
        len(diff), gap.max())


def _assert_sums_close(got, want, rows, valid):
    scale = rows[torch.from_numpy(valid)].abs().sum(0).numpy()
    assert np.all(np.abs(got - want) <= SUM_RTOL * scale[None, :] + 1e-6)


@pytest.mark.parametrize("k", [8, 192])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_one_bf16_pass_matches_pallas(rng, variant, k):
    """Under "bf16" (one bf16 pass of whole and delta columns, the Pallas
    kernel's cast; also "default" on a bf16 cache) the plain version
    rounds rows and phi as the Pallas kernel's cast does: hard labels equal
    except where the top two logits tie, soft labels and sub-labels agree
    >= 0.999 where the labels do, and the statistics agree at equal labels.
    K=192 is above one pass (128 whole columns) of the CUDA kernel."""
    x, phi_mat, log_w, valid = _case(rng, variant, k, d=2 if k > 128 and
                                     variant != "multinomial" else None)
    seed, tile_off = 24680, 5
    for hard in (True, False):
        (lj, sj, stj), (lt, st_, _), rows, stats_rows = _both(
            variant, x, phi_mat, log_w, valid, seed, tile_off, hard, "bf16")
        lt, st_ = lt.numpy(), st_.numpy()
        if hard:
            _assert_labels_equal_but_ties(lt, lj, rows, phi_mat, log_w,
                                          "bf16")
        else:
            assert (lt == lj).mean() >= 0.999
        same = lt == lj
        assert (st_[same] == sj[same]).mean() >= 0.999
        assert not (lt == k - 1).any()            # the inactive slot
        # the statistics at equal labels: the port's plain sums at the
        # Pallas kernel's labels against the Pallas kernel's
        want = sk.stats_from_labels_reference(
            stats_rows, torch.from_numpy(lj.copy()),
            torch.from_numpy(sj.copy()), torch.from_numpy(valid), k)
        _assert_sums_close(want.numpy(), stj, stats_rows, valid)


def test_default_is_the_bf16_pass_and_rounds_to_nearest_even(rng):
    """"bf16" is one bf16 pass: its operands are rounded to bf16 to
    nearest, ties to even, and the sums are float32.  ("default" is that
    pass only on a bf16 cache, and the three-pass split on float32 rows:
    tests/test_torch_default_route.py.)"""
    rows = torch.from_numpy(
        (rng.standard_normal((64, 37)) * 10.0 ** rng.uniform(
            -3, 3, size=(64, 37))).astype(np.float32))
    phi = torch.from_numpy(rng.standard_normal((37, 10)).astype(np.float32))
    # exact ties: 1 + 2^-8 lies midway between bf16 neighbours 1 and
    # 1 + 2^-7 (rounds down to even), 1 + 3 * 2^-8 up to 1 + 2^-6
    rows[0, :2] = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])

    def rne(a):
        b = a.numpy().view(np.uint32).astype(np.uint64)
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        return torch.from_numpy(b.astype(np.uint32).view(np.float32))

    got = sk.ll_product(rows, phi, "bf16")
    assert rne(rows)[0, 0] == 1.0 and rne(rows)[0, 1] == 1.0 + 2.0 ** -6
    assert torch.equal(got, rne(rows) @ rne(phi))
    assert got.dtype == torch.float32
    assert not torch.equal(got, sk.ll_product(rows, phi, "highest"))


@pytest.mark.parametrize("variant", ["precomputed", "gaussian"])
def test_plain_high_matches_jax_high(rng, variant):
    """"high" is the float32-faithful three-pass split: rows and phi each a
    bf16 hi plus a bf16 lo, and hi @ hi + hi @ lo + lo @ hi.  Against JAX's
    product at Precision.HIGH (exact float32 on the CPU, the kernel's dot at
    pallas_sweep.py:322) ll agrees at rtol 2e-5 of its terms' magnitudes:
    the split leaves out lo * lo and each operand's rest past lo, at most
    2^-18 of a term each, 1.15e-5 together, and the float32 sums add their
    own rounding.  Kernel A's hard labels under "high" equal the Pallas
    kernel's except at ties."""
    x, phi_mat, log_w, valid = _case(rng, variant, 8)
    rows = sk.feature_rows(torch.from_numpy(
        np.asarray(JG.features(jnp.asarray(x))) if variant == "precomputed"
        else x), variant)
    tphi = torch.from_numpy(phi_mat)
    got = sk.ll_product(rows, tphi, "high").numpy()
    want = np.asarray(jnp.dot(jnp.asarray(rows.numpy()), jnp.asarray(phi_mat),
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGH))
    scale = (rows.abs() @ tphi.abs()).numpy()
    assert np.all(np.abs(got - want) <= 2e-5 * scale)
    # the three products, written out
    r_hi, p_hi = rows.bfloat16().float(), tphi.bfloat16().float()
    r_lo, p_lo = ((rows - r_hi).bfloat16().float(),
                  (tphi - p_hi).bfloat16().float())
    three = (r_hi @ p_lo + r_lo @ p_hi) + r_hi @ p_hi
    assert np.array_equal(got, three.numpy())
    # far closer to the exact product than one bf16 pass
    exact = (rows.double() @ tphi.double()).numpy()
    one = sk.ll_product(rows, tphi, "bf16").numpy()
    assert np.abs(got - exact).max() < 0.01 * np.abs(one - exact).max()
    (lj, _, _), (lt, _, _), rows2, _ = _both(
        variant, x, phi_mat, log_w, valid, 1357, 0, True, "high")
    _assert_labels_equal_but_ties(lt.numpy(), lj, rows2, phi_mat, log_w,
                                  "high")


def test_highest_is_unchanged_and_the_functions_default(rng):
    """ll_precision="highest" is the exact float32 product, bit for bit
    what the plain version and the wrapper compute when the argument is
    left out."""
    x, phi_mat, log_w, valid = _case(rng, "gaussian", 8)
    args = [torch.from_numpy(a) for a in (x, valid, phi_mat, log_w)]
    rows = TG.features(args[0])
    assert torch.equal(sk.ll_product(rows, args[2], "highest"),
                       rows @ args[2])
    assert torch.equal(sk.ll_product(rows, args[2]), rows @ args[2])
    for hard in (True, False):
        kw = dict(tile=TILE, family_name="gaussian")
        want = sk.fused_assign_reference(*args, 99, 1, hard, **kw)
        for got in (sk.fused_assign_reference(*args, 99, 1, hard,
                                              ll_precision="highest", **kw),
                    sk.fused_assign(*args, 99, 1, hard, **kw),
                    sk.fused_assign(*args, 99, 1, hard,
                                    ll_precision="highest", **kw)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_bf16_cache_rounds_phi_only_under_default(rng):
    """A bf16 cache's rows are bf16 already: under "default" the plain
    "bfloat16" variant takes one bf16 pass of whole and delta columns, so
    it equals "precomputed" on cache.float() under "bf16" bit for bit (phi
    rounded in both; "default" on float32 rows is the three-pass split), and
    under "highest" phi stays float32."""
    x, phi_mat, log_w, valid = _case(rng, "gaussian", 8)
    cache = TG.features(torch.from_numpy(x)).bfloat16()
    tv, tphi, tlw = (torch.from_numpy(a) for a in (valid, phi_mat, log_w))
    for prec, twin_prec in (("default", "bf16"), ("highest", "highest")):
        assert sk.ll_route("bfloat16", prec) == twin_prec
        got = sk.fused_assign(cache, tv, tphi, tlw, 5, 0, True,
                              family_name="bfloat16", ll_precision=prec)
        twin = sk.fused_assign(cache.float(), tv, tphi, tlw, 5, 0, True,
                               ll_precision=twin_prec)
        for g, w in zip(got, twin):
            assert torch.equal(g, w)
    assert torch.equal(sk.ll_product(cache.float(), tphi, "bf16"),
                       cache.float() @ tphi.bfloat16().float())
    assert torch.equal(sk.ll_product(cache.float(), tphi, "highest"),
                       cache.float() @ tphi)


def _corners():
    x = np.zeros((1000, 2), np.float32)
    gt = np.zeros(1000, np.int64)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 250:(i + 1) * 250] = c
        gt[i * 250:(i + 1) * 250] = i
    return x, gt


@pytest.mark.parametrize("ll_precision", ["default", "high", "highest"])
def test_fit_four_corners_under_each_precision(ll_precision):
    x, gt = _corners()
    res = tdpmm.fit(x, alpha=100.0, iters=100, seed=12345, burnout=5,
                    verbose=False, device="cpu", ll_precision=ll_precision)
    assert res.model.cfg.ll_precision == ll_precision
    assert res.k == 4 and tdpmm.nmi(gt, res.labels) == 1.0
    pred, _ = res.predict(x)
    assert np.array_equal(pred, res.labels)


@pytest.mark.parametrize("given,want", [({}, "default"),
                                        ({"ll_precision": "bf16"}, "bf16"),
                                        ({"ll_precision": "high"}, "high"),
                                        ({"ll_precision": "highest"},
                                         "highest")])
def test_config_ll_precision_reaches_the_wrapper(monkeypatch, given, want):
    """Every sweep hands ``cfg.ll_precision`` to kernel A's wrapper; the
    config's default is "default"."""
    seen = []
    real = sk.fused_assign

    def spy(*args, **kw):
        seen.append(kw.get("ll_precision"))
        return real(*args, **kw)

    monkeypatch.setattr(sk, "fused_assign", spy)
    x, _ = _corners()
    res = tdpmm.fit(x, alpha=100.0, iters=6, seed=1, burnout=2,
                    verbose=False, device="cpu", **given)
    assert DPMMConfig().ll_precision == "default"
    assert res.model.cfg.ll_precision == want
    assert len(seen) == 6 and set(seen) == {want}


def test_wrapper_refuses_unknown_precisions_and_study_blocks_off_f32():
    meta = dict(device="meta")
    x = torch.empty((128, 15), **meta)
    valid = torch.empty(128, dtype=torch.bool, **meta)
    phi, log_w = torch.empty((15, 8), **meta), torch.empty(4, **meta)
    with pytest.raises(ValueError, match="ll_precision"):
        sk.fused_assign(x, valid, phi, log_w, 1, ll_precision="float64")
    with pytest.raises(ValueError, match="ll_precision"):
        sk.ll_product(torch.zeros(2, 2), torch.zeros(2, 2), "tf32")
    # the tile study's other block sizes belong to the exact kernel
    with pytest.raises(ValueError, match="cta_points"):
        sk.fused_assign(x, valid, phi, log_w, 1, cta_points=256,
                        ll_precision="default")
    # a tensor off the CPU goes to the kernel at every precision, or raises
    for prec in sk.LL_PRECISIONS:
        with pytest.raises(ValueError, match="expected cuda"):
            sk.fused_assign(x, valid, phi, log_w, 1, ll_precision=prec)
    with pytest.raises(ValueError, match="ll_precision"):
        DPMMConfig(ll_precision="tf32")


def test_cpu_wrapper_counts_no_tensor_core_launch(rng):
    x, phi_mat, log_w, valid = _case(rng, "gaussian", 8)
    before = dict(sk.fused_assign.tensor_core_launches)
    before_ring = dict(sk.fused_assign.ring_launches)
    sk.fused_assign(*(torch.from_numpy(a) for a in (x, valid, phi_mat, log_w)),
                    3, family_name="gaussian", ll_precision="default")
    assert sk.fused_assign.tensor_core_launches == before
    assert sk.fused_assign.ring_launches == before_ring
    sk.reset_launches()
    assert set(sk.fused_assign.tensor_core_launches) == set(sk.VARIANTS)
    assert not any(sk.fused_assign.tensor_core_launches.values())
    assert set(sk.fused_assign.ring_launches) == set(sk.VARIANTS)
    assert not any(sk.fused_assign.ring_launches.values())
