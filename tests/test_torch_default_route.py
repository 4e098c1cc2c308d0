"""``ll_precision="default"`` on float32 rows in the port (ROADMAP Queue 3,
P8): the three-pass bf16 split of "high", float32-faithful, for the whole
columns, which draw the label, and the delta columns, which draw the
sub-label.  The JAX package's kernel casts to one bf16 pass only under
"bf16" or for a bf16 cache (``pallas_sweep.py:311-320``); otherwise its dot
is float32-faithful, and in interpret mode on the CPU a float32 product.

Held here, on the CPU: the plain version against
``pallas_sweep.fused_assign(..., ll_precision="default", interpret=True)``
on numpy-seeded inputs for every float32 variant; the mechanism, for a
sub-cluster and for a cluster of duplicate points (coefficients that
cancel to O(1) at their own points, which one bf16 pass gets wrong by tens
to hundreds of nats); and the 2000-corner chain with smart splits, which
the earlier one-pass route left at K=1 for tens of sweeps.  The kernel itself
runs only on a card: tests/test_torch_card_default_route.py."""
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
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402

N, TILE = 512, 256
# float32 sums of the same terms in another order: relative to the sum of
# the terms' magnitudes
SUM_RTOL = 1e-5
# the port's product is the three-pass split, the Pallas kernel's (on the
# CPU) float32: the split leaves out lo * lo and each operand's rest past
# lo, at most 2^-18 of a term each, 1.15e-5 together, and the float32 sums
# add their own rounding (tests/test_torch_ll_precision.py holds the split
# at 2e-5 of its terms' magnitudes), so a label may differ only where the
# float32 top two differ by less than 2e-5 of their two columns' sums of
# |terms|, and a sub-label only where its draw delta + (G_r - G_l) lies
# within 2e-5 of the delta's sum of |terms| of 0 (near ties)
SPLIT_TIE = 2e-5


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


def _pallas(rows_np, variant, valid, phi_mat, log_w, seed, tile_off, hard):
    """Kernel A through the Pallas interpreter under "default"."""
    k = len(log_w)
    out = ps.fused_assign(
        seed, jnp.asarray(rows_np), jnp.asarray(valid.reshape(-1, 128)),
        jnp.asarray(phi_mat), jnp.asarray(log_w), int(hard),
        family_name=variant, k_slots=k, tile=TILE, interpret=True,
        ll_precision="default", stats_precision="highest", tile_off=tile_off)
    return tuple(np.asarray(a) for a in out)


def _draw(seed, tile_off, rows):
    """G_r - G_l of the sub-label's Gumbel pair at global rows ``rows``."""
    g = torch.as_tensor(rows, dtype=torch.int64)
    s = sk.tile_seeds(seed, g, TILE, tile_off) ^ 0xA5A5A5A5
    g2 = sk.gumbel_noise(s, g % TILE, 2).double()
    return (g2[:, 1] - g2[:, 0]).numpy()


@pytest.mark.parametrize("k", [8, 192])
@pytest.mark.parametrize("variant", ["precomputed", "gaussian",
                                     "multinomial"])
def test_plain_default_matches_pallas_default(rng, variant, k):
    """The port's "default" against the Pallas kernel's on the same rows:
    labels, hard and soft (the same noise on both sides), equal but at
    near ties of the whole columns, sub-labels equal wherever the labels
    are but at near ties of their draw, and the statistics at equal labels
    within SUM_RTOL.  K=192 is above one pass of the CUDA kernel's
    columns."""
    x, phi_mat, log_w, valid = _case(rng, variant, k, d=2 if k > 128 and
                                     variant != "multinomial" else None)
    rows_np = (np.asarray(JG.features(jnp.asarray(x)))
               if variant == "precomputed" else x)
    rows = sk.feature_rows(torch.from_numpy(rows_np), variant).double()
    phi = torch.from_numpy(phi_mat).double()
    seed, tile_off = 24680, 5
    tv, tphi, tlw = (torch.from_numpy(a) for a in (valid, phi_mat, log_w))
    for hard in (True, False):
        lj, sj, stj = _pallas(rows_np, variant, valid, phi_mat, log_w, seed,
                              tile_off, hard)
        lj, sj = lj.reshape(-1), sj.reshape(-1)
        lt, st_, _ = (a.numpy() for a in sk.fused_assign(
            torch.from_numpy(rows_np), tv, tphi, tlw, seed, tile_off, hard,
            tile=TILE, family_name=variant, ll_precision="default"))
        diff = np.nonzero(lt != lj)[0]
        if len(diff):
            ll = (rows[diff] @ phi[:, :k]).numpy() + log_w
            if not hard:         # the same label noise on both sides
                g = torch.as_tensor(diff, dtype=torch.int64)
                ll = ll + sk.gumbel_noise(sk.tile_seeds(seed, g, TILE,
                                                        tile_off),
                                          g % TILE, k).double().numpy()
            mag = (rows[diff].abs() @ phi[:, :k].abs()).numpy()
            a, b = lt[diff], lj[diff]
            gap = np.abs(ll[np.arange(len(diff)), a]
                         - ll[np.arange(len(diff)), b])
            bound = SPLIT_TIE * (mag[np.arange(len(diff)), a]
                                 + mag[np.arange(len(diff)), b])
            assert np.all(gap <= bound), (len(diff), (gap - bound).max())
        assert (lt == lj).mean() >= 0.9
        same = np.nonzero(lt == lj)[0]
        flips = same[st_[same] != sj[same]]
        if len(flips):
            col = phi[:, k:].T[torch.from_numpy(lt[flips]).long()]
            delta = (rows[flips] * col).sum(1).numpy()
            scale = (rows[flips].abs() * col.abs()).sum(1).numpy()
            draw = np.abs(delta + _draw(seed, tile_off, flips) + 1e-30)
            assert np.all(draw <= SPLIT_TIE * scale + 1e-6), len(flips)
        # the statistics at equal labels: the port's plain sums at the
        # Pallas kernel's labels against the Pallas kernel's
        stats_rows = sk.feature_rows(torch.from_numpy(rows_np), variant)
        want = sk.stats_from_labels_reference(
            stats_rows, torch.from_numpy(lj.copy()),
            torch.from_numpy(sj.copy()), tv, k).numpy()
        scale = stats_rows[tv].abs().sum(0).numpy()
        f = phi_mat.shape[0]
        assert np.all(np.abs(want - stj[:, :f])
                      <= SUM_RTOL * scale[None, :] + 1e-6)


def test_default_route_by_variant():
    """"default" is the three-pass split on float32 rows and one bf16 pass
    on a bf16 cache; the other settings are themselves everywhere, and the
    plain product takes only those three."""
    for v in ("precomputed", "gaussian", "multinomial"):
        assert sk.ll_route(v, "default") == "high"
    for v in ("bfloat16", "hybrid"):
        assert sk.ll_route(v, "default") == "bf16"
    for v in sk.VARIANTS:
        for p in ("bf16", "high", "highest"):
            assert sk.ll_route(v, p) == p
    with pytest.raises(ValueError, match="ll_precision"):
        sk.ll_route("precomputed", "tf32")
    with pytest.raises(ValueError, match="ll_precision"):
        sk.ll_product(torch.zeros(2, 2), torch.zeros(2, 2), "default")


@pytest.mark.parametrize("variant", ["precomputed", "gaussian",
                                     "multinomial"])
def test_plain_default_is_high_on_float32_rows(rng, variant):
    x, phi_mat, log_w, valid = _case(rng, variant, 8)
    if variant == "precomputed":
        x = np.asarray(JG.features(jnp.asarray(x)))
    args = [torch.from_numpy(np.array(a)) for a in (x, valid, phi_mat, log_w)]
    for hard in (True, False):
        kw = dict(tile=TILE, family_name=variant)
        got = sk.fused_assign(*args, 77, 1, hard, ll_precision="default",
                              **kw)
        want = sk.fused_assign(*args, 77, 1, hard, ll_precision="high", **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _natural(m, lam):
    """phi of N(m, lam^-1) on the Gaussian rows [1, x, triu(x x^T)]."""
    d = len(m)
    iu = np.triu_indices(d)
    quad = np.where(iu[0] == iu[1], -0.5, -1.0) * lam[iu]
    lin = lam @ m
    const = (-0.5 * m @ lin + 0.5 * np.linalg.slogdet(lam)[1]
             - 0.5 * d * np.log(2 * np.pi))
    return np.concatenate([[const], lin, quad])


def test_duplicate_point_sub_cluster_keeps_its_delta():
    """The mechanism of P8.  Cluster 0 holds 500 duplicate points at a =
    (1, 1) (standardized) and its left sub-cluster sits on them with a
    posterior precision of 1e5: its [1, x, x x^T] coefficients are ~1e5 and
    cancel to O(1) at a, and the delta there is set to 0.3.  Against the
    JAX package's float32 delta at those points, the port's "default"
    delta (the three-pass split) is off by at least 100 times less than one
    bf16 pass's (the earlier "default"), and its sub-labels equal the
    Pallas kernel's wherever the two deltas' difference cannot reach the
    draw."""
    n = 1024
    a, b = np.array([0.83, 1.17]), np.array([-1.21, -0.64])
    x = np.zeros((n, 2), np.float32)
    x[:500] = a
    x[500:1000] = b
    x[1000:] = a                      # invalid rows
    valid = np.arange(n) < 1000
    left = _natural(a, 1e5 * np.eye(2))
    right = _natural(a + 0.5, np.eye(2))
    whole = np.stack([_natural(a, 1e5 * np.eye(2)), _natural(b, np.eye(2))],
                     1)
    delta = right - left
    feat_a = np.concatenate([[1.0], a, [a[0] * a[0], a[0] * a[1],
                                        a[1] * a[1]]])
    delta[0] += 0.3 - feat_a @ delta  # the delta at a is 0.3
    phi_mat = np.concatenate([whole, delta[:, None], np.zeros((6, 1))],
                             1).astype(np.float32)
    log_w = np.log([0.5, 0.5]).astype(np.float32)
    rows_np = np.asarray(JG.features(jnp.asarray(x)))
    rows = torch.from_numpy(rows_np)
    tphi = torch.from_numpy(phi_mat)
    dup = slice(0, 500)
    jax_delta = np.asarray(jnp.dot(jnp.asarray(rows_np[dup]),
                                   jnp.asarray(phi_mat[:, 2]),
                                   precision=jax.lax.Precision.HIGHEST))
    port = sk.ll_product(rows[dup], tphi, "high")[:, 2].numpy()
    one_pass = sk.ll_product(rows[dup], tphi, "bf16")[:, 2].numpy()
    err_port = np.abs(port - jax_delta).max()
    err_one = np.abs(one_pass - jax_delta).max()
    assert err_one > 10.0            # hundreds of nats, in fact
    assert err_port * 100 <= err_one, (err_port, err_one)
    seed, tile_off = 97531, 2
    for hard in (True, False):
        lj, sj, _ = _pallas(rows_np, "precomputed", valid, phi_mat, log_w,
                            seed, tile_off, hard)
        lt, st_, _ = sk.fused_assign(
            rows, torch.from_numpy(valid), tphi, torch.from_numpy(log_w),
            seed, tile_off, hard, tile=TILE, ll_precision="default")
        lj, sj = lj.reshape(-1)[dup], sj.reshape(-1)[dup]
        lt, st_ = lt.numpy()[dup], st_.numpy()[dup]
        assert (lt == 0).all() and (lj == 0).all()
        draw = jax_delta + _draw(seed, tile_off, np.arange(500)) + 1e-30
        reach = np.abs(port - jax_delta) + 1e-6
        assert np.array_equal(st_[np.abs(draw) > reach],
                              sj[np.abs(draw) > reach])
        # the draws split the points (the delta is O(1)); one bf16 pass
        # puts every point on one side
        assert 100 < sj.sum() < 400


def test_duplicate_point_cluster_keeps_its_points():
    """The same mechanism in the whole columns.  Cluster 1 sits on 500
    duplicate points at a with a precision of 3e3 and wins there by ~9 nats
    over the broad cluster 0; one bf16 pass of the whole columns puts its
    logit 11 nats low, so every point would go to cluster 0 and cluster 1
    would empty.  "default"'s whole columns (the three-pass split) are off
    by at most 1/100 of that against the JAX package's float32 ones, and
    its hard labels equal the Pallas kernel's (all cluster 1)."""
    n = 512
    a = np.array([0.83, 1.17])
    x = np.tile(a.astype(np.float32), (n, 1))
    valid = np.arange(n) < 500
    whole = np.stack([_natural(np.zeros(2), 0.5 * np.eye(2)),
                      _natural(a, 3e3 * np.eye(2))], 1)
    phi_mat = np.concatenate([whole, np.zeros((6, 2))], 1).astype(np.float32)
    log_w = np.log([0.5, 0.5]).astype(np.float32)
    rows_np = np.asarray(JG.features(jnp.asarray(x)))
    rows = torch.from_numpy(rows_np)
    tphi = torch.from_numpy(phi_mat)
    exact = np.asarray(jnp.dot(jnp.asarray(rows_np), jnp.asarray(phi_mat),
                               precision=jax.lax.Precision.HIGHEST))[:, :2]
    port = sk.ll_product(rows, tphi, "high")[:, :2].numpy()
    one_pass = sk.ll_product(rows, tphi, "bf16")[:, :2].numpy()
    err_port = np.abs(port - exact).max()
    err_one = np.abs(one_pass - exact).max()
    assert err_one > 10.0
    assert err_port * 100 <= err_one, (err_port, err_one)
    args = (torch.from_numpy(valid), tphi, torch.from_numpy(log_w), 4321, 0,
            True)
    lj, _, _ = _pallas(rows_np, "precomputed", valid, phi_mat, log_w, 4321,
                       0, True)
    lt, _, _ = sk.fused_assign(rows, *args, tile=TILE, ll_precision="default")
    assert (lj.reshape(-1) == 1).all() and (lt.numpy() == 1).all()
    lo, _, _ = sk.fused_assign(rows, *args, tile=TILE, ll_precision="bf16")
    assert (lo.numpy() == 0).all()


# seeds at which the earlier "default" (one bf16 pass of whole and delta
# columns, now "bf16") first split the 2000 corner points after sweep 10
# (at sweeps 25, 17, 22, 52 and 49 of 60)
CHAIN_SEEDS = (0, 2, 3, 4, 7)


def _first_split(res):
    return next(i for i, k in enumerate(res.history.k + [2]) if k > 1)


@pytest.mark.parametrize("seed", CHAIN_SEEDS)
def test_corner_chain_with_smart_splits_splits_early(seed):
    """2000 points on the 4 corners, smart splits on (the default), 60
    sweeps, at P8's measurement's config: under "default" the chain leaves
    K=1 by sweep 5 (0-based history index), where the one-pass route of
    the same seed had not by sweep 10."""
    x = np.zeros((2000, 2), np.float32)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 500:(i + 1) * 500] = c
    kw = dict(alpha=100.0, iters=60, seed=seed, burnout=5, verbose=False,
              device="cpu")
    res = tdpmm.fit(x, ll_precision="default", **kw)
    assert _first_split(res) <= 5, res.history.k[:12]
    old = tdpmm.fit(x, ll_precision="bf16", **kw)
    assert _first_split(old) > 10, old.history.k[:12]
