"""The reference's merge-rule, padding, outlier and NIW closed-form tests
mirrored on the port, each with the reference test's own inputs and gate:

* ``tests/test_golden_mh.py::test_forced_final_merge_rule``,
  ``::test_forced_merge_tail_at_scale``,
  ``::test_screened_merge_matches_full_on_decisive_pairs`` and
  ``::test_padding_invariance`` (NIW split ratios at ``k_max`` 4 and 16);
* ``tests/test_moves.py::test_outlier_params_frozen_vs_resampled``;
* ``tests/test_priors.py::test_niw_marginal_likelihood_1d_analytic``.

Two references hold the port.  The oracle is the reference test's own
float64 NumPy/SciPy code (the NIW posterior and log-marginal of
src/priors/niw.jl, the split and merge ratios of
src/local_clusters_actions.jl and src/shared_actions.jl), repeated here so
that nothing of either package computes it.  Beside it the JAX package
runs on the same tables: its split and merge ratios, and its accepted
merges where they do not depend on the draws (a forced or decisive pair
decides alike for every uniform; the port draws from ``torch.Generator``,
the JAX package from its keys), and which slots its parameter step
redraws.  None of these inputs reaches a known reference-side fault
(ROADMAP R1 is a resume below the live K; R7 the float32 history window,
which these tables never fill), so the JAX package passes the same
inputs.
"""
import torch_threads  # noqa: F401

import math

import numpy as np
import pytest
from scipy.special import gammaln, multigammaln

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from dpmmsubclusters_tpu.config import DPMMConfig as JConfig  # noqa: E402
from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu.sampler import moves as jmoves  # noqa: E402
from dpmmsubclusters_tpu.sampler import table as jtable  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler import moves  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.table import (  # noqa: E402
    compute_posteriors, init_table, side_tile)

# the port against the JAX package on the same float32 tables: the same
# formulas with their float32 sums in other orders
JAX_RTOL, JAX_ATOL = 1e-5, 1e-4

PRIOR = dict(kappa=1.0, m=np.array([0.0, 0.0]), nu=5.0, psi=np.eye(2))
# three fixed clusters of literal points (D = 2), test_golden_mh.py's
POINTS = {
    0: np.array([[1.0, 2.0], [1.5, 1.0], [0.5, 0.25], [2.0, -1.0],
                 [1.25, 0.75]]),
    1: np.array([[-3.0, 4.0], [-2.5, 3.5], [-3.5, 4.25], [-2.75, 5.0]]),
    2: np.array([[20.0, -20.0], [21.0, -19.0], [19.5, -20.5], [20.5, -19.25],
                 [20.0, -21.0], [19.0, -19.5]]),
}
ALPHA = 10.0


def _halves(points):
    """Each cluster's fixed left/right partition (first half left)."""
    return {k: (v[: len(v) // 2], v[len(v) // 2:]) for k, v in points.items()}


# ---- the float64 oracle (test_golden_mh.py's) -------------------------------
def _stats(pts):
    return float(len(pts)), pts.sum(axis=0), pts.T @ pts


def _posterior_f64(n, sx, sxx):
    k0, m0, nu0, psi0 = (PRIOR["kappa"], PRIOR["m"], PRIOR["nu"],
                         PRIOR["psi"])
    kappa = k0 + n
    nu = nu0 + n
    m = (k0 * m0 + sx) / kappa
    psi = (nu0 * psi0 + k0 * np.outer(m0, m0) - kappa * np.outer(m, m)
           + sxx) / nu
    return kappa, m, nu, 0.5 * (psi + psi.T)


def _log_marginal_f64(n, sx, sxx):
    """src/priors/niw.jl:53-62 in float64."""
    d = 2
    k0, nu0, psi0 = PRIOR["kappa"], PRIOR["nu"], PRIOR["psi"]
    kappa1, _, nu1, psi1 = _posterior_f64(n, sx, sxx)
    return (
        -n * d * 0.5 * math.log(math.pi)
        + multigammaln(nu1 / 2.0, d)
        - multigammaln(nu0 / 2.0, d)
        + (nu0 / 2.0) * (d * math.log(nu0) + np.linalg.slogdet(psi0)[1])
        - (nu1 / 2.0) * (d * math.log(nu1) + np.linalg.slogdet(psi1)[1])
        + (d / 2.0) * math.log(k0 / kappa1)
    )


def _split_log_hr_f64(whole, left, right):
    """src/local_clusters_actions.jl:318-343 in float64."""
    nl, sxl, sxxl = _stats(left)
    nr, sxr, sxxr = _stats(right)
    n, sx, sxx = _stats(whole)
    return (
        math.log(ALPHA)
        + gammaln(nl) + _log_marginal_f64(nl, sxl, sxxl)
        + gammaln(nr) + _log_marginal_f64(nr, sxr, sxxr)
        - gammaln(n) - _log_marginal_f64(n, sx, sxx)
    )


def _merge_log_hr_f64(pts_i, pts_j):
    ni, sxi, sxxi = _stats(pts_i)
    nj, sxj, sxxj = _stats(pts_j)
    nm = ni + nj
    a = ALPHA
    return (
        -math.log(a) + gammaln(a) - 2.0 * gammaln(a / 2.0)
        + gammaln(nm) - gammaln(nm + a)
        + gammaln(ni + a / 2.0) - gammaln(ni)
        + gammaln(nj + a / 2.0) - gammaln(nj)
        + _log_marginal_f64(nm, sxi + sxj, sxxi + sxxj)
        - _log_marginal_f64(ni, sxi, sxxi)
        - _log_marginal_f64(nj, sxj, sxxj)
    )


# ---- the tables (test_golden_mh.py's _make_table), the port's and JAX's ----
def _flat_stats(k_max: int, points):
    """Whole, left and right statistics a slot of ``points``, flat, with
    junk in a padding slot above k_max 4 (masking must keep it out of every
    result)."""
    d = 2
    flat = np.zeros((k_max, 3, GAUSSIAN.stat_dim(d)), np.float32)
    for slot, pts in points.items():
        left, right = _halves(points)[slot]
        for side, p in ((0, pts), (1, left), (2, right)):
            n, sx, sxx = _stats(p)
            flat[slot, side] = np.concatenate(
                [[n], sx, sxx[np.triu_indices(d)]])
    if k_max > 4:
        flat[k_max - 1] = 1e6
    return flat


def _make_table(k_max: int, points=POINTS):
    """The port's padded table of ``points``."""
    d = 2
    prior = GAUSSIAN.tile_prior(
        GAUSSIAN.make_prior(PRIOR["kappa"], PRIOR["m"], PRIOR["nu"],
                            PRIOR["psi"]), (k_max,))
    prior = GAUSSIAN.augment_prior(prior)
    flat = _flat_stats(k_max, points)
    active = torch.zeros(k_max, dtype=torch.bool)
    active[list(points)] = True
    table = {
        "active": active,
        "is_outlier": torch.zeros(k_max, dtype=torch.bool),
        "prior": prior,
        "stats": GAUSSIAN.stats_from_flat(torch.from_numpy(flat), d),
        "post": None,
        "params": None,
        "lr_weights": torch.full((k_max, 2), 0.5),
        "log_weights": torch.where(active, 0.0, float("-inf")),
        "hist": torch.full((k_max, 5), float("-inf")),
        "splittable": active.clone(),
        "needs_smart": torch.zeros(k_max, dtype=torch.bool),
    }
    return compute_posteriors(GAUSSIAN, table)


def _jax_table(k_max: int, points=POINTS):
    """The JAX package's table of the same statistics, as
    test_golden_mh.py builds it."""
    d = 2
    prior = JG.augment_prior(JG.tile_prior(
        {k: jnp.asarray(v, jnp.float32) for k, v in PRIOR.items()},
        (k_max,)))
    active = np.zeros(k_max, bool)
    active[list(points)] = True
    table = {
        "active": jnp.asarray(active),
        "is_outlier": jnp.zeros(k_max, bool),
        "prior": prior,
        "stats": JG.stats_from_flat(jnp.asarray(_flat_stats(k_max, points)),
                                    d),
        "post": None,
        "params": None,
        "lr_weights": jnp.full((k_max, 2), 0.5, jnp.float32),
        "log_weights": jnp.where(jnp.asarray(active), 0.0, -jnp.inf),
        "hist": jnp.full((k_max, 5), -jnp.inf, jnp.float32),
        "splittable": jnp.asarray(active),
    }
    return jtable.compute_posteriors(JG, table)


def _lm3(table):
    k = table["active"].shape[0]
    mask3 = table["active"][:, None].expand(k, 3)
    return GAUSSIAN.log_marginal(side_tile(table["prior"]), table["post"],
                                 table["stats"], mask3)


def _jax_lm3(table):
    k = table["active"].shape[0]
    mask3 = jnp.broadcast_to(table["active"][:, None], (k, 3))
    return JG.log_marginal(jtable.side_tile(table["prior"]), table["post"],
                           table["stats"], mask3)


def _merge_log_hr(table):
    """The port's merge log_HR of every pair: its pairwise marginals and
    merge_log_hastings, as _merge_pairs_full takes them."""
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    eligible = table["active"]
    lm_m = GAUSSIAN.log_marginal_pairwise(table["prior"], stats_w, eligible)
    n_w = stats_w["n"]
    lm_w = torch.where(eligible, _lm3(table)[:, 0], 0.0)
    return moves.merge_log_hastings(ALPHA, n_w[:, None], n_w[None, :],
                                    lm_w[:, None], lm_w[None, :],
                                    lm_m).numpy()


def _jax_merge_log_hr(table):
    stats_w = jax.tree.map(lambda a: a[:, 0], table["stats"])
    eligible = table["active"]
    lm_m = JG.log_marginal_pairwise(table["prior"], stats_w, eligible)
    n_w = stats_w["n"]
    lm_w = jnp.where(eligible, _jax_lm3(table)[:, 0], 0.0)
    return np.asarray(jmoves.merge_log_hastings(
        ALPHA, n_w[:, None], n_w[None, :], lm_w[:, None], lm_w[None, :],
        lm_m))


def _gen(seed: int):
    return torch.Generator().manual_seed(seed)


def _merge_accept_matrix(table, seed, final):
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    eligible = table["active"]
    lm_w = torch.where(eligible, _lm3(table)[:, 0], 0.0)
    return moves._merge_pairs_full(_gen(seed), table, GAUSSIAN, eligible,
                                   lm_w, stats_w["n"], ALPHA,
                                   final).numpy()


def _jax_merge_accept(table, seed, final, screened=None):
    """The JAX package's accepted pairs on its table under key ``seed``:
    the full scan, or with ``screened = (m_cand, dim)`` the top-M screen."""
    stats_w = jax.tree.map(lambda a: a[:, 0], table["stats"])
    eligible = table["active"]
    lm_w = jnp.where(eligible, _jax_lm3(table)[:, 0], 0.0)
    args = (jax.random.PRNGKey(seed), table, JG, eligible, lm_w,
            stats_w["n"], ALPHA, jnp.asarray(final))
    if screened is None:
        return np.asarray(jmoves._merge_pairs_full(*args))
    return np.asarray(jmoves._merge_pairs_screened(*args, *screened))


# ---- the mirrors ------------------------------------------------------------
def test_padding_invariance():
    """Identical NIW split ratios at k_max=4 and k_max=16 with a
    junk-filled padding slot (test_golden_mh.py:211)."""
    t4, t16 = _make_table(4), _make_table(16)
    hr4 = moves.split_log_hastings(ALPHA, t4["stats"]["n"], _lm3(t4)).numpy()
    hr16 = moves.split_log_hastings(ALPHA, t16["stats"]["n"],
                                    _lm3(t16)).numpy()
    slots = list(POINTS)
    assert np.isfinite(hr4[slots]).all()
    np.testing.assert_allclose(hr4[slots], hr16[slots], rtol=1e-6)
    # and the values themselves: the float64 oracle, with the reference's
    # gate (test_golden_mh.py::test_split_log_hr_matches_f64)
    for slot in slots:
        want = _split_log_hr_f64(POINTS[slot], *_halves(POINTS)[slot])
        np.testing.assert_allclose(hr16[slot], want, rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("k_max", [4, 16])
def test_split_and_merge_log_hr_match_jax_and_f64(k_max):
    """The split ratio of every slot and the merge ratio of every active
    pair on the padded table: the port equals the JAX package on the same
    table (within JAX_RTOL / JAX_ATOL) and the float64 oracle (the
    reference's gate, rtol 1e-4 / atol 5e-3)."""
    t, jt = _make_table(k_max), _jax_table(k_max)
    slots = sorted(POINTS)
    split = moves.split_log_hastings(ALPHA, t["stats"]["n"], _lm3(t)).numpy()
    jsplit = np.asarray(jmoves.split_log_hastings(ALPHA, jt["stats"]["n"],
                                                  _jax_lm3(jt)))
    np.testing.assert_allclose(split[slots], jsplit[slots], rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    merge, jmerge = _merge_log_hr(t), _jax_merge_log_hr(jt)
    for a, i in enumerate(slots):
        want = _split_log_hr_f64(POINTS[i], *_halves(POINTS)[i])
        np.testing.assert_allclose(split[i], want, rtol=1e-4, atol=5e-3)
        for j in slots[a + 1:]:
            np.testing.assert_allclose(merge[i, j], jmerge[i, j],
                                       rtol=JAX_RTOL, atol=JAX_ATOL)
            np.testing.assert_allclose(
                merge[i, j], _merge_log_hr_f64(POINTS[i], POINTS[j]),
                rtol=1e-4, atol=5e-3)


def test_forced_final_merge_rule():
    """final && log_HR > log(0.1) forces the merge regardless of the uniform
    draw (src/shared_actions.jl:35); a decisively negative log_HR stays
    rejected even when final (test_golden_mh.py:235)."""
    base = np.random.default_rng(7).standard_normal((40, 2)) * 0.3

    def table_at(t):
        pts = {0: base[:20], 1: base[20:] + np.array([t, 0.0])}
        return _make_table(4, pts), _merge_log_hr_f64(pts[0], pts[1])

    t_forced = t_reject = None
    for t in np.linspace(0.0, 12.0, 121):
        _, hr = table_at(float(t))
        if t_forced is None and math.log(0.1) + 0.2 < hr < -0.2:
            t_forced = float(t)
        if t_reject is None and hr < -30.0:
            t_reject = float(t)
    assert t_forced is not None and t_reject is not None

    tab_f, hr_f = table_at(t_forced)
    tab_r, hr_r = table_at(t_reject)
    for s in range(20):
        assert _merge_accept_matrix(tab_f, s, final=True)[0, 1], (s, hr_f)
        assert not _merge_accept_matrix(tab_r, s, final=True).any(), (s,
                                                                      hr_r)
    # the JAX package on the same two tables decides alike: the forced pair
    # merges for every key, the decisive one never
    for t in (t_forced, t_reject):
        pts = {0: base[:20], 1: base[20:] + np.array([t, 0.0])}
        jt = _jax_table(4, pts)
        want = _merge_accept_matrix(table_at(t)[0], 0, final=True)
        for s in range(5):
            np.testing.assert_array_equal(
                _jax_merge_accept(jt, s, True), want)
    # not final: the same pair, inside (log 0.1, 0), must sometimes reject
    rejected = sum(not _merge_accept_matrix(tab_f, 1000 + s,
                                            final=False)[0, 1]
                   for s in range(40))
    assert rejected > 0, hr_f


def test_screened_merge_matches_full_on_decisive_pairs():
    """The top-M screened path reaches the full scan's decisions when every
    log_HR is decisive (test_golden_mh.py:288)."""
    table = _make_table(16)
    hr01 = _merge_log_hr_f64(POINTS[0], POINTS[1])
    hr02 = _merge_log_hr_f64(POINTS[0], POINTS[2])
    hr12 = _merge_log_hr_f64(POINTS[1], POINTS[2])
    # decisive = acceptance probability < ~1e-6 over the 10 seeds below
    assert hr02 < -13 and hr12 < -13, (hr02, hr12)
    k = 16
    mask3 = table["active"][:, None].expand(k, 3)
    table = {**table, "params": GAUSSIAN.sample_params(_gen(0),
                                                       table["post"], mask3)}
    stats_w = {name: a[:, 0] for name, a in table["stats"].items()}
    eligible = table["active"]
    lm_w = torch.where(eligible, _lm3(table)[:, 0], 0.0)
    jt = _jax_table(16)
    jt = {**jt, "params": JG.sample_params(
        jax.random.PRNGKey(0), jt["post"],
        jnp.broadcast_to(jt["active"][:, None], (k, 3)))}
    decisive = (slice(None),) if abs(hr01) > 5 else ((0, 1), (2, 2))
    for s in range(10):
        full = moves._merge_pairs_full(_gen(s), table, GAUSSIAN, eligible,
                                       lm_w, stats_w["n"], ALPHA,
                                       False).numpy()
        scr = moves._merge_pairs_screened(_gen(s), table, GAUSSIAN, eligible,
                                          lm_w, stats_w["n"], ALPHA, False,
                                          8, 2).numpy()
        # decisive pairs agree; pair (0, 1) may differ only if borderline
        np.testing.assert_array_equal(full[decisive], scr[decisive])
        # and equal the JAX package's full and screened scans there
        jfull = _jax_merge_accept(jt, s, False)
        jscr = _jax_merge_accept(jt, s, False, screened=(8, 2))
        np.testing.assert_array_equal(full[decisive], jfull[decisive])
        np.testing.assert_array_equal(scr[decisive], jscr[decisive])


def test_forced_merge_tail_at_scale():
    """50 clusters as 25 near-duplicate pairs: on a final sweep exactly the
    pairs whose float64 log_HR clears log 0.1 merge, each onto its smaller
    slot (test_golden_mh.py:323)."""
    rng = np.random.default_rng(11)
    d, k_pairs, per = 2, 25, 30
    k_max = 64
    centers = rng.uniform(-200, 200, (k_pairs, d))
    t = 0.4
    pts = {}
    for p in range(k_pairs):
        pts[2 * p] = rng.standard_normal((per, d)) * 0.3 + centers[p]
        pts[2 * p + 1] = (rng.standard_normal((per, d)) * 0.3 + centers[p]
                          + np.array([t, 0.0]))

    def lm64(points):
        return _log_marginal_f64(*_stats(points))

    forced = []
    for p in range(k_pairs):
        a_, b_ = pts[2 * p], pts[2 * p + 1]
        log_hr = (
            -math.log(ALPHA)
            + gammaln(ALPHA) - 2 * gammaln(ALPHA / 2)
            + gammaln(2.0 * per) - gammaln(2.0 * per + ALPHA)
            + 2 * (gammaln(per + ALPHA / 2) - gammaln(float(per)))
            + lm64(np.concatenate([a_, b_])) - lm64(a_) - lm64(b_)
        )
        # construction guard: decisively on one side of the forced window
        assert abs(log_hr - math.log(0.1)) > 0.5
        forced.append(log_hr > math.log(0.1))
    n_forced = sum(forced)
    assert n_forced >= 20   # fixture sanity: most pairs are near-duplicates

    cfg = DPMMConfig(k_max=k_max, burnout=4)
    prior = GAUSSIAN.make_prior(1.0, np.zeros(d), 5.0, np.eye(d))
    table = init_table(GAUSSIAN, prior, None, cfg, d)
    n_arr = np.zeros((k_max, 3), np.float32)
    sx = np.zeros((k_max, 3, d), np.float32)
    sxx = np.zeros((k_max, 3, d, d), np.float32)
    lab_list = []
    for i in range(2 * k_pairs):
        P = pts[i]
        h = len(P) // 2
        for side, Q in ((0, P), (1, P[:h]), (2, P[h:])):
            n_arr[i, side], sx[i, side], sxx[i, side] = _stats(Q)
        lab_list += [i] * len(P)
    active = torch.arange(k_max) < 2 * k_pairs
    stats = {"n": torch.from_numpy(n_arr), "sum_x": torch.from_numpy(sx),
             "sum_xx": torch.from_numpy(sxx)}
    table = compute_posteriors(GAUSSIAN, {**table, "active": active,
                                          "stats": stats})
    table = {**table, "splittable": active.clone()}
    table = moves.sample_params_step(_gen(3), table, ALPHA, 0.0, GAUSSIAN)

    labels = torch.tensor(lab_list, dtype=torch.int32)
    sublabels = torch.zeros_like(labels)
    t2, l2, _ = moves.merge_move(_gen(5), table, labels, sublabels, ALPHA,
                                 True, GAUSSIAN, lm_w=_lm3(table)[:, 0])
    k_after = int(t2["active"].sum())
    assert k_after == 2 * k_pairs - n_forced, (k_after, n_forced)
    # every forced pair collapsed onto its smaller slot id; others intact
    l2 = l2.numpy()
    for p in range(k_pairs):
        got = set(np.unique(l2[labels.numpy() // 2 == p]).tolist())
        assert got == ({2 * p} if forced[p] else {2 * p, 2 * p + 1}), (p,
                                                                        got)


def _table_with_counts(counts_lr, d=2, k_max=8, jax_too=False):
    """tests/test_moves.py's fixture: slot i has left/right sub-cluster
    counts counts_lr[i] and matching synthetic Gaussian statistics; with
    ``jax_too`` also the JAX package's table of the same statistics."""
    cfg = DPMMConfig(k_max=k_max, burnout=4)
    table = init_table(GAUSSIAN, GAUSSIAN.default_prior(d), None, cfg, d)
    rng = np.random.default_rng(0)
    n = np.zeros((k_max, 3), np.float32)
    sx = np.zeros((k_max, 3, d), np.float32)
    sxx = np.zeros((k_max, 3, d, d), np.float32)
    for i, (nl, nr) in enumerate(counts_lr):
        for side, cnt, center in ((1, nl, -2.0), (2, nr, 2.0)):
            if cnt == 0:
                continue
            pts = (rng.normal(size=(cnt, d)) + center + 3 * i).astype(
                np.float32)
            n[i, side], sx[i, side], sxx[i, side] = cnt, pts.sum(0), \
                pts.T @ pts
        n[i, 0], sx[i, 0], sxx[i, 0] = n[i, 1:].sum(), sx[i, 1:].sum(0), \
            sxx[i, 1:].sum(0)
    active = torch.arange(k_max) < len(counts_lr)
    stats = {"n": torch.from_numpy(n), "sum_x": torch.from_numpy(sx),
             "sum_xx": torch.from_numpy(sxx)}
    out = compute_posteriors(GAUSSIAN, {**table, "active": active,
                                        "stats": stats})
    if not jax_too:
        return out
    jt = jtable.init_table(JG, JG.default_prior(d), None,
                           JConfig(k_max=k_max, burnout=4), d)
    jstats = {"n": jnp.asarray(n), "sum_x": jnp.asarray(sx),
              "sum_xx": jnp.asarray(sxx)}
    jt = jtable.compute_posteriors(JG, {**jt, "active": jnp.asarray(
        active.numpy()), "stats": jstats})
    return out, jt


def test_outlier_params_frozen_vs_resampled():
    """By default the outlier slot's distribution is redrawn like any other
    slot; ``freeze_outlier`` (resample_outlier_params=False) keeps the
    previous draw, as the reference's sample_clusters! skips slot 1
    (tests/test_moves.py:247)."""
    table, jt = _table_with_counts([(40, 40), (25, 25)], jax_too=True)
    table = {**table, "is_outlier": torch.tensor([True] + [False] * 7)}
    table = moves.sample_params_step(_gen(7), table, 10.0, 0.05, GAUSSIAN)
    phi0 = table["params"]["phi"].numpy()

    frozen = moves.sample_params_step(_gen(8), table, 10.0, 0.05, GAUSSIAN,
                                      freeze_outlier=True)
    phi_f = frozen["params"]["phi"].numpy()
    np.testing.assert_array_equal(phi_f[0], phi0[0])     # outlier frozen
    assert not np.allclose(phi_f[1], phi0[1])            # real slot redrawn

    live = moves.sample_params_step(_gen(8), table, 10.0, 0.05, GAUSSIAN,
                                    freeze_outlier=False)
    assert not np.allclose(live["params"]["phi"].numpy()[0], phi0[0])

    # the JAX package on the same statistics keeps and redraws the same
    # slots, active and padding alike
    jt = {**jt, "is_outlier": jnp.asarray([True] + [False] * 7)}
    jt = jmoves.sample_params_step(jax.random.PRNGKey(7), jt, 10.0, 0.05, JG)
    jphi0 = np.asarray(jt["params"]["phi"])

    def kept(new, old):
        return [bool(np.array_equal(new[i], old[i])) for i in range(8)]

    for freeze, got in ((True, phi_f), (False, live["params"]["phi"].numpy())):
        want = np.asarray(jmoves.sample_params_step(
            jax.random.PRNGKey(8), jt, 10.0, 0.05, JG,
            freeze_outlier=freeze)["params"]["phi"])
        assert kept(got, phi0) == kept(want, jphi0), freeze


def test_niw_marginal_likelihood_1d_analytic(rng):
    """At D=1 the NIW marginal has a closed form written independently:
    the normal-inverse-chi-square marginal, with the reference's IW scale
    nu * psi (tests/test_priors.py:65)."""
    x = rng.normal(size=(20, 1)).astype(np.float32)
    kappa, m, nu, psi = 2.0, 0.3, 5.0, 1.7
    prior = GAUSSIAN.make_prior(kappa, [m], nu, [[psi]])
    stats = {"n": torch.tensor(20.0), "sum_x": torch.from_numpy(x.sum(0)),
             "sum_xx": torch.from_numpy(x.T @ x)}
    post = GAUSSIAN.calc_posterior(prior, stats)
    got = float(GAUSSIAN.log_marginal(prior, post, stats, torch.tensor(True)))
    n = 20.0
    Psi0 = nu * psi
    kp, nup = kappa + n, nu + n
    mp = (kappa * m + x.sum()) / kp
    Psip = Psi0 + kappa * m**2 - kp * mp**2 + float((x.T @ x)[0, 0])
    want = (
        -n / 2 * np.log(np.pi)
        + gammaln(nup / 2)
        - gammaln(nu / 2)
        + (nu / 2) * np.log(Psi0)
        - (nup / 2) * np.log(Psip)
        + 0.5 * np.log(kappa / kp)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4)
