"""The geometry of kernel A's tensor-core pass on the card, one bf16 pass
("bf16", ``csrc/fused_assign_tc.cuh``) and the three-pass split ("high";
at a pass width of 256 ``csrc/fused_assign_tc_ring.cuh``), against the
plain version: ragged N (N mod 128 in {1, 64, 127}) with odd
counts of 128-point tiles, so that the partner block of a cluster walks
an empty tile, and enough tiles that every block takes several; K at each
edge of a pass's width (16, 17, 32, 33, 64, 65, 128, 129, 256); F not a
multiple of 64 (101, 561, 2145, 2556) with Gaussian rows built from the
points staged in shared memory (D = 32, 64) and read from device memory
(D = 70 beside two stages of the two-plane ring at N = 256).  Labels
equal but at near ties of the whole columns' logits (with the label
noise, soft), sub-labels equal wherever the labels are but at near ties
of their draw, two launches equal.  One bf16 pass over a bf16 cache at a
pass width of 256 (``csrc/fused_assign_tc_tma.cuh``, its rows copied by
a tensor map) the same way, with its launch count: K in {65, 128, 129,
256} by F in {561, 2145, 2556}, ragged N with odd tile counts, rows
holding NaN, a cache view off a 16-byte boundary, "hybrid", two launches
bit for bit.  Both designs at a pass width of 256 run only the passes up
to the highest live column: a table width of 256 whose slots past a live
prefix of 1, 64, 127, 128, 129 or 255 are inactive, whose only live slot
past 127 is 200, or with no live slot, gives the plain version's labels
and counts the passes it ran (one or two) in the pass tally.

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG

SEED, TILE_OFF, TILE = 7, 3, 512
# a hard label may differ only where the top two whole-column logits (both
# sides round alike, float32 sums in other orders) tie to within this
TIE_RTOL = 1e-4
# a sub-label may differ only where its draw lies within this much of 0,
# relative to |row| . |delta column| (chip_smoke.sub_ties_only's rule)
SUB_RTOL = 2e-5
ROUTES = ("bf16", "high")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    return torch.device("cuda")


def _case(rng, family, n, d, k, dev):
    """(x, valid, phi_mat, log_w) on ``dev``: standard normal points (counts
    for multinomial; their Gaussian features for "precomputed"), phi_mat
    [F, 2K] small enough that the noise matters, one inactive slot, the
    last 24 rows invalid."""
    if family == "multinomial":
        x = rng.multinomial(40, rng.dirichlet(np.ones(d)), size=n)
        f = d + 1
    else:
        x = rng.standard_normal((n, d))
        f = TG.feature_dim(d)
    phi = rng.standard_normal((f, 2 * k)) * (3.0 / np.sqrt(f))
    log_w = np.log(rng.dirichlet(np.ones(k)))
    log_w[k - 1] = -np.inf
    x, phi, log_w = (torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in (x, phi, log_w))
    if family == "precomputed":
        x = TG.features(x)
    valid = torch.arange(n, device=dev) < n - 24
    return x, valid, phi, log_w


def _check(x, valid, phi, log_w, family, route, x_raw=None):
    """The kernel against the plain version under ``route``, hard and soft
    (module note)."""
    k = log_w.shape[0]
    for hard in (True, False):
        args = (x, valid, phi, log_w, SEED, TILE_OFF, hard)
        kw = dict(tile=TILE, family_name=family, ll_precision=route,
                  x_raw=x_raw)
        lk, sk_, _ = sk.fused_assign(*args, **kw)
        lp, sp, _ = sk.fused_assign_reference(*args, **kw)
        rows = sk.feature_rows(x, family)
        diff = torch.nonzero(lk != lp)[:, 0]
        if diff.numel():
            # the top two logits, with the label noise where it is drawn
            ll = sk.ll_product(rows[diff], phi[:, :k], route) + log_w
            if not hard:
                g = diff.long()
                ll = ll + sk.gumbel_noise(
                    sk.tile_seeds(SEED, g, TILE, TILE_OFF), g % TILE, k)
            top2 = torch.topk(ll, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            assert bool((gap <= TIE_RTOL * top2[:, 0].abs().clamp(
                min=1.0)).all()), diff.numel()
        idx = torch.nonzero((lk == lp) & (sk_ != sp))[:, 0]
        if idx.numel():
            r = rows[idx].double()
            col = phi[:, k:].double().T[lk[idx].long()]
            g = idx.long()
            s = sk.tile_seeds(SEED, g, TILE, TILE_OFF) ^ 0xA5A5A5A5
            g2 = sk.gumbel_noise(s, g % TILE, 2).double()
            draw = ((r * col).sum(1) + (g2[:, 1] - g2[:, 0]) + 1e-30).abs()
            scale = (r.abs() * col.abs()).sum(1)
            assert bool((draw <= SUB_RTOL * scale + 1e-6).all()), idx.numel()
        for a, b in zip(sk.fused_assign(*args, **kw)[:2], (lk, sk_)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [129, 320, 639, 200 * 128 + 64])
def test_tc_ragged_n_and_odd_tiles(rng, cuda, n, route):
    """2, 3, 5 and 201 tiles of 128 points (N mod 128 = 1, 64, 127, 64):
    a last cluster whose partner has no rows, and clusters that walk
    several tile pairs."""
    _check(*_case(rng, "precomputed", n, 8, 40, cuda), "precomputed", route)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("k", [16, 17, 32, 33, 64, 65, 128, 129, 256])
def test_tc_width_edges(rng, cuda, k, route):
    """Each pass width (32, 64, 128, 256 columns) at its largest K and one
    past it (129: a second pass); the three-pass split's four launches take
    the ring (counted in ``ring_launches``) exactly at K > 64."""
    sk.reset_launches()
    _check(*_case(rng, "precomputed", 1000, 8, k, cuda), "precomputed",
           route)
    ring = 4 if route == "high" and k > 64 else 0
    assert sk.fused_assign.ring_launches["precomputed"] == ring
    assert sum(sk.fused_assign.ring_launches.values()) == ring


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("family,d,k", [
    ("multinomial", 100, 64), ("gaussian", 32, 128), ("gaussian", 64, 256),
    ("gaussian", 70, 129)])
def test_tc_features_not_whole_slices(rng, cuda, family, d, k, route):
    """F = 101, 561, 2145, 2556: a last slice of zeros; the Gaussian rows
    built from points staged in shared memory (D = 32, 64) or, at D = 70
    and two planes, read from device memory."""
    _check(*_case(rng, family, 1500, d, k, cuda), family, route)


# ---- one bf16 pass over a bf16 cache at a pass width of 256 (K > 64):
# csrc/fused_assign_tc_tma.cuh, the cache's rows copied by the tensor map
def _bf16_case(rng, n, d, k, dev):
    """``_case``'s Gaussian inputs with the points' bf16 cache as fit builds
    it (rows padded to a multiple of 8 values, zeros past F), and the raw
    points for "hybrid"."""
    from dpmmsubclusters_tpu_torch.sampler.driver import bf16_features

    x, valid, phi, log_w = _case(rng, "gaussian", n, d, k, dev)
    return bf16_features(TG, x, SEED), valid, phi, log_w, x


def _check_tma(cache, valid, phi, log_w):
    """``_check`` of the "bfloat16" variant on the bf16 cache under
    "default" (one bf16 pass), which must launch the new kernel once a call
    (four calls: hard and soft, each against a second launch)."""
    sk.reset_launches()
    _check(cache, valid, phi, log_w, "bfloat16", "default")
    assert sk.fused_assign.tma_launches == {"bfloat16": 4, "hybrid": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [65, 128, 129, 256])
@pytest.mark.parametrize("d", [32, 64, 70])
def test_tma_cache_k_and_f(rng, cuda, d, k):
    """F = 561, 2145, 2556 (row pitch 568, 2152, 2560; a last slice of
    zeros) at K = 65, 128 (one pass), 129 and 256 (two)."""
    cache, valid, phi, log_w, _ = _bf16_case(rng, 1500, d, k, cuda)
    assert cache.stride(0) % 8 == 0 and cache.stride(0) > cache.shape[1] - 8
    _check_tma(cache, valid, phi, log_w)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [129, 320, 639, 200 * 128 + 64])
def test_tma_ragged_n_and_odd_tiles(rng, cuda, n):
    """2, 3, 5 and 201 tiles of 128 points: a last cluster whose partner
    walks an empty tile, and clusters that walk several tile pairs."""
    _check_tma(*_bf16_case(rng, n, 8, 129, cuda)[:4])


@pytest.mark.gpu
def test_tma_nan_rows(rng, cuda):
    """Rows holding NaN: their logits are -inf, so they take column 0 and
    sub-label 0, as in the plain version (hard and soft)."""
    cache, valid, phi, log_w, _ = _bf16_case(rng, 1000, 8, 100, cuda)
    cache[5, 3] = float("nan")
    cache[700:704, 0] = float("nan")
    _check_tma(cache, valid, phi, log_w)
    labels, sub, _ = sk.fused_assign(cache, valid, phi, log_w, SEED,
                                     TILE_OFF, False, tile=TILE,
                                     family_name="bfloat16",
                                     ll_precision="default")
    rows = torch.tensor([5, 700, 701, 702, 703], device=cuda)
    assert not labels[rows].any() and not sub[rows].any()


@pytest.mark.gpu
def test_tma_cache_view_off_16_byte_boundary(rng, cuda):
    """A cache whose rows start 2 bytes past a 16-byte boundary (a column
    view of a wider array) is copied into the port's layout first, with a
    warning; the labels are those of the same values in that layout."""
    cache, valid, phi, log_w, _ = _bf16_case(rng, 700, 8, 80, cuda)
    f = cache.shape[1]
    wide = torch.zeros((cache.shape[0], f + 3), dtype=torch.bfloat16,
                       device=cuda)
    wide[:, 1:f + 1] = cache
    view = wide[:, 1:f + 1]
    assert view.data_ptr() % 16 != 0 and view.stride(0) == f + 3
    with pytest.warns(RuntimeWarning, match="pad_bf16_rows"):
        _check_tma(view, valid, phi, log_w)
    for hard in (True, False):
        args = (valid, phi, log_w, SEED, TILE_OFF, hard)
        kw = dict(tile=TILE, family_name="bfloat16", ll_precision="default")
        with pytest.warns(RuntimeWarning, match="pad_bf16_rows"):
            a = sk.fused_assign(view, *args, **kw)
        b = sk.fused_assign(cache, *args, **kw)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.gpu
def test_tma_hybrid(rng, cuda):
    """The "hybrid" container at the 10M x 64-d fit's width (D = 64, K =
    256): the labels of its bf16 rows, its statistics from the raw
    points."""
    cache, valid, phi, log_w, x = _bf16_case(rng, 1100, 64, 256, cuda)
    _check_tma(cache, valid, phi, log_w)
    sk.reset_launches()
    for hard in (True, False):
        args = (cache, valid, phi, log_w, SEED, TILE_OFF, hard)
        kw = dict(tile=TILE, ll_precision="default")
        lh, sh, sth = sk.fused_assign(*args, family_name="hybrid",
                                      x_raw=x, **kw)
        lb, sb, _ = sk.fused_assign(*args, family_name="bfloat16", **kw)
        assert torch.equal(lh, lb) and torch.equal(sh, sb)
        want = sk.stats_from_labels(x, lh, sh, valid, log_w.shape[0],
                                    "gaussian")
        assert torch.equal(sth, want)
    assert sk.fused_assign.tma_launches == {"bfloat16": 2, "hybrid": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bfloat16", "hybrid"])
def test_tma_same_bits_twice(rng, cuda, family):
    """Two launches give the same labels, sub-labels and statistics."""
    cache, valid, phi, log_w, x = _bf16_case(rng, 5000, 32, 200, cuda)
    kw = dict(tile=TILE, family_name=family, ll_precision="default",
              x_raw=x if family == "hybrid" else None)
    a = sk.fused_assign(cache, valid, phi, log_w, SEED, TILE_OFF, False, **kw)
    b = sk.fused_assign(cache, valid, phi, log_w, SEED, TILE_OFF, False, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("k,launches", [(64, 0), (65, 1)])
def test_tma_launch_count(rng, cuda, k, launches):
    """The new kernel takes one bf16 pass over a bf16 cache above K = 64
    (a pass width of 256), and nothing else: not K = 64, not the
    three-pass split, not float32 rows."""
    cache, valid, phi, log_w, x = _bf16_case(rng, 900, 8, k, cuda)
    args = (valid, phi, log_w, SEED, TILE_OFF, False)
    sk.reset_launches()
    sk.fused_assign(cache, *args, tile=TILE, family_name="bfloat16",
                    ll_precision="default")
    assert sk.fused_assign.tma_launches == {"bfloat16": launches,
                                            "hybrid": 0}
    sk.fused_assign(cache, *args, tile=TILE, family_name="bfloat16",
                    ll_precision="high")
    sk.fused_assign(TG.features(x), *args, tile=TILE,
                    family_name="precomputed", ll_precision="bf16")
    assert sk.fused_assign.tma_launches["bfloat16"] == launches
    assert sk.fused_assign.tensor_core_launches["bfloat16"] == 2


# ---- the passes up to the highest live column at a pass width of 256: the
# ring (three-pass split) and the tensor-map kernel (one bf16 pass) at a
# table width of 256 run ceil(k_hi / 128) passes, k_hi one past the highest
# slot whose log_w is not -inf (at least one pass)
LIVE = {f"prefix {h}": range(h) for h in (1, 64, 127, 128, 129, 255)}
LIVE.update({"prefix 100 and 200": [*range(100), 200], "none": []})
WIDE = (("precomputed", "high"), ("gaussian", "high"),
        ("bfloat16", "default"), ("hybrid", "default"))


@pytest.mark.gpu
@pytest.mark.parametrize("family,route", WIDE)
@pytest.mark.parametrize("live", list(LIVE))
def test_wide_passes_follow_the_highest_live_column(rng, cuda, family, route,
                                                    live):
    """639 points (five 128-point tiles: the last cluster's partner walks
    an empty tile), F = 561 (nine slices a pass), table width 256: the
    plain version's labels and sub-labels, two launches bit for bit, and
    the pass tally's passes run and passes of the width."""
    from dpmmsubclusters_tpu_torch.sampler.driver import bf16_features
    from dpmmsubclusters_tpu_torch.utils import profiling

    x, valid, phi, log_w = _case(rng, "precomputed" if family ==
                                 "precomputed" else "gaussian", 639, 32, 256,
                                 cuda)
    keep = torch.zeros(256, dtype=torch.bool, device=cuda)
    keep[list(LIVE[live])] = True
    log_w = torch.where(keep, log_w, float("-inf"))
    x_raw = None
    if family in ("bfloat16", "hybrid"):
        x_raw = x if family == "hybrid" else None
        x = bf16_features(TG, x, SEED)
    k_hi = max(LIVE[live], default=0) + 1
    sk.reset_launches()
    profiling.reset()
    profiling.enable()
    try:
        _check(x, valid, phi, log_w, family, route, x_raw)
        counts = profiling.counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    run = 1 if k_hi <= 128 else 2
    assert sk.live_passes(log_w) == run
    # four launches: hard and soft, each against a second launch
    assert (counts["kernel_a.passes_run"],
            counts["kernel_a.passes_width"]) == (4 * run, 8)
    wide = (sk.fused_assign.ring_launches if route == "high"
            else sk.fused_assign.tma_launches)
    assert wide[family] == 4
