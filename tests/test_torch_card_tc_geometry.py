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
of their draw, two launches equal.

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
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


def _check(x, valid, phi, log_w, family, route):
    """The kernel against the plain version under ``route``, hard and soft
    (module note)."""
    k = log_w.shape[0]
    for hard in (True, False):
        args = (x, valid, phi, log_w, SEED, TILE_OFF, hard)
        kw = dict(tile=TILE, family_name=family, ll_precision=route)
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
    past it (129: a second pass)."""
    _check(*_case(rng, "precomputed", 1000, 8, k, cuda), "precomputed",
           route)


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
