"""Kernel A under ``ll_precision="default"`` on float32 rows (the f32
cache, rows built from the points) on the card: the three-pass bf16 split
of whole and delta columns on the tensor cores
(``csrc/fused_assign_tc3.cu``).  Against its plain version at one pass and
passes of columns (K = 1, 64, 128, 129, 256), a ragged N, every row
invalid, NaN columns, hard and soft labels; equal to ``"high"`` bit for bit
(the same kernel); the same labels and sub-labels on two runs of one seed;
and its launches counted as the tensor cores', a bf16 cache's under
``"default"`` as one pass.

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

N = 3001                         # no multiple of any block size
SEED, TILE_OFF, TILE = 7, 3, 512
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
# a hard label may differ only where the top two whole-column logits (the
# three-pass split on both sides, float32 sums in other orders) tie to
# within this
TIE_RTOL = 1e-4
# a sub-label may differ only where its draw delta + (G_r - G_l) lies
# within this much of 0, relative to |row| . |delta column| (the split's
# delta, 1.15e-5 of its terms off the float32 one and summed in another
# order by the plain version)
SUB_RTOL = 2e-5
# the raw width D of a variant's rows by default (F = 101, 561, 2145)
WIDTHS = {"multinomial": 100, "precomputed": 32, "gaussian": 64}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    return torch.device("cuda")


def _case(rng, family, k, dev, d=None):
    """(x, valid, phi_mat, log_w) on ``dev``: standardized points (counts
    for multinomial; their Gaussian features for "precomputed"), phi_mat
    [F, 2K] small enough that the noise matters, one inactive slot, the last
    24 rows invalid."""
    d = d or WIDTHS[family]
    if family == "multinomial":
        x = rng.multinomial(40, rng.dirichlet(np.ones(d)), size=N)
        f = d + 1
    else:
        x = rng.standard_normal((N, d))
        f = TG.feature_dim(d)
    phi = rng.standard_normal((f, 2 * k)) * (3.0 / np.sqrt(f))
    log_w = np.log(rng.dirichlet(np.ones(k)))
    if k > 1:
        log_w[k - 1] = -np.inf
    x, phi, log_w = (torch.from_numpy(a.astype(np.float32)).to(dev)
                     for a in (x, phi, log_w))
    if family == "precomputed":
        x = TG.features(x)
    valid = torch.arange(N, device=dev) < N - 24
    return x, valid, phi, log_w


def _sub_ties_only(x, phi, family, labels, sub, sub_plain, same):
    """Where the labels agree and the sub-labels do not, the draw must be
    a near tie (computed in float64 here)."""
    idx = torch.nonzero(same & (sub != sub_plain))[:, 0]
    if not idx.numel():
        return
    k = phi.shape[1] // 2
    rows = sk.feature_rows(x[idx], family).double()
    col = phi[:, k:].double().T[labels[idx].long()]
    delta = (rows * col).sum(1)
    g = idx.long()
    s = sk.tile_seeds(SEED, g, TILE, TILE_OFF) ^ 0xA5A5A5A5
    g2 = sk.gumbel_noise(s, g % TILE, 2).double()
    draw = (delta + (g2[:, 1] - g2[:, 0]) + 1e-30).abs()
    scale = (rows.abs() * col.abs()).sum(1)
    assert bool((draw <= SUB_RTOL * scale + 1e-6).all()), idx.numel()


def _check(x, valid, phi, log_w, family, hard):
    """The kernel against the plain version: labels equal but at near ties
    of the whole columns, sub-labels equal wherever the labels are but at
    near ties of their draw, statistics at rtol 1e-4 / atol 1e-3, two
    launches equal."""
    k = log_w.shape[0]
    args = (x, valid, phi, log_w, SEED, TILE_OFF, hard)
    kw = dict(tile=TILE, family_name=family, ll_precision="default")
    lk, sk_, stk = sk.fused_assign(*args, **kw)
    lp, sp, _ = sk.fused_assign_reference(*args, **kw)
    diff = torch.nonzero(lk != lp)[:, 0]
    if hard and diff.numel():
        rows = sk.feature_rows(x[diff], family)
        ll = sk.ll_product(rows, phi[:, :k], "high") + log_w
        top2 = torch.topk(ll, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        assert bool((gap <= TIE_RTOL * top2[:, 0].abs().clamp(min=1.0)).all())
    assert (lk == lp).float().mean() >= 0.999
    _sub_ties_only(x, phi, family, lk, sk_, sp, lk == lp)
    torch.testing.assert_close(
        stk, sk.stats_from_labels_reference(x, lk, sk_, valid, k, family),
        rtol=STATS_RTOL, atol=STATS_ATOL)
    for a, b in zip(sk.fused_assign(*args, **kw), (lk, sk_, stk)):
        assert torch.equal(a, b)
    return lk, sk_, stk


@pytest.mark.gpu
@pytest.mark.parametrize("family,k,d", [
    ("precomputed", 1, None), ("precomputed", 128, None),
    ("precomputed", 129, None), ("precomputed", 256, None),
    ("multinomial", 128, None), ("gaussian", 129, None),
    ("gaussian", 64, 130)])     # D=130: the block's points not staged
@pytest.mark.parametrize("hard", [True, False])
def test_cuda_default_route_matches_plain(rng, cuda, family, k, d, hard):
    _check(*_case(rng, family, k, cuda, d), family, hard)


@pytest.mark.gpu
def test_cuda_default_route_with_every_row_invalid(rng, cuda):
    x, valid, phi, log_w = _case(rng, "precomputed", 100, cuda)
    _, _, stats = _check(x, torch.zeros_like(valid), phi, log_w,
                         "precomputed", False)
    assert not stats.any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 256])
def test_cuda_default_route_nan_columns(rng, cuda, k):
    """A NaN whole column never wins; a NaN delta column makes its label's
    sub-labels 0, as in the plain version."""
    x, valid, phi, log_w = _case(rng, "precomputed", k, cuda)
    phi[:, 2] = float("nan")
    phi[:, k + 4] = float("nan")
    log_w[4] = log_w.max()           # label 4 holds points
    for hard in (True, False):
        labels, sub, _ = _check(x, valid, phi, log_w, "precomputed", hard)
        assert not (labels == 2).any()
        assert (labels == 4).any() and not sub[labels == 4].any()


@pytest.mark.gpu
@pytest.mark.parametrize("family,k", [
    ("precomputed", 15), ("precomputed", 129), ("gaussian", 128),
    ("gaussian", 256), ("multinomial", 64)])
def test_cuda_default_route_is_the_three_pass_split(rng, cuda, family, k):
    """On float32 rows "default" launches "high"'s kernel: the same labels,
    sub-labels and statistics bit for bit, hard and soft."""
    x, valid, phi, log_w = _case(rng, family, k, cuda)
    for hard in (True, False):
        args = (x, valid, phi, log_w, SEED, TILE_OFF, hard)
        got = sk.fused_assign(*args, tile=TILE, family_name=family,
                              ll_precision="default")
        want = sk.fused_assign(*args, tile=TILE, family_name=family,
                               ll_precision="high")
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_default_route_is_deterministic(rng, cuda):
    x, valid, phi, log_w = _case(rng, "gaussian", 256, cuda)
    args = (x, valid, phi, log_w, SEED, TILE_OFF, False)
    kw = dict(tile=TILE, family_name="gaussian", ll_precision="default")
    first = sk.fused_assign(*args, **kw)
    for a, b in zip(sk.fused_assign(*args, **kw), first):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_default_route_counts_its_launches(rng, cuda):
    """"default" takes the tensor cores on float32 rows and on a bf16
    cache alike, counted under the variant; "highest" does not."""
    x, valid, phi, log_w = _case(rng, "precomputed", 8, cuda)
    sk.reset_launches()
    sk.fused_assign(x, valid, phi, log_w, SEED, ll_precision="default")
    sk.fused_assign(x.bfloat16(), valid, phi, log_w, SEED,
                    family_name="bfloat16", ll_precision="default")
    sk.fused_assign(x, valid, phi, log_w, SEED, ll_precision="highest")
    tc = {key: n for key, n in sk.fused_assign.tensor_core_launches.items()
          if n}
    assert tc == {"precomputed": 1, "bfloat16": 1}
    assert sk.fused_assign.launches["precomputed"] == 2
