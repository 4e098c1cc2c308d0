"""Kernel A's exact float32 route (``ll_precision="highest"``) on the card
against its plain version: one pass and passes of whole columns (K = 1,
128, 129, 256), feature widths that are no multiple of 4 or 16 (F = 101,
561, 2145), a ragged N, every row invalid, hard and soft labels, NaN
columns, and the same labels at each of the tile study's block sizes.

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
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
# rows of the variant's family: (family_name, raw width D, F)
WIDTHS = {"multinomial": (100, 101), "precomputed": (32, 561),
          "gaussian": (64, 2145)}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    return torch.device("cuda")


def _case(rng, family, k, dev):
    """(x, valid, phi_mat, log_w) on ``dev``: standardized points (counts
    for multinomial; their Gaussian features for "precomputed"), phi_mat
    [F, 2K] small enough that the noise matters, one inactive slot, the last
    24 rows invalid."""
    d, f = WIDTHS[family]
    if family == "multinomial":
        x = rng.multinomial(40, rng.dirichlet(np.ones(d)), size=N)
    else:
        x = rng.standard_normal((N, d))
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


def _check(x, valid, phi, log_w, family, hard):
    """The kernel against the plain version: hard labels equal but near
    ties (the plain product sums in another order), soft labels and
    sub-labels agreeing >= 0.999, statistics at rtol 1e-4 / atol 1e-3, two
    launches equal."""
    k = log_w.shape[0]
    args = (x, valid, phi, log_w, 7, 3, hard)
    kw = dict(tile=512, family_name=family, ll_precision="highest")
    lk, sk_, stk = sk.fused_assign(*args, **kw)
    lp, sp, _ = sk.fused_assign_reference(*args, **kw)
    assert (lk == lp).float().mean() >= 0.999
    assert (sk_ == sp).float().mean() >= 0.999
    torch.testing.assert_close(
        stk, sk.stats_from_labels_reference(x, lk, sk_, valid, k, family),
        rtol=STATS_RTOL, atol=STATS_ATOL)
    for a, b in zip(sk.fused_assign(*args, **kw), (lk, sk_, stk)):
        assert torch.equal(a, b)
    return lk, sk_, stk


@pytest.mark.gpu
@pytest.mark.parametrize("family,k", [
    ("precomputed", 1), ("precomputed", 128), ("precomputed", 129),
    ("precomputed", 256), ("multinomial", 128), ("gaussian", 129)])
@pytest.mark.parametrize("hard", [True, False])
def test_cuda_exact_route_matches_plain(rng, cuda, family, k, hard):
    _check(*_case(rng, family, k, cuda), family, hard)


@pytest.mark.gpu
def test_cuda_exact_route_with_every_row_invalid(rng, cuda):
    x, valid, phi, log_w = _case(rng, "precomputed", 100, cuda)
    _, _, stats = _check(x, torch.zeros_like(valid), phi, log_w,
                         "precomputed", False)
    assert not stats.any()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 256])
def test_cuda_exact_route_nan_columns(rng, cuda, k):
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
@pytest.mark.parametrize("k", [15, 100])
def test_cuda_exact_route_labels_do_not_depend_on_the_block(rng, cuda, k):
    x, valid, phi, log_w = _case(rng, "precomputed", k, cuda)
    runs = [sk.fused_assign(x, valid, phi, log_w, 7, 3, False, tile=512,
                            cta_points=c) for c in sk.CTA_POINTS]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
