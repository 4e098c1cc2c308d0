"""Kernel A's sampling on the card, mirrored from
tests/test_pallas.py::test_sampling_is_calibrated and
::test_hard_mode_sublabels_stay_stochastic: the same inputs (4096 points
at the origin in 4-d, 8 identical slots, the same weights) and gates
(atol 0.03), on every route of the CUDA kernel (one bf16 pass, the
three-pass split, the exact float32 product) and every row source (the
f32 cache, rows built from the points, the bf16 cache, and hybrid).
Every product is exactly 0 there, so the kernel's labels and sub-labels
must equal its plain version's bit for bit (tests/test_torch_sampling.py
holds the plain version to the Pallas kernel's).

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

N, D, K, TILE = 4096, 4, 8, 512
WEIGHTS = np.asarray([0.4, 0.3, 0.2, 0.05, 0.02, 0.01, 0.01, 0.01],
                     np.float32)
ATOL = 0.03
# (seed, log-weights, hard) of each gate
CALIBRATED = (7, np.log(WEIGHTS), False)
HARD = (11, np.log(np.full(K, 1.0 / K, np.float32)), True)
# each ll_precision's route: "bf16" one bf16 pass, "high" the three-pass
# split (both fused_assign_tc.cuh), "highest" the exact kernel
ROUTES = ("bf16", "high", "highest")
# the row sources: CacheRows, BuiltRows (Gaussian, multinomial), Bf16Rows
VARIANTS = ("precomputed", "gaussian", "multinomial", "bfloat16", "hybrid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    return torch.device("cuda")


def _both(variant, seed, log_w, hard, ll_precision, dev):
    """The kernel and its plain version on the gate's inputs in a
    variant's rows: ((labels, sub) of the kernel, of the plain version)."""
    x = raw = torch.zeros((N, D), device=dev)
    f = D + 1 if variant == "multinomial" else TG.feature_dim(D)
    if variant in ("precomputed", "bfloat16", "hybrid"):
        x = TG.features(raw)
    if variant in ("bfloat16", "hybrid"):
        x = x.bfloat16()
    args = (x, torch.ones(N, dtype=torch.bool, device=dev),
            torch.zeros((f, 2 * K), device=dev),
            torch.from_numpy(log_w.astype(np.float32)).to(dev), seed, 0, hard)
    kw = dict(tile=TILE, family_name=variant, ll_precision=ll_precision,
              x_raw=raw if variant == "hybrid" else None)
    got = sk.fused_assign(*args, **kw)
    want = sk.fused_assign_reference(*args, **kw)
    return ([t.cpu().numpy() for t in got[:2]],
            [t.cpu().numpy() for t in want[:2]])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_sampling_is_calibrated(cuda, variant, route):
    (labels, sub), (want_l, want_s) = _both(variant, *CALIBRATED, route,
                                            cuda)
    np.testing.assert_allclose(np.bincount(labels, minlength=K) / N,
                               WEIGHTS, atol=ATOL)
    np.testing.assert_allclose(np.bincount(sub, minlength=2) / N,
                               [0.5, 0.5], atol=ATOL)
    np.testing.assert_array_equal(labels, want_l)
    np.testing.assert_array_equal(sub, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_hard_mode_sublabels_stay_stochastic(cuda, variant, route):
    (labels, sub), (want_l, want_s) = _both(variant, *HARD, route, cuda)
    np.testing.assert_allclose(np.bincount(sub, minlength=2) / N,
                               [0.5, 0.5], atol=ATOL)
    np.testing.assert_array_equal(labels, want_l)
    np.testing.assert_array_equal(sub, want_s)
