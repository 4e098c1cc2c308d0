"""Kernel A's sampling on the port's plain version, mirrored from
tests/test_pallas.py::test_sampling_is_calibrated and
::test_hard_mode_sublabels_stay_stochastic: the same inputs (4096 points
at the origin in 4-d, 8 identical slots, the same weights) and gates
(atol 0.03), under every ``ll_precision`` and for the f32 cache, built
rows and a bf16 cache.  Every product is exactly 0 there, so each
implementation's labels and sub-labels are the Gumbel hash's alone: the
port's equal the Pallas kernel's (run through the TPU interpreter at the
same integer seed) bit for bit.  The CUDA kernel's mirror is
tests/test_torch_card_sampling.py."""
import torch_threads  # noqa: F401

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG  # noqa: E402

N, D, K, TILE = 4096, 4, 8, 512
F = 1 + D + D * (D + 1) // 2
WEIGHTS = np.asarray([0.4, 0.3, 0.2, 0.05, 0.02, 0.01, 0.01, 0.01],
                     np.float32)
ATOL = 0.03
# (seed, log-weights, hard) of each gate
CALIBRATED = (7, np.log(WEIGHTS), False)
HARD = (11, np.log(np.full(K, 1.0 / K, np.float32)), True)
VARIANTS = ("gaussian", "precomputed", "bfloat16")


def _pallas(seed, log_w, hard):
    """The Pallas kernel through the TPU interpreter on the gate's inputs:
    (labels, sub) as numpy."""
    labels, sub, _ = ps.fused_assign(
        seed, jnp.zeros((N, D), jnp.float32), jnp.ones((N // 128, 128), bool),
        jnp.zeros((F, 2 * K), jnp.float32), jnp.asarray(log_w), int(hard),
        k_slots=K, family_name="gaussian", tile=TILE, interpret=True)
    return np.asarray(labels).reshape(-1), np.asarray(sub).reshape(-1)


def _port(variant, seed, log_w, hard, ll_precision):
    """The port's plain kernel A on the gate's inputs in a variant's rows:
    (labels, sub) as numpy."""
    x = torch.zeros((N, D))
    if variant != "gaussian":
        x = TG.features(x)
    if variant == "bfloat16":
        x = x.bfloat16()
    labels, sub, _ = sk.fused_assign(
        x, torch.ones(N, dtype=torch.bool), torch.zeros((F, 2 * K)),
        torch.from_numpy(log_w.astype(np.float32)), seed, 0, hard,
        tile=TILE, family_name=variant, ll_precision=ll_precision)
    return labels.numpy(), sub.numpy()


@pytest.fixture(scope="module")
def pallas_calibrated():
    return _pallas(*CALIBRATED)


@pytest.fixture(scope="module")
def pallas_hard():
    return _pallas(*HARD)


@pytest.mark.parametrize("ll_precision", sk.LL_PRECISIONS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_sampling_is_calibrated(pallas_calibrated, variant, ll_precision):
    """Identical slots with given mixture weights: the label frequencies
    match the weights, the sides are 50/50."""
    labels, sub = _port(variant, *CALIBRATED, ll_precision)
    freq = np.bincount(labels, minlength=K) / N
    np.testing.assert_allclose(freq, WEIGHTS, atol=ATOL)
    side = np.bincount(sub, minlength=2) / N
    np.testing.assert_allclose(side, [0.5, 0.5], atol=ATOL)
    np.testing.assert_array_equal(labels, pallas_calibrated[0])
    np.testing.assert_array_equal(sub, pallas_calibrated[1])


@pytest.mark.parametrize("ll_precision", sk.LL_PRECISIONS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_hard_mode_sublabels_stay_stochastic(pallas_hard, variant,
                                             ll_precision):
    """hard zeroes only the label noise: with equal sub-logits the sides
    stay 50/50 (an argmax would put every point on one side)."""
    labels, sub = _port(variant, *HARD, ll_precision)
    side = np.bincount(sub, minlength=2) / N
    np.testing.assert_allclose(side, [0.5, 0.5], atol=ATOL)
    np.testing.assert_array_equal(labels, pallas_hard[0])
    np.testing.assert_array_equal(sub, pallas_hard[1])
