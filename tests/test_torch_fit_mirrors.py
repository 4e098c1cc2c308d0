"""Two of the reference's end-to-end tests (tests/test_fit_e2e.py) mirrored
on the port (``device="cpu"``): the same data, held to the reference
tests' gates -- smart splits recover a mixture of well-separated
components quickly, and a fused fit with ground truth keeps one NMI a
block in a history that lines up with ``history.k``."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from tests.test_fit_e2e import four_corners  # noqa: E402


def test_smart_splits_rescues_separated_mixture():
    """A slot holding several well-separated components is a symmetric
    saddle of the sub-cluster chain; smart splits recover all 12 within 60
    sweeps."""
    rng = np.random.default_rng(3)
    k_true, d, n = 12, 16, 24_000
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    lab = rng.integers(0, k_true, size=n)
    x = means[lab] + rng.standard_normal((n, d)).astype(np.float32)
    res = tdpmm.fit(x, alpha=10.0, iters=60, seed=0, verbose=False,
                    k_max=32, burnout=5, smart_splits=True, device="cpu")
    assert res.k == k_true, res.k
    assert tdpmm.nmi(lab, res.labels) > 0.999


def test_fused_mode_block_nmi_history():
    """gt= keeps the fused blocks: NMI and VI once a block, repeated per
    sweep so the history lines up with history.k; the last block at NMI
    1.0."""
    x, gt = four_corners(400)
    res = tdpmm.fit(x, alpha=100.0, iters=40, seed=4, verbose=False,
                    burnout=5, gt=gt, fused_block=8, device="cpu")
    h = res.history
    assert len(h.nmi) == 40 and len(h.vi) == 40 and len(h.k) == 40
    assert h.nmi[-1] > 0.999
    for b in range(40 // 8):
        assert len(set(h.nmi[b * 8:(b + 1) * 8])) == 1
