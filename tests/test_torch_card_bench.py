"""The kernel studies' CUDA kernels on the card: kernel C's column sums,
kernel D's eight stage sets against their plain versions, and kernel A's
tile-study blocks (moved here from tests/test_torch_bench.py, whose CPU
tests hold the plain versions against the JAX study kernels).

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import numpy as np
import pytest
import torch

from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as tka
from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as tts
from dpmmsubclusters_tpu_torch.ops import study_kernels as stk
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    return torch.device("cuda")


def _ablate_inputs(rng, n, f, k):
    x = rng.standard_normal((n, f)).astype(np.float32)
    phi = rng.standard_normal((f, 3 * k)).astype(np.float32)
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    loglrw = np.log(rng.dirichlet([1.0, 1.0], size=k)).T.astype(np.float32)
    valid = np.arange(n) < n - 24
    return x, valid, phi, log_w, loglrw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.gpu
def test_cuda_column_sum_matches_plain(rng, cuda):
    x = torch.from_numpy(rng.standard_normal((5000, 561)).astype(
        np.float32)).to(cuda)
    got = stk.column_sum(x, torch.empty((3, 561), device=cuda))
    want = stk.column_sum_reference(x, torch.empty((3, 561), device=cuda))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got[:1], stk.column_sum(x))   # deterministic, row 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,stages", tka.VARIANTS,
                         ids=[v[0] for v in tka.VARIANTS])
def test_cuda_kernel_ablate_matches_plain(rng, cuda, name, stages):
    x, valid, phi, log_w, loglrw = _ablate_inputs(rng, n=4096, f=64, k=16)
    args = [t.to(cuda) for t in _t(x, valid, phi, log_w, loglrw)]
    lk, sk_, stk_ = stk.kernel_ablate(*args, 11, tile=512, stages=stages)
    lp, sp, stp = stk.kernel_ablate_reference(*args, 11, tile=512,
                                              stages=stages)
    assert (lk == lp).float().mean() >= 0.999
    assert (sk_ == sp).float().mean() >= 0.999
    torch.testing.assert_close(stk_, stp, rtol=1e-4, atol=1e-2)


@pytest.mark.gpu
def test_cuda_tile_study_labels_do_not_depend_on_the_block(rng, cuda):
    x, valid, phi, log_w = [t.to(cuda) for t in tts.inputs(4096, 4, 16,
                                                           "cpu")]
    runs = [tts.variant(3, x, valid, phi, log_w, tile=1024, cta_points=c)
            for c in sk.CTA_POINTS]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
