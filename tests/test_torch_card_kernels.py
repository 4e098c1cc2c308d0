"""The sweep kernels A and B on the card against their plain versions, and
the raw-point variants against the cache's bit for bit (moved here from
tests/test_torch_kernels.py, whose CPU tests hold the plain versions
against the Pallas kernels).

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
from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TMN
from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi

# float32 sums taken in another order (the kernel's against index_add_)
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
_D = {"gaussian": 4, "multinomial": 8}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _raw_case(rng, family="gaussian", n=1024, d=4, k=8):
    """Raw points of a family, a [F, 2K] phi_mat drawn by the port's family,
    log-weights with one inactive slot, and valid."""
    gen = torch.Generator().manual_seed(1)
    if family == "gaussian":
        x = rng.standard_normal((n, d)).astype(np.float32)
        fam = TG
        post = {
            "kappa": torch.full((k, 3), 5.0),
            "m": torch.from_numpy(
                rng.standard_normal((k, 3, d)).astype(np.float32)),
            "nu": torch.full((k, 3), d + 5.0),
            "psi": torch.eye(d).expand(k, 3, d, d),
        }
    else:
        x = rng.multinomial(30, rng.dirichlet(np.ones(d)), size=n).astype(
            np.float32)
        fam = TMN
        post = {"alpha": torch.from_numpy(
            rng.uniform(0.5, 3.0, size=(k, 3, d)).astype(np.float32))}
    phi = fam.sample_params(gen, post, torch.ones((k, 3), dtype=torch.bool))
    lrw = rng.dirichlet([1.0, 1.0], size=k).astype(np.float32)
    phi_mat = _delta_phi(phi["phi"], torch.log(torch.from_numpy(lrw))).numpy()
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    log_w = np.log(w).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    valid = np.arange(n) < n - 24
    return x, phi_mat, log_w, valid


def _case(rng, n=1024, d=4, k=8):
    x, phi_mat, log_w, valid = _raw_case(rng, "gaussian", n, d, k)
    return TG.features(torch.from_numpy(x)).numpy(), phi_mat, log_w, valid


def _tt(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    feat, phi_mat, log_w, valid = _case(rng, n=4096)
    args = [t.cuda() for t in _tt(feat, valid, phi_mat, log_w)]
    for hard in (True, False):
        lk, sk_, stk = sk.fused_assign(*args, 5, 0, hard)
        lp, sp, _ = sk.fused_assign_reference(*args, 5, 0, hard)
        assert (lk == lp).float().mean() >= (1.0 if hard else 0.999)
        want = sk.stats_from_labels_reference(args[0], lk, sk_, args[1], 8)
        torch.testing.assert_close(stk, want, rtol=STATS_RTOL,
                                   atol=STATS_ATOL)
        torch.testing.assert_close(
            sk.stats_from_labels(args[0], lk, sk_, args[1], 8), want,
            rtol=STATS_RTOL, atol=STATS_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["gaussian", "multinomial"])
def test_cuda_built_rows_match_plain_and_cache_rows(rng, family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    x, phi_mat, log_w, valid = _raw_case(rng, family, n=4096,
                                         d=_D[family])
    args = [t.cuda() for t in _tt(x, valid, phi_mat, log_w)]
    lk, sk_, stk = sk.fused_assign(*args, 5, 0, True, family_name=family)
    lp, _, _ = sk.fused_assign_reference(*args, 5, 0, True,
                                         family_name=family)
    assert (lk == lp).float().mean() >= 0.999
    want = sk.stats_from_labels_reference(args[0], lk, sk_, args[1], 8,
                                          family)
    torch.testing.assert_close(stk, want, rtol=STATS_RTOL, atol=STATS_ATOL)
    feat = (TG if family == "gaussian" else TMN).features(args[0])
    twin = sk.fused_assign(feat, *args[1:], 5, 0, True)
    for a, b in zip((lk, sk_, stk), twin):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [192, 256])
def test_cuda_kernel_a_takes_any_k(rng, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    feat, phi_mat, log_w, valid = _case(rng, n=4096, k=k)
    args = [t.cuda() for t in _tt(feat, valid, phi_mat, log_w)]
    lk, sk_, stk = sk.fused_assign(*args, 5, 0, True)
    lp, sp, _ = sk.fused_assign_reference(*args, 5, 0, True)
    assert (lk == lp).float().mean() >= 0.999
    assert (sk_ == sp).float().mean() >= 0.999
    torch.testing.assert_close(
        stk, sk.stats_from_labels_reference(args[0], lk, sk_, args[1], k),
        rtol=STATS_RTOL, atol=STATS_ATOL)
