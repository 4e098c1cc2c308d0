"""The bf16 feature-cache variants of kernels A and B on the card, and
kernel E, the build gate (moved here from tests/test_torch_feature_layouts.py,
whose CPU tests hold the plain versions against the JAX package).

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card, or without nvcc (``gpu`` marker)."""
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from dpmmsubclusters_tpu_torch.ops import _build
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG
from dpmmsubclusters_tpu_torch.sampler import assign as TA
from dpmmsubclusters_tpu_torch.sampler.driver import bf16_features

STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
D = 4


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _case(rng, n, d=D, k=8):
    """Raw Gaussian points, NIW natural params phi [K, 3, F] drawn by the
    port's family, log-weights with one inactive slot, sub-cluster
    log-weights and valid."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    post = {
        "kappa": torch.full((k, 3), 5.0),
        "m": torch.from_numpy(
            rng.standard_normal((k, 3, d)).astype(np.float32)),
        "nu": torch.full((k, 3), d + 5.0),
        "psi": torch.eye(d).expand(k, 3, d, d),
    }
    phi = TG.sample_params(torch.Generator().manual_seed(1), post,
                           torch.ones((k, 3), dtype=torch.bool))["phi"]
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    log_lrw = np.log(rng.dirichlet([1.0, 1.0], size=k)).astype(np.float32)
    valid = np.arange(n) < n - 24
    return x, phi.numpy(), log_w, log_lrw, valid


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 192])
def test_cuda_bf16_variants_match_plain_and_twins(rng, k):
    """Each new variant against its plain version, and the twin gate: bf16
    rows give the "precomputed" variant's bits on cache.float()."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    x, phi, log_w, log_lrw, valid = _case(rng, n=4096, k=k)
    dev = torch.device("cuda")
    raw = torch.from_numpy(x).to(dev)
    cache = bf16_features(TG, raw, seed=2)
    phi_mat = TA._delta_phi(torch.from_numpy(phi),
                            torch.from_numpy(log_lrw)).to(dev)
    args = (torch.from_numpy(valid).to(dev), phi_mat,
            torch.from_numpy(log_w).to(dev), 5, 0, True)
    twin = sk.fused_assign(cache.float(), *args)
    for layout, kw in (("bfloat16", {}), ("hybrid", {"x_raw": raw})):
        got = sk.fused_assign(cache, *args, family_name=layout, **kw)
        plain = sk.fused_assign_reference(cache, *args, family_name=layout,
                                          **kw)
        assert (got[0] == plain[0]).float().mean() >= 0.999
        assert torch.equal(got[0], twin[0]) and torch.equal(got[1], twin[1])
        stats_rows = (raw, "gaussian") if kw else (cache, "bfloat16")
        want = sk.stats_from_labels(stats_rows[0], got[0], got[1], args[0], k,
                                    stats_rows[1])
        assert torch.equal(got[2], want)
        torch.testing.assert_close(
            want, sk.stats_from_labels_reference(
                stats_rows[0], got[0], got[1], args[0], k, stats_rows[1]),
            rtol=STATS_RTOL, atol=STATS_ATOL)
    assert torch.equal(twin[2], sk.stats_from_labels(
        cache, twin[0], twin[1], args[0], k, "bfloat16"))


_LANE_IOTA = """#include <cuda_runtime.h>
__global__ void lane_iota(const float* x, float* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + static_cast<float>(i % 128);
}
extern "C" int gate_lane_iota(const float* x, float* o, int n, void* st) {
  lane_iota<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(st)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.mark.gpu
def test_build_gate_rejects_an_ill_formed_source(tmp_path):
    """Kernel E, the port of the Mosaic verifier gate of
    tests/test_mosaic_compile.py: the TPU test's kernel (x plus a float
    lane iota) builds and runs in CUDA, and the same source with an
    undeclared name makes the build raise with nvcc's own message."""
    import ctypes

    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc (chip_smoke.py runs the build gate)")
    good, bad = tmp_path / "good", tmp_path / "bad"
    good.mkdir()
    bad.mkdir()
    (good / "lane_iota.cu").write_text(_LANE_IOTA)
    (bad / "lane_iota.cu").write_text(_LANE_IOTA.replace(
        "static_cast<float>(i % 128)", "undeclared_iota"))
    with pytest.raises(RuntimeError, match="undeclared_iota"):
        _build.build(src_dir=bad)
    fn = ctypes.CDLL(str(_build.build(src_dir=good))).gate_lane_iota
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    if torch.cuda.is_available():
        x = torch.randn((8, 128), device="cuda")
        o = torch.empty_like(x)
        assert fn(x.data_ptr(), o.data_ptr(), x.numel(),
                  torch.cuda.current_stream().cuda_stream) == 0
        assert torch.equal(o, x + torch.arange(128, device="cuda"))
