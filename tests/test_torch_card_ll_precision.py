"""Kernel A's tensor-core pass on the card under ``ll_precision``
"bf16" (one bf16 pass; "default" takes it on a bf16 cache) and "high" (the
three-pass split; "default" takes it on float32 rows, which
tests/test_torch_card_default_route.py checks) against its plain version
at the same setting, for every variant and above and below one pass of
columns (moved here from
tests/test_torch_ll_precision.py, whose CPU tests hold the plain version
against the Pallas kernel).

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
from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TM
from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi

VARIANTS = ("precomputed", "gaussian", "multinomial", "hybrid", "bfloat16")
N, TILE = 512, 256


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _case(rng, variant, k, d=None):
    """Raw points of the variant's family, phi_mat [F, 2K] drawn by the
    port's family, log-weights with one inactive slot, valid."""
    multinomial = variant == "multinomial"
    d = d or (8 if multinomial else 4)
    if multinomial:
        x = rng.multinomial(30, rng.dirichlet(np.ones(d)), size=N).astype(
            np.float32)
        fam = TM
        post = {"alpha": torch.from_numpy(
            rng.uniform(0.5, 3.0, size=(k, 3, d)).astype(np.float32))}
    else:
        x = rng.standard_normal((N, d)).astype(np.float32)
        fam = TG
        post = {
            "kappa": torch.full((k, 3), 5.0),
            "m": torch.from_numpy(
                rng.standard_normal((k, 3, d)).astype(np.float32)),
            "nu": torch.full((k, 3), d + 5.0),
            "psi": torch.eye(d).expand(k, 3, d, d),
        }
    phi = fam.sample_params(torch.Generator().manual_seed(1), post,
                            torch.ones((k, 3), dtype=torch.bool))["phi"]
    lrw = rng.dirichlet([1.0, 1.0], size=k).astype(np.float32)
    phi_mat = _delta_phi(phi, torch.log(torch.from_numpy(lrw))).numpy()
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    log_w[k - 1] = -np.inf                    # an inactive slot
    valid = np.arange(N) < N - 24
    return x, phi_mat, log_w, valid


@pytest.mark.gpu
@pytest.mark.parametrize("ll_precision", ["bf16", "high"])
@pytest.mark.parametrize("k", [8, 128, 192])
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_tensor_core_pass_matches_plain(rng, variant, k, ll_precision):
    """The tensor-core kernel against the plain version at the same
    precision: hard labels and sub-labels agree >= 0.999, the statistics at
    the kernel's labels, two launches equal, and the launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    x, phi_mat, log_w, valid = _case(rng, variant, k)
    tv, tphi, tlw = (torch.from_numpy(a).cuda()
                     for a in (valid, phi_mat, log_w))
    raw = torch.from_numpy(x).cuda()
    kw = dict(tile=TILE, family_name=variant, ll_precision=ll_precision)
    rows = raw
    if variant != "multinomial" and variant != "gaussian":
        rows = TG.features(raw)
    if variant in ("hybrid", "bfloat16"):
        rows = rows.bfloat16()
    if variant == "hybrid":
        kw["x_raw"] = raw
    sk.reset_launches()
    got = sk.fused_assign(rows, tv, tphi, tlw, 7, 2, True, **kw)
    assert sk.fused_assign.tensor_core_launches[variant] == 1
    want = sk.fused_assign_reference(rows, tv, tphi, tlw, 7, 2, True, **kw)
    assert (got[0] == want[0]).float().mean() >= 0.999
    assert (got[1] == want[1]).float().mean() >= 0.999
    stats_rows, fam = (raw, "gaussian") if variant == "hybrid" else (
        rows, variant)
    torch.testing.assert_close(
        got[2], sk.stats_from_labels_reference(stats_rows, got[0], got[1],
                                               tv, k, fam),
        rtol=1e-4, atol=1e-3)
    again = sk.fused_assign(rows, tv, tphi, tlw, 7, 2, True, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
