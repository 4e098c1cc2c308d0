"""The sweep kernels A and B on the card against their plain versions, and
the raw-point variants against the cache's bit for bit (moved here from
tests/test_torch_kernels.py, whose CPU tests hold the plain versions
against the Pallas kernels).

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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1_048_576, 1_000_003])
@pytest.mark.parametrize("hard", [True, False])
def test_cuda_resident_route_matches_plain(rng, n, hard):
    """Kernel A's resident route (``csrc/fused_assign_tc_resident.cuh``:
    phi held by persistent blocks) on 1M x 100-d counts at 64 slots, the
    first 20 live, under "default", and at an N that is no multiple of 64:
    the route is taken, the labels equal the plain version's but at near
    ties of the whole columns (the three-pass split on both sides, float32
    sums in other orders), the sub-labels wherever the labels agree but at
    near ties of their draw, the statistics at rtol 1e-4, "high" bit for
    bit, and a second launch the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    k, live, d = 64, 20, 100
    x, phi_mat, log_w, valid = _raw_case(rng, "multinomial", n, d, k)
    log_w[live:] = -np.inf
    x, valid, phi, log_w = (t.cuda() for t in _tt(x, valid, phi_mat, log_w))
    args = (x, valid, phi, log_w, 5, 3, hard)
    kw = dict(tile=512, family_name="multinomial", ll_precision="default")
    assert sk.resident_bufs(d + 1, k, 2, 4 * d) > 0
    sk.reset_launches()
    lk, sk_, stk = sk.fused_assign(*args, **kw)
    assert sk.fused_assign.resident_launches["multinomial"] == 1
    lp, sp, _ = sk.fused_assign_reference(*args, **kw)
    same = lk == lp
    assert same.float().mean() >= 0.999
    rows = sk.feature_rows(x, "multinomial")
    diff = torch.nonzero(~same)[:, 0]
    if hard and diff.numel():
        ll = sk.ll_product(rows[diff], phi[:, :k], "high") + log_w
        top2 = torch.topk(ll, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        assert bool((gap <= 1e-4 * top2[:, 0].abs().clamp(min=1.0)).all())
    idx = torch.nonzero(same & (sk_ != sp))[:, 0]
    if idx.numel():
        r = rows[idx].double()
        col = phi[:, k:].double().T[lk[idx].long()]
        g = idx.long()
        s = sk.tile_seeds(5, g, 512, 3) ^ 0xA5A5A5A5
        g2 = sk.gumbel_noise(s, g % 512, 2).double()
        draw = ((r * col).sum(1) + (g2[:, 1] - g2[:, 0])).abs()
        assert bool((draw <= 2e-5 * (r.abs() * col.abs()).sum(1)
                     + 1e-6).all())
    torch.testing.assert_close(
        stk, sk.stats_from_labels_reference(x, lk, sk_, valid, k,
                                            "multinomial"),
        rtol=STATS_RTOL, atol=STATS_ATOL)
    high = sk.fused_assign(*args, **dict(kw, ll_precision="high"))
    again = sk.fused_assign(*args, **kw)
    for got in (high, again):
        for a, b in zip(got, (lk, sk_, stk)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_resident_rule_is_the_wrappers():
    """The launcher's route rule (``resident_bufs`` in
    ``csrc/fused_assign_tc.cuh``) and the wrapper's, which counts the
    route, give the same buffers at every shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels)")
    from dpmmsubclusters_tpu_torch.ops import _build

    lib = _build.load()
    for f in (1, 6, 64, 65, 101, 561, 2145):
        for k in (1, 16, 17, 32, 33, 64, 65, 256):
            for planes in (1, 2):
                for pitch in (8, 24, 400, 4 * 32, 4 * 561, 2 * 568):
                    assert (lib.dpmm_assign_tc_resident(f, k, planes, pitch)
                            == sk.resident_bufs(f, k, planes, pitch))
