"""Kernel B on the card: its key sort against the plain sort, and the whole
kernel against its plain version in every variant, under uniform labels,
every point in one key and the labels of one kernel A call, plus the edge
cases (ragged N, N < 32, nothing valid, dropped labels, D=1, K=1024).

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import numpy as np
import pytest
import torch

from dpmmsubclusters_tpu_torch.ops import _build
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
from dpmmsubclusters_tpu_torch.priors import GAUSSIAN as TG
from dpmmsubclusters_tpu_torch.priors import MULTINOMIAL as TM
from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi

# float32 sums of the same terms in another order than index_add_'s
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
CHUNK = sk.STATS_CHUNK


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these there)")
    return torch.device("cuda")


def _labels(rng, n, k, how):
    """(labels, sub, valid) int32/int32/bool numpy arrays: ``uniform`` over
    the 2k keys, ``one key`` (all in key 0), ``dropped`` (uniform with
    labels -1 and k, sides 2 and -1, and invalid points mixed in) or
    ``invalid`` (no point valid)."""
    labels = rng.integers(0, k, n).astype(np.int32)
    sub = rng.integers(0, 2, n).astype(np.int32)
    valid = np.ones(n, bool)
    if how == "one key":
        labels[:] = 0
        sub[:] = 0
    elif how == "dropped":
        labels[::7] = k
        labels[3::11] = -1
        sub[::13] = 2
        sub[5::17] = -1
        valid[::5] = False
    elif how == "invalid":
        valid[:] = False
    return labels, sub, valid


def _t(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _phi_mat(family, d, k):
    gen = torch.Generator().manual_seed(1)
    ones = torch.ones(k, 3, dtype=torch.bool)
    if family == "multinomial":
        post = {"alpha": 0.5 + 2.5 * torch.rand((k, 3, d), generator=gen)}
        phi = TM.sample_params(gen, post, ones)["phi"]
    else:
        post = {"kappa": torch.full((k, 3), 5.0),
                "m": torch.randn((k, 3, d), generator=gen),
                "nu": torch.full((k, 3), d + 5.0),
                "psi": torch.eye(d).expand(k, 3, d, d)}
        phi = TG.sample_params(gen, post, ones)["phi"]
    return _delta_phi(phi, torch.log(torch.full((k, 2), 0.5)))


def _rows(rng, variant, n, d, dev):
    """The rows a variant reads, on the card."""
    if variant == "multinomial":
        x = rng.multinomial(30, rng.dirichlet(np.ones(d)), size=n)
        return torch.from_numpy(x.astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(
        dev)
    if variant == "precomputed":
        return TG.features(x)
    if variant == "bfloat16":
        return TG.features(x).bfloat16()
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,how", [
    (1000, 8, "uniform"),             # N neither a multiple of 32 nor of the chunk
    (7, 8, "uniform"),                # N < 32
    (3 * CHUNK + 77, 8, "invalid"),   # nothing valid
    (2 * CHUNK + 5, 8, "one key"),
    (CHUNK + 999, 16, "dropped"),     # out-of-range labels and sides dropped
    (2 * CHUNK + 31, 1, "uniform"),
    (2 * CHUNK + 31, 256, "uniform"),
    (2 * CHUNK + 31, 1024, "dropped"),  # the sort's tables in the scratch
])
def test_cuda_key_sort_equals_the_plain_sort(rng, cuda, n, k, how):
    labels, sub, valid = _t(cuda, *_labels(rng, n, k, how))
    sk.reset_launches()
    perm, offsets = sk.key_sort(labels, sub, valid, k)
    assert sk.key_sort.launches == 1
    want_perm, want_off = sk.key_sort_reference(labels, sub, valid, k)
    assert torch.equal(offsets, want_off)
    assert torch.equal(perm, want_perm)


def _check_b(variant, x, labels, sub, valid, k):
    got = sk.stats_from_labels(x, labels, sub, valid, k, variant)
    want = sk.stats_from_labels_reference(x, labels, sub, valid, k, variant)
    torch.testing.assert_close(got, want, rtol=STATS_RTOL, atol=STATS_ATOL)
    assert torch.equal(got, sk.stats_from_labels(x, labels, sub, valid, k,
                                                 variant)), "not deterministic"
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["uniform", "one key", "fit"])
@pytest.mark.parametrize("variant,d,k", [("precomputed", 6, 8),
                                         ("gaussian", 8, 16),
                                         ("multinomial", 12, 8),
                                         ("bfloat16", 6, 8)])
def test_cuda_kernel_b_matches_plain(rng, cuda, variant, d, k, how):
    """Each variant against its plain version at rtol 1e-4 / atol 1e-3,
    two launches equal; "fit" takes the labels of one kernel A call."""
    n = 2 * CHUNK + 333
    x = _rows(rng, variant, n, d, cuda)
    if how == "fit":
        phi_mat = _phi_mat("multinomial" if variant == "multinomial"
                           else "gaussian", d, k).to(cuda)
        valid = torch.ones(n, dtype=torch.bool, device=cuda)
        valid[-100:] = False
        log_w = torch.full((k,), -float(np.log(k)), device=cuda)
        labels, sub, _ = sk.fused_assign(x, valid, phi_mat, log_w, 5, 0,
                                         False, family_name=variant,
                                         ll_precision="default")
    else:
        labels, sub, valid = _t(cuda, *_labels(rng, n, k, how))
    sk.reset_launches()
    _check_b(variant, x, labels, sub, valid, k)
    assert sk.stats_from_labels.launches[variant] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("variant,n,d,k,how", [
    ("gaussian", 1, 1, 1, "uniform"),           # D=1, K=1, one point
    ("gaussian", 3 * CHUNK + 7, 1, 4, "dropped"),
    ("gaussian", 31, 5, 8, "uniform"),          # N < 32, D % 4 != 0
    ("gaussian", CHUNK + 5, 3, 1024, "dropped"),  # K=1024
    ("precomputed", CHUNK + 5, 3, 1024, "uniform"),
    ("multinomial", 2 * CHUNK + 1, 1, 1024, "uniform"),
    ("bfloat16", 1000, 2, 2, "invalid"),        # nothing valid: zeros
    ("precomputed", 2 * CHUNK, 4, 3, "one key"),
])
def test_cuda_kernel_b_edge_cases(rng, cuda, variant, n, d, k, how):
    x = _rows(rng, variant, n, d, cuda)
    labels, sub, valid = _t(cuda, *_labels(rng, n, k, how))
    got = _check_b(variant, x, labels, sub, valid, k)
    if how == "invalid":
        assert not got.any()


@pytest.mark.gpu
def test_cuda_kernel_b_twins_and_kernel_a_statistics(rng, cuda):
    """The row sources add in one order: "gaussian" on x equals
    "precomputed" on its features and "bfloat16" equals "precomputed" on
    the upcast cache, bit for bit; kernel A's statistics equal kernel B's
    at its labels."""
    n, d, k = 2 * CHUNK + 100, 7, 16
    x = _rows(rng, "gaussian", n, d, cuda)
    feat = TG.features(x)
    labels, sub, valid = _t(cuda, *_labels(rng, n, k, "dropped"))
    assert torch.equal(sk.stats_from_labels(x, labels, sub, valid, k,
                                            "gaussian"),
                       sk.stats_from_labels(feat, labels, sub, valid, k))
    cache = feat.bfloat16()
    assert torch.equal(sk.stats_from_labels(cache, labels, sub, valid, k,
                                            "bfloat16"),
                       sk.stats_from_labels(cache.float(), labels, sub,
                                            valid, k))
    phi_mat = _phi_mat("gaussian", d, k).to(cuda)
    log_w = torch.full((k,), -float(np.log(k)), device=cuda)
    lab, side, st = sk.fused_assign(x, valid, phi_mat, log_w, 9, 0, False,
                                    family_name="gaussian")
    assert torch.equal(st, sk.stats_from_labels(x, lab, side, valid, k,
                                                "gaussian"))


@pytest.mark.gpu
def test_cuda_scratch_sizes_agree_with_the_library(cuda):
    lib = _build.load()
    assert lib.dpmm_stats_chunk() == sk.STATS_CHUNK
    for n, k, f in ((1, 1, 3), (CHUNK + 1, 682, 15), (3 * CHUNK, 683, 561),
                    (10_000_000, 256, 2145)):
        partial, order = sk.stats_scratch_sizes(n, k, f)
        assert lib.dpmm_stats_order_ints(n, k) == order
        assert lib.dpmm_stats_scratch(n, f, k) == partial + order
