"""The kernel studies' CUDA kernels on the card: kernel C's column sums,
kernel D's eight stage sets against their plain versions, and kernel A's
tile-study blocks (moved here from tests/test_torch_bench.py, whose CPU
tests hold the plain versions against the JAX study kernels).  Kernel C's
walk (``csrc/column_sum.cu``) at F in {1, 3, 5, 128, 129, 561, 640, 1025}
and N in {1, 3, 4, 1025, and enough rows that every block of the card
goes round the ring of stages twice, plus 3}: within 1e-5 of the terms'
magnitudes of the plain version and of float64 sums, the same bits twice
and the bits of its numpy model (``tests/torch_column_walk.py``); 1 and
2K output rows; a misaligned x refused; kernel D's column-sum sets at an
odd F.

Imports only torch, numpy, pytest and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu \\
        tests/test_torch_card_*.py

Every test skips without a CUDA card (``gpu`` marker)."""
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import torch_column_walk as walk
from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as tka
from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as tts
from dpmmsubclusters_tpu_torch.ops import _build
from dpmmsubclusters_tpu_torch.ops import study_kernels as stk
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

COLSUM_FS = (1, 3, 5, 128, 129, 561, 640, 1025)
COLSUM_NS = (1, 3, 4, 1025, "rings")


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


# ---- kernel C's walk ---------------------------------------------------------
def _colsum_rows(n, f: int) -> int:
    """``"rings"``: 13 steps for every block the card runs at once (the
    ring of six stages twice over, and one step more), then 3 rows."""
    if n != "rings":
        return n
    resident = _build.load().dpmm_column_partials(1 << 30) // 4
    return 4 * resident * 13 * walk.step_groups(f) + 3


def _x(n: int, f: int, dev, offset: int = 0):
    gen = torch.Generator(device=dev).manual_seed(7919 * n + f)
    flat = torch.randn(n * f + offset, generator=gen, device=dev)
    return flat[offset:].view(n, f)


def _assert_sums(got, want, mag):
    """Within 1e-5 of the sum of the terms' magnitudes plus 1e-6."""
    err = (got.double() - want.double()).abs()
    bad = err > 1e-5 * mag + 1e-6
    assert not bool(bad.any()), (int(bad.sum()), float(err.max()))


@pytest.mark.gpu
@pytest.mark.parametrize("f", COLSUM_FS)
@pytest.mark.parametrize("n", COLSUM_NS)
def test_cuda_column_sum_walk(cuda, n, f):
    n = _colsum_rows(n, f)
    x = _x(n, f, cuda)
    got = stk.column_sum(x)
    assert torch.equal(stk.column_sum(x), got)      # the same bits twice
    mag = x.double().abs().sum(0)
    _assert_sums(got[0], x.double().sum(0), mag)
    _assert_sums(got[0], stk.column_sum_reference(x)[0], mag)
    blocks = _build.load().dpmm_column_partials(n) // 4
    model = walk.column_sum(x.cpu().numpy(), blocks)
    np.testing.assert_array_equal(got[0].cpu().numpy(), model)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 256])
def test_cuda_column_sum_out_rows(cuda, rows):
    """Every output row takes the sums (kernel D's stats_raw: 2K rows)."""
    x = _x(4099, 561, cuda)
    out = torch.full((rows, 561), float("nan"), device=cuda)
    got = stk.column_sum(x, out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, stk.column_sum(x).expand(rows, 561))


@pytest.mark.gpu
def test_cuda_column_sum_refuses_misaligned_x(cuda):
    """x 4 bytes off a 16-byte boundary: the launch is refused and raises."""
    x = _x(1025, 561, cuda, offset=1)
    assert x.data_ptr() % 16 == 4
    with pytest.raises(RuntimeError, match="column_sum: CUDA error"):
        stk.column_sum(x)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("stages", [("dma_only",), ("dot_only",),
                                    ("stats_raw",)],
                         ids=["dma_only", "dot_only", "stats_raw"])
def test_cuda_ablate_column_sum_sets_at_odd_f(rng, cuda, stages):
    """Kernel D's sets that are kernel C's sums, at F = 129, N = 4099 (a
    part-group of 3 rows): dma_only's row 0 and each of stats_raw's 2K rows
    the walk's bits, dot_only's sums times phi within 1e-5 of the float64
    product's magnitudes; the rest zero; the same bits twice."""
    n, f, k = 4099, 129, 16
    x, valid, phi, log_w, loglrw = [
        t.to(cuda) for t in _t(*_ablate_inputs(rng, n=n, f=f, k=k))]
    args = (x, valid, phi, log_w, loglrw, 11)
    lk, sk_, st = stk.kernel_ablate(*args, tile=512, stages=stages)
    again = stk.kernel_ablate(*args, tile=512, stages=stages)
    assert all(torch.equal(a, b) for a, b in zip(again, (lk, sk_, st)))
    assert not lk.any() and not sk_.any()
    blocks = _build.load().dpmm_column_partials(n) // 4
    sums = torch.from_numpy(walk.column_sum(x.cpu().numpy(), blocks))
    if stages == ("dot_only",):
        x64, phi64 = x.double(), phi.double()
        want = (x64 @ phi64).sum(0)
        mag = (x64.abs() @ phi64.abs()).sum(0)
        _assert_sums(st[0, :3 * k], want, mag)
        assert not st[1:].any() and not st[0, 3 * k:].any()
    else:
        rows = 1 if stages == ("dma_only",) else 2 * k
        assert torch.equal(st[:rows].cpu(), sums.expand(rows, f))
        assert not st[rows:].any()
