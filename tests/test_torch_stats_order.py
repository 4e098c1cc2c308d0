"""Kernel B's summation order on the CPU: the plain key sort against numpy's
stable sort per chunk, the scratch the wrapper asks for, and the statistics
summed in the kernel's order (each chunk's keys over their sorted points,
then the chunks in order) against the JAX package's Pallas kernel run
through the TPU interpreter.  The sort kernel itself runs only on a card
(tests/test_torch_card_stats.py)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu.priors import GAUSSIAN as JG  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402

STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
CHUNK = sk.STATS_CHUNK


def _labels(rng, n, k, how):
    labels = rng.integers(0, k, n).astype(np.int32)
    sub = rng.integers(0, 2, n).astype(np.int32)
    valid = np.ones(n, bool)
    if how == "one key":
        labels[:] = k - 1
        sub[:] = 1
    elif how == "dropped":
        labels[::7] = k
        labels[3::11] = -1
        sub[::13] = 2
        sub[5::17] = -1
        valid[::5] = False
    elif how == "invalid":
        valid[:] = False
    return labels, sub, valid


def _numpy_sort(labels, sub, valid, k, chunk):
    """The expected (perm, offsets): numpy's stable argsort of each chunk's
    keys, the dropped points as key 2k."""
    lab, side = labels.astype(np.int64), sub.astype(np.int64)
    keep = valid & (lab >= 0) & (lab < k) & (side >= 0) & (side < 2)
    keys = np.where(keep, side * k + lab, 2 * k)
    perm, offsets = [], []
    for p0 in range(0, len(keys), chunk):
        seg = keys[p0:p0 + chunk]
        perm.append(np.argsort(seg, kind="stable") + p0)
        offsets.append(np.searchsorted(np.sort(seg), np.arange(2 * k + 1)))
    return np.concatenate(perm), np.stack(offsets)


@pytest.mark.parametrize("n,k,how,chunk", [
    (1000, 8, "uniform", 256),        # N neither a multiple of 32 nor of chunk
    (7, 8, "uniform", CHUNK),         # N < 32
    (2 * CHUNK + 77, 8, "invalid", CHUNK),
    (CHUNK + 5, 8, "one key", CHUNK),
    (CHUNK + 999, 16, "dropped", CHUNK),
    (3000, 1, "uniform", 1024),
    (2 * CHUNK + 31, 256, "uniform", CHUNK),
    (CHUNK + 31, 1024, "dropped", CHUNK),
])
def test_key_sort_reference_is_numpys_stable_sort(rng, n, k, how, chunk):
    labels, sub, valid = _labels(rng, n, k, how)
    perm, offsets = sk.key_sort_reference(
        *(torch.from_numpy(a) for a in (labels, sub, valid)), k, chunk)
    want_perm, want_off = _numpy_sort(labels, sub, valid, k, chunk)
    assert perm.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (-(-n // chunk), 2 * k + 1)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    # the CPU wrapper is the plain sort and counts no launch
    before = sk.key_sort.launches
    if chunk == CHUNK:
        got = sk.key_sort(*(torch.from_numpy(a) for a in (labels, sub, valid)),
                          k)
        assert torch.equal(got[0], perm) and torch.equal(got[1], offsets)
    assert sk.key_sort.launches == before


@pytest.mark.parametrize("n,k,f,want", [
    (1, 1, 3, (1 * 2 * 3, 1 + 3)),
    (CHUNK, 128, 561, (256 * 561, CHUNK + 257)),
    (CHUNK + 1, 682, 15, (2 * 1364 * 15, CHUNK + 1 + 2 * 1365)),
    # above 1365 buckets the sort's [9, 2k + 1] tables go to the scratch
    (3 * CHUNK, 683, 101, (3 * 1366 * 101, 3 * CHUNK + 3 * 1367 * 10)),
    (10_000_000, 256, 2145, (611 * 512 * 2145, 10_000_000 + 611 * 513)),
])
def test_stats_scratch_sizes(n, k, f, want):
    assert sk.stats_scratch_sizes(n, k, f) == want
    assert sk._stats_scratch(n, k, f, "meta").numel() == sum(want)


def _kernel_order_sums(rows, labels, sub, valid, k, chunk):
    """float32 statistics added as kernel B adds them: per chunk, each key's
    rows in sorted (ascending point) order from +0.0, then the chunks'
    partials in order."""
    perm, offsets = sk.key_sort_reference(
        *(torch.from_numpy(a) for a in (labels, sub, valid)), k, chunk)
    perm, offsets = perm.numpy(), offsets.numpy()
    out = np.zeros((2 * k, rows.shape[1]), np.float32)
    for c, off in enumerate(offsets):
        order = perm[c * chunk:(c + 1) * chunk]
        for key in range(2 * k):
            acc = np.zeros(rows.shape[1], np.float32)
            for p in order[off[key]:off[key + 1]]:
                acc = acc + rows[p]
            out[key] = out[key] + acc
    return out


def test_kernel_order_matches_pallas_stats(rng):
    n, d, k, chunk = 1536, 3, 4, 512
    x = rng.standard_normal((n, d)).astype(np.float32)
    feat = np.array(JG.features(jnp.asarray(x)))
    labels, sub, valid = _labels(rng, n, k, "dropped")
    got = _kernel_order_sums(feat, labels, sub, valid, k, chunk)
    keep = valid & (labels >= 0) & (labels < k) & (sub >= 0) & (sub < 2)
    blk = [jnp.asarray(a.reshape(-1, 128))
           for a in (np.where(keep, labels, 0), np.where(keep, sub, 0), keep)]
    want = ps.stats_from_labels(jnp.asarray(feat), *blk, k_slots=k,
                                family_name="precomputed", tile=256,
                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=STATS_RTOL,
                               atol=STATS_ATOL)
    plain = sk.stats_from_labels_reference(
        *(torch.from_numpy(a) for a in (feat, labels, sub, valid)), k)
    np.testing.assert_allclose(got, plain.numpy(), rtol=STATS_RTOL,
                               atol=STATS_ATOL)
