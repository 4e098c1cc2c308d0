"""The sweep's two kernels: wrappers around the hand-written CUDA kernels of
``csrc/`` and, beside each, its plain PyTorch version.

* :func:`fused_assign` (kernel A, ``csrc/fused_assign.cu``) -- labels,
  sub-labels and ``[LEFT K | RIGHT K] x F`` statistics for one sweep.
  Replaces ``dpmmsubclusters_tpu.ops.pallas_sweep.fused_assign``.
* :func:`stats_from_labels` (kernel B, ``csrc/stats_from_labels.cu``) --
  the same statistics from given labels.  Replaces
  ``dpmmsubclusters_tpu.ops.pallas_sweep.stats_from_labels``.  Its first
  phase, the per-chunk key sort, is also callable alone (:func:`key_sort`).
  :func:`slot_sums` runs it on whole-number rows and adds its chunk
  partials in int64: exact per-slot sums, for the smart pass.

Both take flat ``int32 [N]`` label streams and, as the JAX functions do, a
``family_name`` that says what the rows ``x`` are:

* ``"precomputed"``: the f32 feature cache ``[N, F]`` itself;
* ``"gaussian"``: raw points ``[N, D]``, feature rows ``[1, x, triu(x x^T)]``
  (F = 1 + D + D(D+1)/2) built inside the kernel;
* ``"multinomial"``: raw counts ``[N, D]``, feature rows ``[1, x]``;
* ``"bfloat16"``: the bf16 feature cache ``[N, F]``, upcast exactly (the
  statistics and, under ``ll_precision="highest"``, the ll product are f32
  arithmetic on the upcast values).  Its rows may lie apart by more than F
  values (a row view, unit stride along a row): a fit builds it as the
  first F columns of ``[N, ld]`` rows, ``ld`` a multiple of 8 and zeros
  past F (:func:`empty_bf16_rows`), so that the card's copy engine can take
  its rows (16-byte row pitch);
* ``"hybrid"`` (kernel A only): the bf16 cache feeds the ll product and the
  statistics are the Gaussian rows built from the raw points ``x_raw [N,
  D]`` passed beside it.  Kernel B on a hybrid container is the
  ``"gaussian"`` variant on ``x_raw``.

The tensor's device picks the path: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version.  Each wrapper counts its
kernel launches per variant in ``<wrapper>.launches``.

Kernel A's ll product ``rows @ phi_mat`` takes the config's ``ll_precision``
(:func:`ll_product` is its plain form, :func:`ll_route` the product a
variant takes), with the JAX package's meaning.  The JAX kernel casts its
operands to one bf16 pass only under ``"bf16"`` or for a bf16 cache
(``pallas_sweep.py:311-320``); otherwise its dot is float32-faithful.  So:

* ``"bf16"``, and ``"default"`` on a bf16 cache (``bfloat16``,
  ``hybrid``): rows and phi rounded to bf16 (to nearest even) and the exact
  products summed in float32, one pass of the card's tensor cores
  (``csrc/fused_assign_tc.cu``; over a bf16 cache at K > 64 its kernel of
  ``csrc/fused_assign_tc_tma.cuh``, whose launches are also counted in
  ``fused_assign.tma_launches``);
* ``"high"``, and ``"default"`` on float32 rows (``precomputed``,
  ``gaussian``, ``multinomial``): the float32-faithful three-pass split
  (XLA's bf16x3: rows and phi each as a bf16 ``hi`` plus a bf16 ``lo``, and
  ``hi*hi + hi*lo + lo*hi``), three passes of the tensor cores
  (``csrc/fused_assign_tc3.cu``; :func:`ll_route` says why; at a pass width
  of 256, K > 64, its kernel of ``csrc/fused_assign_tc_ring.cuh``, whose
  launches are also counted in ``fused_assign.ring_launches``);
* ``"highest"``: exact float32 (``csrc/fused_assign.cu``).

The tensor-core launches are also counted in
``fused_assign.tensor_core_launches``.  The statistics are exact float32 on
every setting.

The Gumbel noise is the TPU kernel's counter hash, reproduced bit for bit
(:func:`gumbel_noise`), so fed the same integer seed, ``tile_off`` and hash
tile size ``tile``, every implementation draws the same noise.
"""
from __future__ import annotations

import functools
import warnings

import torch

from ..priors.dirichlet import MULTINOMIAL
from ..priors.niw import GAUSSIAN
from . import _build

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_SUB_SALT = 0xA5A5A5A5

VARIANTS = ("precomputed", "gaussian", "multinomial", "bfloat16", "hybrid")
# kernel A's exact block sizes (points a block): 128 for every variant; 64
# and 256 too for "precomputed" at K <= 128 (the tile study's), counted apart
CTA_POINTS = (64, 128, 256)
FIT_CTA_POINTS = 128
STATS_VARIANTS = ("precomputed", "gaussian", "multinomial", "bfloat16")
_BF16 = ("bfloat16", "hybrid")
LL_PRECISIONS = ("default", "high", "highest", "bf16")
# the C entry points' ``precision`` of each product (ll_route): 0 the exact
# kernel, else the planes of the tensor-core kernel (1: one bf16 pass, 2:
# the three-pass split)
_PLANES = {"highest": 0, "bf16": 1, "high": 2}
_FAMILIES = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}
# a bf16 cache's row pitch, in values, is a multiple of this (16 bytes: the
# tensor map of csrc/fused_assign_tc_tma.cuh needs it)
BF16_ROW_ALIGN = 8
# kernel B's chunk (points a statistics partial sums) and its key sort's
# layout: warps a chunk, and the most buckets whose tables fit in shared
# memory (csrc/dpmm_kernels.cuh holds the same constants)
STATS_CHUNK = 16384
# the most bits of a whole-number row value whose chunk sums kernel B adds
# exactly: STATS_CHUNK * (2**LIMB_BITS - 1) < 2**24
LIMB_BITS = 24 - (STATS_CHUNK.bit_length() - 1)
_SORT_WARPS = 8
_SORT_SMEM_BUCKETS = 48 * 1024 // (4 * (_SORT_WARPS + 1))


# ---- the counter hash, uint32 emulated in int64 -----------------------------
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values; split in
    16-bit halves so no intermediate exceeds 2^49 (torch has no complete
    uint32 arithmetic, and a full 32x32 product would overflow int64)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64-held uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def tile_seeds(seed, rows: torch.Tensor, tile: int, tile_off: int = 0):
    """Per-row hash seed: fmix32(seed + (tile_off + row // tile) * golden)."""
    t = (tile_off + rows // tile) & _MASK32
    return _fmix32((_mul32(t, _GOLDEN) + (int(seed) & _MASK32)) & _MASK32)


def hash_bits(s: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """fmix32(fmix32(ctr + s) ^ (s * golden)), broadcast over s and ctr."""
    return _fmix32(_fmix32((ctr + s) & _MASK32) ^ _mul32(s, _GOLDEN))


def gumbel_noise(s: torch.Tensor, rows_in_tile: torch.Tensor, width: int):
    """[R, width] Gumbel noise for rows with hash seeds ``s`` [R] at counters
    ``row_in_tile * width + col``: u = (bits >> 8) * 2^-24 + 1e-12 in float32,
    G = -log(-log u)."""
    col = torch.arange(width, dtype=torch.int64, device=s.device)
    ctr = rows_in_tile[:, None] * width + col[None, :]
    bits = hash_bits(s[:, None], ctr)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    return -torch.log(-torch.log(u))


# ---- feature rows ------------------------------------------------------------
def feature_dim(family_name: str, d: int) -> int:
    """F of the rows a variant contracts (``d`` = the width of ``x``)."""
    if family_name in ("precomputed",) + _BF16:
        return d
    return _FAMILIES[family_name].feature_dim(d)


@functools.lru_cache(maxsize=None)
def feature_pairs(family_name: str, d: int, device) -> torch.Tensor:
    """The kernels' column map of a built variant, int32 [F]: column c is
    X[a] * X[b] with X = [1, x_0 .. x_{D-1}] and entry c = a << 16 | b, so
    the rows are ``family.features(x)``: (0, 0), (i+1, 0) for i < D, then,
    for the Gaussian, (i+1, j+1) over triu(x x^T) in row-major order."""
    pairs = [(0, 0)] + [(i + 1, 0) for i in range(d)]
    if family_name == "gaussian":
        pairs += [(i + 1, j + 1) for i in range(d) for j in range(i, d)]
    elif family_name != "multinomial":
        raise ValueError(f"no built rows for family_name={family_name!r}")
    return torch.tensor([a << 16 | b for a, b in pairs], dtype=torch.int32,
                        device=device)


def bf16_row_stride(f: int) -> int:
    """The row pitch, in values, of a bf16 cache of ``f`` features: ``f``
    rounded up to a multiple of :data:`BF16_ROW_ALIGN`."""
    return -(-f // BF16_ROW_ALIGN) * BF16_ROW_ALIGN


def empty_bf16_rows(n: int, f: int, device) -> torch.Tensor:
    """A bf16 cache ``[n, f]`` to fill: the first ``f`` columns of ``[n,
    bf16_row_stride(f)]`` rows whose columns past ``f`` are zeros."""
    ld = bf16_row_stride(f)
    buf = torch.empty((n, ld), dtype=torch.bfloat16, device=device)
    buf[:, f:] = 0
    return buf[:, :f]


def pad_bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """The bf16 cache ``x [N, F]`` in the port's layout
    (:func:`empty_bf16_rows`): the same values, rows 16-byte aligned and
    ``bf16_row_stride(F)`` apart.  A copy."""
    out = empty_bf16_rows(x.shape[0], x.shape[1], x.device)
    out.copy_(x)
    return out


def _aligned_rows(x: torch.Tensor) -> bool:
    """Whether a bf16 cache has the port's layout: unit stride along a row,
    rows starting on 16-byte boundaries (so every row does)."""
    return (x.stride(1) == 1 and x.stride(0) % BF16_ROW_ALIGN == 0
            and x.data_ptr() % 16 == 0)


def feature_rows(x, family_name: str) -> torch.Tensor:
    """The float32 feature rows of ``x`` under a variant (the family's
    ``features``; the cache's rows are themselves)."""
    x = x.to(torch.float32)
    if family_name in ("precomputed",) + _BF16:
        return x
    return _FAMILIES[family_name].features(x)


# ---- plain versions ----------------------------------------------------------
_PLAIN_ROWS = 1 << 16  # rows per step of the plain versions (bounds memory)


def stat_keys(labels, sub, valid, k: int) -> torch.Tensor:
    """Each point's bucket in kernel B: its key ``sub * k + label``, or
    ``2k`` where it adds nothing (invalid, label outside [0, k) or sub-label
    outside {0, 1})."""
    lab, side = labels.long(), sub.long()
    keep = valid.bool() & (lab >= 0) & (lab < k) & (side >= 0) & (side < 2)
    return torch.where(keep, side * k + lab, 2 * k)


def stats_from_labels_reference(x, labels, sub, valid, k: int,
                                family_name: str = "precomputed"):
    """Plain version of kernel B: ``[LEFT K | RIGHT K] x F`` float32 sums of
    the valid feature rows of ``x`` by (sub, label); a label outside [0, k)
    or a sub-label outside {0, 1} adds nothing, as in the kernel."""
    n = x.shape[0]
    f = feature_dim(family_name, x.shape[1])
    out = torch.zeros((2 * k, f), dtype=torch.float32, device=x.device)
    key = stat_keys(labels, sub, valid, k)
    for p0 in range(0, n, _PLAIN_ROWS):
        p1 = min(n, p0 + _PLAIN_ROWS)
        v = key[p0:p1] < 2 * k
        out.index_add_(0, key[p0:p1][v],
                       feature_rows(x[p0:p1], family_name)[v])
    return out


def key_sort_reference(labels, sub, valid, k: int, chunk: int = STATS_CHUNK):
    """Plain version of kernel B's key sort: per chunk of ``chunk`` points a
    stable sort of the points by :func:`stat_keys`.  Returns ``(perm int32
    [N], offsets int32 [ceil(N / chunk), 2k + 1])``: ``perm[c * chunk:]``
    holds chunk c's global point indices, each key's in ascending order, the
    dropped points last; ``offsets[c, j]`` is where key j starts within the
    chunk (``offsets[c, 2k]``: where the dropped points start)."""
    n = labels.shape[0]
    keys = stat_keys(labels, sub, valid, k)
    n_chunks = -(-n // chunk)
    perm = torch.empty(n, dtype=torch.int32, device=labels.device)
    offsets = torch.empty((n_chunks, 2 * k + 1), dtype=torch.int32,
                          device=labels.device)
    for c in range(n_chunks):
        p0, p1 = c * chunk, min(n, (c + 1) * chunk)
        seg = keys[p0:p1]
        perm[p0:p1] = (torch.argsort(seg, stable=True) + p0).to(torch.int32)
        counts = torch.bincount(seg, minlength=2 * k + 1)
        offsets[c] = (torch.cumsum(counts, 0) - counts)[:2 * k + 1].to(
            torch.int32)
    return perm, offsets


def ll_route(family_name: str, ll_precision: str) -> str:
    """The ll product kernel A computes for a variant at an
    ``ll_precision``: ``"bf16"``, ``"high"`` or ``"highest"``.  The setting
    itself, but ``"default"`` is ``"bf16"`` on a bf16 cache (its rows carry
    bf16 values only, and the JAX kernel casts phi to bf16 for it too) and
    ``"high"`` on float32 rows (where the JAX kernel's dot is
    float32-faithful).  One bf16 pass is not enough there: a cluster or
    sub-cluster of duplicate points has coefficients that cancel from ~1e5
    to O(1) at its own points, which one bf16 pass gets wrong by tens to
    hundreds of nats, so the chain stalls at the 50/50 saddle (ROADMAP
    Queue 3 P8)."""
    if ll_precision not in LL_PRECISIONS:
        raise ValueError(f"ll_precision must be one of {LL_PRECISIONS}; "
                         f"got {ll_precision!r}")
    if ll_precision == "default":
        return "bf16" if family_name in _BF16 else "high"
    return ll_precision


def ll_product(rows, phi_mat, ll_precision: str = "highest"):
    """Plain form of kernel A's ll product: float32 ``rows [R, F] @ phi_mat
    [F, 2K]``, under one of :func:`ll_route`'s products: ``"bf16"`` rounds
    both operands to bf16 first; ``"high"`` splits each into a bf16 ``hi``
    and the bf16 rounding ``lo`` of the rest and sums ``hi @ hi + hi @ lo +
    lo @ hi`` (the products of bf16 values are exact in float32, so only the
    order of the float32 sums is the implementation's own); ``"highest"``
    is the float32 product."""
    if ll_precision not in _PLANES:
        raise ValueError(f"ll_product's ll_precision must be one of "
                         f"{tuple(_PLANES)} (ll_route); got "
                         f"{ll_precision!r}")
    if ll_precision == "highest":
        return rows @ phi_mat
    r_hi, p_hi = rows.bfloat16().float(), phi_mat.bfloat16().float()
    if ll_precision == "bf16":
        return r_hi @ p_hi
    r_lo = (rows - r_hi).bfloat16().float()
    p_lo = (phi_mat - p_hi).bfloat16().float()
    return (r_hi @ p_lo + r_lo @ p_hi) + r_hi @ p_hi


def fused_assign_reference(x, valid, phi_mat, log_w, seed, tile_off=0,
                           hard=False, *, tile: int = 512,
                           family_name: str = "precomputed", x_raw=None,
                           ll_precision: str = "highest"):
    """Plain version of kernel A.  Returns ``(labels int32 [N], sub int32
    [N], stats float32 [2K, F] rows [LEFT | RIGHT])``."""
    n = x.shape[0]
    k = log_w.shape[0]
    seed = int(seed)
    route = ll_route(family_name, ll_precision)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    sub = torch.empty(n, dtype=torch.int32, device=x.device)
    noise = 0.0 if hard else 1.0
    for p0 in range(0, n, _PLAIN_ROWS):
        p1 = min(n, p0 + _PLAIN_ROWS)
        ll = ll_product(feature_rows(x[p0:p1], family_name), phi_mat,
                        route)                                  # [R, 2K]
        logits = ll[:, :k] + log_w[None, :]
        logits = torch.where(torch.isnan(logits), float("-inf"), logits)
        rows = torch.arange(p0, p1, dtype=torch.int64, device=x.device)
        s = tile_seeds(seed, rows, tile, tile_off)
        rit = rows % tile
        lab = torch.argmax(logits + gumbel_noise(s, rit, k) * noise, dim=-1)
        delta = ll[:, k:].gather(1, lab[:, None])[:, 0]
        g2 = gumbel_noise(s ^ _SUB_SALT, rit, 2)
        side = delta + (g2[:, 1] - g2[:, 0]) + 1e-30 > 0.0
        labels[p0:p1] = lab.to(torch.int32)
        sub[p0:p1] = side.to(torch.int32)
    if family_name == "hybrid":
        stats = stats_from_labels_reference(x_raw, labels, sub, valid, k,
                                            "gaussian")
    else:
        stats = stats_from_labels_reference(x, labels, sub, valid, k,
                                            family_name)
    return labels, sub, stats


# ---- wrappers ----------------------------------------------------------------
def delta_rows(phi_mat, k: int) -> torch.Tensor:
    """phi's delta columns as the rows of a contiguous ``[K, F]`` copy: the
    exact kernel computes each point's K whole columns only, then dots the
    point's row with row ``label`` of this copy."""
    return phi_mat[:, k:].T.contiguous()


def _check_cuda(name: str, rows_view: str = "", **tensors):
    """Device, dtype and shape of each tensor, and contiguity; the one named
    ``rows_view`` (a bf16 cache) may be a row view instead: unit stride
    along a row, rows at least a row apart."""
    dev = None
    for key, (t, dtype, shape) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        dev = t.device
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if key == rows_view:
            if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
                raise ValueError(f"{name}: {key} must hold its rows apart "
                                 f"with unit stride along a row; got "
                                 f"strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_variant(family_name: str, variants, x_raw=None) -> None:
    if family_name not in variants:
        raise ValueError(f"family_name must be one of {variants}; "
                         f"got {family_name!r}")
    if (x_raw is not None) != (family_name == "hybrid"):
        raise ValueError("x_raw (the raw points [N, D]) is given with, and "
                         "only with, family_name='hybrid'")


def _rows_arg(x, family_name: str):
    """(pairs tensor or None, d, F) for a variant's rows ``x`` (for
    "hybrid", ``x`` is its raw points)."""
    d = x.shape[1]
    if family_name == "hybrid":
        return feature_pairs("gaussian", d, x.device), d, feature_dim(
            "gaussian", d)
    f = feature_dim(family_name, d)
    if family_name in ("precomputed", "bfloat16"):
        return None, d, f
    return feature_pairs(family_name, d, x.device), d, f


def stats_scratch_sizes(n: int, k: int, f: int) -> tuple[int, int]:
    """Kernel B's scratch as ``(partial floats, order int32)``: the chunk
    partials ``[ceil(n / STATS_CHUNK), 2k, f]``, then the key sort's perm
    ``[n]``, offsets ``[n_chunks, 2k + 1]`` and, above ``_SORT_SMEM_BUCKETS``
    buckets, its tables ``[n_chunks, _SORT_WARPS + 1, 2k + 1]`` (the C
    side's ``stats_scratch_floats``, one float buffer holding both)."""
    n_chunks = -(-n // STATS_CHUNK)
    buckets = 2 * k + 1
    order = n + n_chunks * buckets
    if buckets > _SORT_SMEM_BUCKETS:
        order += n_chunks * (_SORT_WARPS + 1) * buckets
    return n_chunks * 2 * k * f, order


def _stats_scratch(n: int, k: int, f: int, device) -> torch.Tensor:
    return torch.empty(sum(stats_scratch_sizes(n, k, f)),
                       dtype=torch.float32, device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def stats_from_labels(x, labels, sub, valid, k: int,
                      family_name: str = "precomputed"):
    """``[LEFT K | RIGHT K] x F`` float32 statistics of the feature rows of
    ``x`` (see the module note on ``family_name``) by flat ``labels``/``sub``
    ``int32 [N]``, rows masked by ``valid bool [N]``.  Deterministic on the
    card (fixed-order partial sums)."""
    _check_variant(family_name, STATS_VARIANTS)
    if x.device.type == "cpu":
        return stats_from_labels_reference(x, labels, sub, valid, k,
                                           family_name)
    stats = _launch_stats(x, labels, sub, valid, k, family_name)
    stats_from_labels.launches[family_name] += 1
    return stats


def slot_sums(rows, labels, valid, k: int):
    """``int64 [K, C]`` exact sums of the float32 rows ``rows [N, C]``,
    whole numbers below ``2**LIMB_BITS`` in magnitude, by ``labels int32
    [N]``, rows masked by ``valid bool [N]``; a label outside [0, k) adds
    nothing.  On the card, kernel B's ``"precomputed"`` route with every
    sub-label 0: a chunk's float32 sums of such rows are whole numbers
    below 2**24, so exact, and the chunk partials are added here in int64,
    so the sums do not depend on the rows' order or on where ranks split
    them.  Counted in ``slot_sums.launches``, apart from
    ``stats_from_labels.launches``."""
    if rows.device.type == "cpu":
        keep = valid & (labels >= 0) & (labels < k)
        return torch.zeros((k, rows.shape[1]), dtype=torch.int64).index_add_(
            0, labels[keep].long(), rows[keep].to(torch.int64))
    n, f = rows.shape
    scratch = _stats_scratch(n, k, f, rows.device)
    n_part = stats_scratch_sizes(n, k, f)[0]
    scratch[:n_part].zero_()        # a key absent from a chunk writes none
    _launch_stats(rows, labels, torch.zeros_like(labels), valid, k,
                  "precomputed", scratch)
    slot_sums.launches += 1
    return scratch[:n_part].view(-1, 2 * k, f)[:, :k].to(torch.int64).sum(0)


def _launch_stats(x, labels, sub, valid, k: int, family_name: str,
                  scratch=None):
    """Kernel B on CUDA tensors (see :func:`stats_from_labels`), in
    ``scratch`` (:func:`stats_scratch_sizes`) when given."""
    n = x.shape[0]
    pairs, d, f = _rows_arg(x, family_name)
    bf16 = family_name == "bfloat16"
    _check_cuda("stats_from_labels", rows_view="x" if bf16 else "",
                x=(x, torch.bfloat16 if bf16 else torch.float32, (n, d)),
                labels=(labels, torch.int32, (n,)),
                sub=(sub, torch.int32, (n,)),
                valid=(valid, torch.bool, (n,)))
    stats = torch.empty((2 * k, f), dtype=torch.float32, device=x.device)
    if scratch is None:
        scratch = _stats_scratch(n, k, f, x.device)
    lib = _build.load()
    tail = (labels.data_ptr(), sub.data_ptr(), valid.data_ptr(), n, f, k,
            scratch.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if bf16:
        rc = lib.dpmm_stats_from_labels_bf16(x.data_ptr(), x.stride(0),
                                             *tail)
    else:
        rc = lib.dpmm_stats_from_labels(x.data_ptr(), _ptr(pairs), d, *tail)
    _build.check(rc, "stats_from_labels")
    return stats


def key_sort(labels, sub, valid, k: int):
    """Kernel B's first phase alone: ``(perm, offsets)`` as
    :func:`key_sort_reference` gives them, from the card's sort kernel on a
    CUDA tensor (counted in ``key_sort.launches``)."""
    if labels.device.type == "cpu":
        return key_sort_reference(labels, sub, valid, k)
    n = labels.shape[0]
    _check_cuda("key_sort", labels=(labels, torch.int32, (n,)),
                sub=(sub, torch.int32, (n,)), valid=(valid, torch.bool, (n,)))
    order = torch.empty(stats_scratch_sizes(n, k, 1)[1], dtype=torch.int32,
                        device=labels.device)
    rc = _build.load().dpmm_stats_key_sort(
        labels.data_ptr(), sub.data_ptr(), valid.data_ptr(), n, k,
        order.data_ptr(), torch.cuda.current_stream(labels.device).cuda_stream)
    _build.check(rc, "key_sort")
    key_sort.launches += 1
    n_chunks = -(-n // STATS_CHUNK)
    return order[:n], order[n:n + n_chunks * (2 * k + 1)].view(n_chunks,
                                                               2 * k + 1)


def _launch_key(family_name: str, cta_points: int) -> str:
    return (family_name if cta_points == FIT_CTA_POINTS
            else f"{family_name} cta={cta_points}")


def fused_assign(x, valid, phi_mat, log_w, seed, tile_off: int = 0,
                 hard: bool = False, *, tile: int = 512,
                 family_name: str = "precomputed", x_raw=None,
                 cta_points: int = FIT_CTA_POINTS,
                 ll_precision: str = "highest"):
    """One sweep's assignment + statistics pass.

    x       [N, F] float32 feature cache ("precomputed"), [N, D] raw
            points ("gaussian", "multinomial"; rows built in the kernel) or
            [N, F] bfloat16 feature cache ("bfloat16", "hybrid"; a row view
            may do, see the module note)
    x_raw   float32 [N, D] raw points of a "hybrid" container (its
            statistics rows), else None
    valid   bool [N]; invalid rows get labels but add no statistics
    phi_mat [F, 2K] float32, columns [whole K | delta K] (assign._delta_phi)
    log_w   [K] float32 mixture log-weights (-inf inactive); any K
    seed    int, or an int32 [1] tensor on the card (read by the kernel, so
            the sweep needs no host sync to draw it)
    hard    zero the label noise (sub-labels are always sampled)
    tile    rows per hash tile (the TPU kernel's tile; 512 by default)
    cta_points  points per CUDA block of the exact float32 assign pass:
            128, or 64 or 256 for "precomputed" at K <= 128 under "highest"
            (the results do not depend on it; launches count under
            "precomputed cta=64" and "... cta=256")
    ll_precision  the ll product (module note): "bf16" one bf16 pass on
            the tensor cores, "high" the three-pass split there, "default"
            the split on float32 rows and one pass on a bf16 cache,
            "highest" exact float32; the function's default is "highest",
            the config's "default"

    Returns ``(labels int32 [N], sub int32 [N], stats float32 [2K, F])``
    with stats rows ``[LEFT K | RIGHT K]``.
    """
    _check_variant(family_name, VARIANTS, x_raw)
    planes = _PLANES[ll_route(family_name, ll_precision)]
    tensor_cores = planes > 0
    if cta_points not in CTA_POINTS or (cta_points != FIT_CTA_POINTS and (
            family_name != "precomputed" or log_w.shape[0] > 128
            or tensor_cores)):
        raise ValueError(f"cta_points={cta_points}: {FIT_CTA_POINTS} for "
                         "every variant, 64 or 256 only for 'precomputed' at "
                         "K <= 128 under ll_precision='highest'")
    if x.device.type == "cpu":
        if torch.is_tensor(seed):
            seed = int(seed.reshape(-1)[0])
        return fused_assign_reference(x, valid, phi_mat, log_w, seed,
                                      tile_off, hard, tile=tile,
                                      family_name=family_name, x_raw=x_raw,
                                      ll_precision=ll_precision)
    n = x.shape[0]
    k = log_w.shape[0]
    hybrid = family_name == "hybrid"
    pairs, d, f = _rows_arg(x_raw if hybrid else x, family_name)
    if not torch.is_tensor(seed):
        seed = torch.tensor([int(seed)], dtype=torch.int32, device=x.device)
    rows = {"x": (x, torch.float32, (n, d))}
    if family_name in _BF16:
        # the bf16 cache [N, F]; for "hybrid" F is the Gaussian F of x_raw
        rows = {"x": (x, torch.bfloat16, (n, f))}
        if hybrid:
            rows["x_raw"] = (x_raw, torch.float32, (n, d))
    _check_cuda("fused_assign", rows_view="x" if family_name in _BF16
                else "", **rows,
                valid=(valid, torch.bool, (n,)),
                phi_mat=(phi_mat, torch.float32, (f, 2 * k)),
                log_w=(log_w, torch.float32, (k,)),
                seed=(seed, torch.int32, (1,)))
    # one bf16 pass over a bf16 cache at a pass width of 256 takes the
    # kernel of csrc/fused_assign_tc_tma.cuh, whose tensor map needs the
    # port's layout of the cache; the three-pass split copies a bf16 cache's
    # rows in 16-byte pieces from a 16-byte boundary on.  A cache in
    # another layout is copied into the port's for this call, with a
    # warning: the caller should lay it out once (pad_bf16_rows)
    tma = planes == 1 and family_name in _BF16 and k > 64
    ring = planes == 2 and k > 64   # csrc/fused_assign_tc_ring.cuh's kernel
    if (tma and not _aligned_rows(x)) or (
            planes == 2 and family_name in _BF16 and x.data_ptr() % 16):
        warnings.warn(
            "fused_assign: the bf16 cache is not in the port's layout (rows "
            "16-byte aligned, a multiple of 8 values apart); it is copied "
            "for every such call; lay it out once with "
            "sweep_kernels.pad_bf16_rows", RuntimeWarning, stacklevel=2)
        x = pad_bf16_rows(x)
    lib = _build.load()
    delta_t = phi_t = None
    if tensor_cores:
        # scratch for phi as the tensor-core pass stages it (its bf16 tiles)
        phi_t = torch.empty(lib.dpmm_assign_tc_scratch(f, k, planes),
                            dtype=torch.bfloat16, device=x.device)
    else:
        delta_t = delta_rows(phi_mat, k)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    sub = torch.empty(n, dtype=torch.int32, device=x.device)
    stats = torch.empty((2 * k, f), dtype=torch.float32, device=x.device)
    scratch = _stats_scratch(n, k, f, x.device)
    args = (valid.data_ptr(), phi_mat.data_ptr(), _ptr(delta_t), _ptr(phi_t),
            planes, log_w.data_ptr(), seed.data_ptr(), int(tile_off),
            int(bool(hard)),
            int(tile), n, f, k)
    outs = (labels.data_ptr(), sub.data_ptr(), scratch.data_ptr(),
            stats.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if family_name in _BF16:
        rc = lib.dpmm_fused_assign_bf16(x.data_ptr(), x.stride(0),
                                        _ptr(x_raw),
                                        _ptr(pairs), d, *args, *outs)
    else:
        rc = lib.dpmm_fused_assign(x.data_ptr(), _ptr(pairs), d, *args,
                                   cta_points // 16, *outs)
    _build.check(rc, "fused_assign")
    fused_assign.launches[_launch_key(family_name, cta_points)] += 1
    if tensor_cores:
        fused_assign.tensor_core_launches[family_name] += 1
    if tma:
        fused_assign.tma_launches[family_name] += 1
    if ring:
        fused_assign.ring_launches[family_name] += 1
    return labels, sub, stats


def reset_launches() -> None:
    """Set every launch count to 0."""
    fused_assign.launches = dict.fromkeys(
        VARIANTS + tuple(_launch_key("precomputed", c) for c in CTA_POINTS
                         if c != FIT_CTA_POINTS), 0)
    fused_assign.tensor_core_launches = dict.fromkeys(VARIANTS, 0)
    fused_assign.tma_launches = dict.fromkeys(_BF16, 0)
    fused_assign.ring_launches = dict.fromkeys(VARIANTS, 0)
    stats_from_labels.launches = dict.fromkeys(STATS_VARIANTS, 0)
    slot_sums.launches = 0
    key_sort.launches = 0


reset_launches()
