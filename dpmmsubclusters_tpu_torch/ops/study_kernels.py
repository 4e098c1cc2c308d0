"""The kernels of the port's kernel studies (``benchmarks/``): wrappers
around the hand-written CUDA kernels of ``csrc/`` and, beside each, its
plain PyTorch version.

* :func:`column_sum` (kernel C, ``csrc/column_sum.cu``) -- the column sums
  of a row-major float32 ``[N, F]`` matrix.  Replaces the ``dma_only`` mode
  of ``benchmarks/kernel_tile_study.py:30`` ``variant`` (the TPU study's
  full modes are kernel A, :func:`.sweep_kernels.fused_assign`).
* :func:`kernel_ablate` (kernel D, ``csrc/kernel_ablate.cu``) -- the
  round-3 assignment kernel (phi ``[F, 3K]`` = ``[whole | left | right]``,
  the exact float32 product) with each stage gated; its ``dot_only`` set is
  kernel C's column sums times phi.  Replaces
  ``benchmarks/kernel_ablate.py:141`` ``variant``.

As in :mod:`.sweep_kernels`, a CUDA tensor launches the kernel (or raises),
a CPU tensor runs the plain version, and each wrapper counts its launches
(``column_sum.launches``; ``kernel_ablate.launches`` by stage set).  A
launch is one call into the library: the scratch it needs is sized once per
card and shape and kept per card and stream (:func:`_scratch`).
"""
from __future__ import annotations

import functools

import torch

from . import _build
from .sweep_kernels import (_PLAIN_ROWS, _SUB_SALT, _check_cuda, gumbel_noise,
                            stats_from_labels_reference, tile_seeds)

# kernel D's stage sets, those of the ablation (benchmarks/kernel_ablate.py
# VARIANTS), each with its name and the bit mask csrc/kernel_ablate.cu
# switches on (DMA_ONLY 1, DOT_ONLY 2, STATS_RAW 4, STATS 8, GUMBEL 16,
# SUB 32, WRITE 64)
STAGE_SETS = {
    frozenset(("dma_only",)): ("dma_only", 1),
    frozenset(("dot_only",)): ("dot_only", 2),
    frozenset(): ("none", 0),
    frozenset(("stats_raw",)): ("stats_raw", 4),
    frozenset(("stats",)): ("stats", 8),
    frozenset(("stats", "gumbel")): ("stats+gumbel", 24),
    frozenset(("stats", "gumbel", "sub")): ("stats+gumbel+sub", 56),
    frozenset(("stats", "gumbel", "sub", "write")):
        ("stats+gumbel+sub+write", 120),
}


def _stage_set(stages) -> tuple:
    """``(name, mask)`` of a stage set; raises for a set not in
    STAGE_SETS."""
    try:
        return STAGE_SETS[frozenset(stages)]
    except KeyError:
        raise ValueError(
            f"kernel D is built for the stage sets "
            f"{[name for name, _ in STAGE_SETS.values()]}; got "
            f"{tuple(stages)}") from None


def stage_key(stages) -> str:
    """The name of a stage set: its stages joined by "+", "none" for ()."""
    return _stage_set(stages)[0]


# Floats of scratch a launch takes on card ``index`` (kernel C's partial
# rows follow the card's SM count), asked of the library once per card and
# shape: kernel C's over [n, f], kernel D's for a stage set ``mask``.
@functools.lru_cache(maxsize=64)
def _column_scratch(index: int, n: int, f: int) -> int:
    return _build.load().dpmm_column_partials(n) * f


@functools.lru_cache(maxsize=64)
def _ablate_scratch(index: int, n: int, f: int, k: int, mask: int) -> int:
    return _build.load().dpmm_ablate_scratch(n, f, k, mask)


_SCRATCH = {}


def _scratch(dev, stream: int, floats: int) -> torch.Tensor:
    """Float32 scratch of at least ``floats`` on ``dev``, one buffer per
    card and stream, kept between launches and grown when a launch needs
    more (the launches of one stream run in order, so they can share it)."""
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
        _SCRATCH[(dev, stream)] = buf
    return buf


# ---- kernel C ----------------------------------------------------------------
def column_sum_reference(x, out=None):
    """Plain version of kernel C: every row of ``out`` ([R, F], [1, F] if
    None) set to the float32 column sums of ``x`` [N, F]."""
    if out is None:
        out = torch.empty((1, x.shape[1]), dtype=torch.float32,
                          device=x.device)
    out.copy_(x.to(torch.float32).sum(0).expand_as(out))
    return out


def column_sum(x, out=None):
    """Every row of ``out`` ([R, F] float32, [1, F] if None) set to the
    column sums of ``x`` (float32 [N, F]); deterministic on the card (chunk
    partials summed in a fixed order).  Returns ``out``."""
    if x.device.type == "cpu":
        return column_sum_reference(x, out)
    n, f = x.shape
    if out is None:
        out = torch.empty((1, f), dtype=torch.float32, device=x.device)
    _check_cuda("column_sum", x=(x, torch.float32, (n, f)),
                out=(out, torch.float32, (out.shape[0], f)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = _scratch(x.device, stream,
                       _column_scratch(x.device.index, n, f))
    rc = _build.load().dpmm_column_sum(x.data_ptr(), n, f, partial.data_ptr(),
                                       out.data_ptr(), out.shape[0], stream)
    _build.check(rc, "column_sum")
    column_sum.launches += 1
    return out


# ---- kernel D ----------------------------------------------------------------
def kernel_ablate_reference(x, valid, phi, log_w, loglrw, seed, *,
                            tile: int = 512, stages=()):
    """Plain version of kernel D.  ``x`` float32 [N, F], ``valid`` bool
    [N], ``phi`` [F, 3K] columns [whole | left | right], ``log_w`` [K],
    ``loglrw`` [2, K] (left, right), ``seed`` int.  Returns ``(labels int32
    [N], sub int32 [N], stats float32 [2K, F])``; what a stage set does not
    write is zero (see ``csrc/kernel_ablate.cu``).  ``stages`` is one of
    STAGE_SETS."""
    key = _stage_set(stages)[0]
    stages = key.split("+")
    n, f = x.shape
    k = log_w.shape[0]
    dev = x.device
    labels = torch.zeros(n, dtype=torch.int32, device=dev)
    sub = torch.zeros(n, dtype=torch.int32, device=dev)
    stats = torch.zeros((2 * k, f), dtype=torch.float32, device=dev)
    if key == "dma_only":
        column_sum_reference(x, stats[:1])
        return labels, sub, stats
    if key == "dot_only":
        if 3 * k > f:
            raise ValueError(f"dot_only needs 3K <= F; K={k}, F={f}")
        for p0 in range(0, n, _PLAIN_ROWS):
            stats[0, :3 * k] += (x[p0:p0 + _PLAIN_ROWS] @ phi).sum(0)
        return labels, sub, stats
    lab = torch.empty(n, dtype=torch.int32, device=dev)
    side = torch.zeros(n, dtype=torch.int32, device=dev)
    for p0 in range(0, n, _PLAIN_ROWS):
        p1 = min(n, p0 + _PLAIN_ROWS)
        ll = x[p0:p1] @ phi                                      # [R, 3K]
        logits = ll[:, :k] + log_w[None, :]
        rows = torch.arange(p0, p1, dtype=torch.int64, device=dev)
        s = tile_seeds(seed, rows, tile)
        rit = rows % tile
        if "gumbel" in stages:
            logits = torch.where(torch.isnan(logits), float("-inf"), logits)
            logits = logits + gumbel_noise(s, rit, k)
        j = torch.argmax(logits, dim=-1)
        lab[p0:p1] = j.to(torch.int32)
        if "sub" in stages:
            pick_l = ll[:, k:2 * k].gather(1, j[:, None])[:, 0] + loglrw[0, j]
            pick_r = ll[:, 2 * k:].gather(1, j[:, None])[:, 0] + loglrw[1, j]
            g2 = gumbel_noise(s ^ _SUB_SALT, rit, 2)
            side[p0:p1] = (pick_r + g2[:, 1] > pick_l + g2[:, 0]).to(
                torch.int32)
    if "write" in stages:
        labels, sub = lab, side
    if "stats" in stages:
        stats = stats_from_labels_reference(x, lab, side, valid, k)
    elif "stats_raw" in stages:
        column_sum_reference(x, stats)
    return labels, sub, stats


def kernel_ablate(x, valid, phi, log_w, loglrw, seed, *, tile: int = 512,
                  stages=()):
    """Kernel D over ``x`` for one stage set (arguments and results as
    :func:`kernel_ablate_reference`; ``seed`` an int or an int32 [1] tensor
    on the card).  On the card K <= 128."""
    key, mask = _stage_set(stages)
    if x.device.type == "cpu":
        if torch.is_tensor(seed):
            seed = int(seed.reshape(-1)[0])
        return kernel_ablate_reference(x, valid, phi, log_w, loglrw, seed,
                                       tile=tile, stages=stages)
    stages = key.split("+")
    n, f = x.shape
    k = log_w.shape[0]
    if not 1 <= k <= 128:
        raise ValueError(f"kernel D takes 1 <= K <= 128; got K={k}")
    if key == "dot_only" and 3 * k > f:
        raise ValueError(f"dot_only needs 3K <= F; K={k}, F={f}")
    dev = x.device
    checks = dict(x=(x, torch.float32, (n, f)),
                  valid=(valid, torch.bool, (n,)),
                  phi=(phi, torch.float32, (f, 3 * k)),
                  log_w=(log_w, torch.float32, (k,)),
                  loglrw=(loglrw, torch.float32, (2, k)))
    if key in ("dma_only", "dot_only"):
        seed = None     # column sums only: no hash, so no seed on the card
    else:
        if not torch.is_tensor(seed):
            seed = torch.tensor([int(seed)], dtype=torch.int32, device=dev)
        checks["seed"] = (seed, torch.int32, (1,))
    _check_cuda("kernel_ablate", **checks)
    # the kernel's label and side stores: the outputs under "write";
    # scratch for the statistics pass under "stats" alone; else the
    # zero outputs themselves, stored to only if sink (0) were set
    new = torch.empty if "write" in stages else torch.zeros
    labels, sub = new((2, n), dtype=torch.int32, device=dev)
    lab_st, sub_st = labels, sub
    if "stats" in stages and "write" not in stages:
        lab_st = torch.empty(n, dtype=torch.int32, device=dev)
        sub_st = torch.empty(n, dtype=torch.int32, device=dev)
    full = "stats" in stages or "stats_raw" in stages
    stats = (torch.empty if full else torch.zeros)(
        (2 * k, f), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = _scratch(dev, stream, _ablate_scratch(dev.index, n, f, k, mask))
    rc = _build.load().dpmm_kernel_ablate(
        x.data_ptr(), valid.data_ptr(), phi.data_ptr(), log_w.data_ptr(),
        loglrw.data_ptr(), None if seed is None else seed.data_ptr(),
        int(tile), n, f, k, mask, 0,
        lab_st.data_ptr(), sub_st.data_ptr(), partial.data_ptr(),
        stats.data_ptr(), stream)
    _build.check(rc, "kernel_ablate")
    kernel_ablate.launches[key] += 1
    return labels, sub, stats


def reset_launches() -> None:
    """Set every launch count of the study kernels to 0."""
    column_sum.launches = 0
    kernel_ablate.launches = {name: 0 for name, _ in STAGE_SETS.values()}


reset_launches()
