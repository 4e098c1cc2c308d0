"""Smart split initialization: PCA projection + 1-D 2-means sub-labels.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.smart`
(reference ``smart_cluster_init!``, src/local_clusters_actions.jl:555-653),
for every marked slot at once: top eigenvector of each slot's covariance by
power iteration, per-point projection, 2-means seeded at mean +/- std, and
Lloyd iterations.  The per-slot sums are ``index_add_`` on the host and
exact fixed-point sums on kernel B on a card (the JAX version's chunked
one-hot matmuls exist for the TPU's scatter cost).
"""
from __future__ import annotations

import torch

from ..ops import sweep_kernels as sk
from ..utils import profiling


def _power(mat: torch.Tensor, v: torch.Tensor, iters: int) -> torch.Tensor:
    for _ in range(iters):
        w = torch.einsum("kde,ke->kd", mat, v)
        nrm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = torch.where(nrm > 1e-20, w / torch.clamp(nrm, min=1e-20), v)
    return v


def top_eigvec(mat: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Principal eigenvector of a batch of symmetric PSD matrices [K, D, D]
    by power iteration from the uniform vector, as the JAX package starts,
    and from the alternating-sign vector; the second is kept where its
    Rayleigh quotient is larger by more than 1e-4.  A uniform start that is
    itself an eigenvector (points placed symmetrically, e.g. three corners
    of a square, whose minor axis is the diagonal) never leaves it in
    exact arithmetic, and the 2-means would then split along the minor
    axis; the JAX package escapes such a start only by its rounding."""
    k, d, _ = mat.shape
    u = torch.full((k, d), d ** -0.5, dtype=mat.dtype, device=mat.device)
    sign = 1.0 - 2.0 * (torch.arange(d, device=mat.device) % 2)
    v1, v2 = _power(mat, u, iters), _power(mat, u * sign, iters)

    def rayleigh(v):
        return torch.einsum("kd,kde,ke->k", v, mat, v)

    better = rayleigh(v2) > rayleigh(v1) * (1.0 + 1e-4) + 1e-30
    return torch.where(better[:, None], v2, v1)


# bits of the card's fixed-point values below their slot and column's
# largest magnitude, in limbs of LIMB_BITS; a largest magnitude below
# 2**LOW_EXP counts as 2**LOW_EXP
FIXED_BITS = 40
LIMBS = -(-FIXED_BITS // sk.LIMB_BITS)
LOW_EXP = -80
# copies of the per-slot maxima, so few rows contend for one
MAX_COPIES = 64


def _same(t):
    return t


def _slot_sums(labels, vals, k: int, keep=None, layout=None):
    """[K, C] per-slot sums of the [N, C] rows ``vals`` over the rows where
    ``keep`` (bool [N]; every row when None), summed over ``layout``'s ranks
    (``reduce``; a world of one when None).  On the host, ``index_add_``
    in row order over every row, so the rows ``keep`` drops must be zeros.
    On a card, :func:`_exact_slot_sums`."""
    if keep is None:
        keep = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    reduce = _same if layout is None else layout.reduce
    if vals.is_cuda:
        return _exact_slot_sums(labels, vals, k, keep, reduce,
                                _same if layout is None else layout.reduce_max)
    out = torch.zeros((k, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return reduce(out.index_add_(0, labels, vals))


def _pow2(e):
    """2.0**e as float32 (int32 ``e`` in [-126, 127]), from its bits."""
    return ((e + 127) << 23).view(torch.float32)


def _exact_slot_sums(labels, vals, k: int, keep, reduce, reduce_max):
    """:func:`_slot_sums` of float32 ``vals``, exact up to each value's
    rounding to ``FIXED_BITS`` bits below its slot and column's largest
    magnitude over every rank, then one rounding to float32.  The rounded
    values are whole numbers, split into ``LIMBS`` limbs for
    :func:`~..ops.sweep_kernels.slot_sums` (kernel B on a card, counted as
    ``smart_sums``) and summed over ranks in float64, all exactly: so the
    sums are the same bits in every run, in any order of the rows and at
    any split of them over ranks."""
    if vals.dtype != torch.float32:
        raise TypeError(f"the smart pass's sums take float32 rows, not "
                        f"{vals.dtype}")
    profiling.count("smart_sums")
    n, c = vals.shape
    lab = torch.where(keep, labels, 0).long()
    # |v| < 2**e for e its biased exponent less 126 (zero and subnormals
    # included); the largest e of each slot and column, over every rank
    exp = torch.where(keep[:, None],
                      ((vals.view(torch.int32) >> 23) & 0xFF) - 126, LOW_EXP)
    copy = lab * MAX_COPIES + (torch.arange(n, device=vals.device)
                               % MAX_COPIES)
    top = torch.full((k * MAX_COPIES, c), LOW_EXP, dtype=torch.int32,
                     device=vals.device).scatter_reduce_(
        0, copy[:, None].expand(n, c), exp, "amax")
    shift = FIXED_BITS - reduce_max(top.view(k, MAX_COPIES, c).amax(1))
    # whole numbers below 2**FIXED_BITS (exact float32 scaling and
    # rounding), split by exact float32 steps into signed limbs; the scale
    # gathered along the table's last dimension (rows of four floats take
    # a gather that is 10x slower on an H100)
    q = torch.round(vals * _pow2(shift).t()[:, lab].t())
    mag = q.abs()
    limbs = torch.empty((n, c, LIMBS), device=vals.device)
    for j in range(LIMBS):
        torch.floor(mag * 2.0 ** (-sk.LIMB_BITS * j), out=limbs[:, :, j])
    limbs.remainder_(2.0 ** sk.LIMB_BITS).copysign_(q[:, :, None])
    sums = reduce(sk.slot_sums(limbs.view(n, c * LIMBS),
                               labels.to(torch.int32), keep, k).double())
    sums = sums.view(k, c, LIMBS)
    whole = sum(sums[:, :, j] * 2.0 ** (sk.LIMB_BITS * j)
                for j in range(LIMBS))
    return (whole * _pow2(-shift).double()).float()


def smart_sublabels(points, valid, labels, sublabels, stats_w, slots_mask,
                    max_iter: int, layout=None) -> torch.Tensor:
    """Sub-labels (int32 [N]) with the points of marked slots set by the
    projected 2-means; all other points keep their current sub-label.

    points [N, D] raw points; valid bool [N]; labels/sublabels int32 [N];
    stats_w whole-side stats (n [K], sum_x [K, D], sum_xx [K, D, D]);
    slots_mask bool [K].  The Lloyd loop checks its movement tolerance on
    the host (one sync per iteration, at most ``max_iter``, and one for the
    tolerance).  Across ranks the per-slot sums (the projection moments
    and each Lloyd step's) are summed over ``layout``'s ranks (a
    :class:`~..parallel.distributed.RowLayout`; a world of one when None),
    so the tolerance and the movement the host reads are the same on every
    rank."""
    k = slots_mask.shape[0]
    nk = torch.clamp(stats_w["n"], min=1.0)
    mu = stats_w["sum_x"] / nk[:, None]
    cov = stats_w["sum_xx"] / nk[:, None, None] - mu[:, :, None] * mu[:, None, :]
    v = top_eigvec(cov)

    lab = labels.long()
    off = (mu * v).sum(-1)                       # projected-mean offset
    t = (points * v[lab]).sum(-1) - off[lab]     # [N]
    w = slots_mask.to(points.dtype)[lab] * valid.to(points.dtype)
    keep = w > 0
    acc = _slot_sums(labels, torch.stack([w, w * t, w * t * t], dim=-1), k,
                     keep, layout)
    cnt = torch.clamp(acc[:, 0], min=1.0)
    mean = acc[:, 1] / cnt
    var = acc[:, 2] / cnt - mean ** 2
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    m = torch.stack([mean - std, mean + std], dim=-1)       # [K, 2]

    def sides(m):
        m_pt = m[lab]
        return (torch.abs(t - m_pt[:, 1]) < torch.abs(t - m_pt[:, 0])).to(
            points.dtype)

    # 1-D 2-means converges in a handful of iterations; the movement
    # tolerance is relative to the projection spread
    tol = 1e-3 * profiling.host_read(torch.clamp(std.max(), min=1e-12),
                                     "smart_tol")
    for _ in range(max_iter):
        side = sides(m)
        s = _slot_sums(labels, torch.stack(
            [w * (1.0 - side), w * side, w * (1.0 - side) * t, w * side * t],
            dim=-1), k, keep, layout)
        m2 = torch.stack([
            torch.where(s[:, 0] > 0, s[:, 2] / torch.clamp(s[:, 0], min=1.0),
                        m[:, 0]),
            torch.where(s[:, 1] > 0, s[:, 3] / torch.clamp(s[:, 1], min=1.0),
                        m[:, 1]),
        ], dim=-1)
        move = profiling.host_read((m2 - m).abs().max(), "smart_lloyd")
        m = m2
        if not move > tol:
            break
    return torch.where(keep, sides(m).to(sublabels.dtype), sublabels)
