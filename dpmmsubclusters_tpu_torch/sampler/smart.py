"""Smart split initialization: PCA projection + 1-D 2-means sub-labels.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.sampler.smart`
(reference ``smart_cluster_init!``, src/local_clusters_actions.jl:555-653),
for every marked slot at once: top eigenvector of each slot's covariance by
power iteration, per-point projection, 2-means seeded at mean +/- std, and
Lloyd iterations.  The per-slot sums are ``index_add_`` reductions (the JAX
version's chunked one-hot matmuls exist for the TPU's scatter cost).
"""
from __future__ import annotations

import torch


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


def _slot_sums(labels: torch.Tensor, vals: torch.Tensor, k: int):
    """[K, C] per-slot sums of the [N, C] rows ``vals``."""
    out = torch.zeros((k, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, labels, vals)


def smart_sublabels(points, valid, labels, sublabels, stats_w, slots_mask,
                    max_iter: int) -> torch.Tensor:
    """Sub-labels (int32 [N]) with the points of marked slots set by the
    projected 2-means; all other points keep their current sub-label.

    points [N, D] raw points; valid bool [N]; labels/sublabels int32 [N];
    stats_w whole-side stats (n [K], sum_x [K, D], sum_xx [K, D, D]);
    slots_mask bool [K].  The Lloyd loop checks its movement tolerance on
    the host (one sync per iteration, at most ``max_iter``)."""
    k = slots_mask.shape[0]
    nk = torch.clamp(stats_w["n"], min=1.0)
    mu = stats_w["sum_x"] / nk[:, None]
    cov = stats_w["sum_xx"] / nk[:, None, None] - mu[:, :, None] * mu[:, None, :]
    v = top_eigvec(cov)

    lab = labels.long()
    off = (mu * v).sum(-1)                       # projected-mean offset
    t = (points * v[lab]).sum(-1) - off[lab]     # [N]
    w = slots_mask.to(points.dtype)[lab] * valid.to(points.dtype)
    acc = _slot_sums(lab, torch.stack([w, w * t, w * t * t], dim=-1), k)
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
    tol = 1e-3 * float(torch.clamp(std.max(), min=1e-12))
    for _ in range(max_iter):
        side = sides(m)
        s = _slot_sums(lab, torch.stack(
            [w * (1.0 - side), w * side, w * (1.0 - side) * t, w * side * t],
            dim=-1), k)
        m2 = torch.stack([
            torch.where(s[:, 0] > 0, s[:, 2] / torch.clamp(s[:, 0], min=1.0),
                        m[:, 0]),
            torch.where(s[:, 1] > 0, s[:, 3] / torch.clamp(s[:, 1], min=1.0),
                        m[:, 1]),
        ], dim=-1)
        move = float((m2 - m).abs().max())
        m = m2
        if not move > tol:
            break
    return torch.where(w > 0, sides(m).to(sublabels.dtype), sublabels)
