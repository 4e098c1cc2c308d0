"""Clustering quality metrics: NMI and variation of information.

The reference uses Clustering.jl's ``mutualinfo(..., normed=true)`` and
``varinfo`` per iteration when ground truth is supplied
(src/dp-parallel-sampling.jl:370-377).  Implemented here directly on
contingency tables (sklearn-free so they also run in minimal environments);
NMI uses the sqrt normalization ``I / sqrt(Hx * Hy)`` matching Clustering.jl.
"""
from __future__ import annotations

import numpy as np


def _contingency(a: np.ndarray, b: np.ndarray):
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    na, nb = ai.max() + 1, bi.max() + 1
    table = np.zeros((na, nb), np.float64)
    np.add.at(table, (ai, bi), 1.0)
    return table


def _entropies(table: np.ndarray):
    n = table.sum()
    p = table / n
    px = p.sum(1)
    py = p.sum(0)

    def h(q):
        q = q[q > 0]
        return -np.sum(q * np.log(q))

    hx, hy = h(px), h(py)
    nz = p > 0
    mi = np.sum(p[nz] * (np.log(p[nz]) - np.log(np.outer(px, py)[nz])))
    return hx, hy, mi


def nmi(a, b) -> float:
    """Normalized mutual information, sqrt normalization."""
    hx, hy, mi = _entropies(_contingency(np.asarray(a), np.asarray(b)))
    denom = np.sqrt(hx * hy)
    return float(mi / denom) if denom > 0 else 0.0


def varinfo(a, b) -> float:
    """Variation of information: Hx + Hy - 2*MI."""
    hx, hy, mi = _entropies(_contingency(np.asarray(a), np.asarray(b)))
    return float(hx + hy - 2 * mi)


def get_labels_histogram(labels):
    """Sorted {label: count} dict (reference src/utils.jl:39-48)."""
    vals, counts = np.unique(np.asarray(labels), return_counts=True)
    return dict(sorted(zip(vals.tolist(), counts.tolist())))
