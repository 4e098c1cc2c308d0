"""Plain float64 reference of the Gaussian/NIW sub-cluster sampler's
per-sweep arithmetic, and its control in a lower precision.

What it computes, from the raw points and the sampler's state (its drawn
parameters and its table's statistics):

* a point's Gaussian log-density under a drawn (mu, precision), as the
  inner product of the point's feature row [1, x, x_i x_j (i <= j, row
  major)] with coefficients worked out here from mu and the precision;
* the sufficient statistics (count, sum x, sum x x^T) of the points by
  (label, sub-label), in the same row layout;
* the Normal-Inverse-Wishart posterior of a prior and statistics
  (``psi`` is the scale divided by nu, the layout the sampler keeps);
* NMI with the square-root normalisation.

``quantize`` rounds a float64 tensor to a lower precision: bfloat16, or
float8 e4m3 with one amax scale per column, the step below bfloat16.

A configuration names its family's reference module by path (its
``reference`` key); the judge takes from it ``feature_dim``, ``features``,
``coeffs``, ``sums_by_key``, ``quantize``, ``LOWER``, ``default_prior``,
``standardized_prior``, ``posterior`` and ``nmi`` (``nmi_of_table`` where
the labels are counted by rank).
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
FP8_MAX = 448.0
LOWER = {"float64": "float32", "float32": "bfloat16", "bfloat16": "float8"}


def feature_dim(d: int) -> int:
    return 1 + d + d * (d + 1) // 2


def _triu(d: int, device):
    return torch.triu_indices(d, d, device=device)


def features(x: torch.Tensor) -> torch.Tensor:
    """float64 rows [1, x, x_i x_j for i <= j in row-major order]."""
    x = x.to(torch.float64)
    iu, ju = _triu(x.shape[1], x.device)
    one = torch.ones((x.shape[0], 1), dtype=torch.float64, device=x.device)
    return torch.cat([one, x, x[:, iu] * x[:, ju]], dim=1)


def loglik_coeffs(mu: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """[F, K] float64 coefficients c_k with features(x) @ c_k = log N(x;
    mu_k, prec_k^-1), from mu [K, D] and a precision [K, D, D]."""
    mu = mu.to(torch.float64)
    p = prec.to(torch.float64)
    p = 0.5 * (p + p.mT)
    d = mu.shape[-1]
    logdet_p = 2.0 * torch.log(torch.diagonal(
        torch.linalg.cholesky(p), dim1=-2, dim2=-1)).sum(-1)
    h = torch.einsum("kij,kj->ki", p, mu)
    c = -0.5 * (d * LOG_2PI - logdet_p + (mu * h).sum(-1))
    iu, ju = _triu(d, mu.device)
    quad = -0.5 * p[:, iu, ju] * torch.where(iu == ju, 1.0, 2.0).to(p.dtype)
    return torch.cat([c[:, None], h, quad], dim=1).T.contiguous()


def coeffs(params: dict, side: int, slots=None) -> torch.Tensor:
    """[F, K] coefficients of a table's drawn parameters (``mu`` [K, 3,
    D], ``prec`` [K, 3, D, D]) of ``side`` (0 whole, 1 left, 2 right), of
    ``slots`` alone where given."""
    mu, prec = params["mu"][:, side], params["prec"][:, side]
    if slots is not None:
        mu, prec = mu[slots], prec[slots]
    return loglik_coeffs(mu, prec)


def quantize(t: torch.Tensor, precision: str, dim: int = 0) -> torch.Tensor:
    """``t`` rounded to ``precision`` ("float64", "float32", "bfloat16",
    "float8") and returned as float32 values (float64 for "float64").
    float8 is e4m3 with one amax scale per slice along ``dim`` (per column
    for dim 0)."""
    if precision == "float64":
        return t.to(torch.float64)
    if precision == "float32":
        return t.to(torch.float32)
    if precision == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    if precision == "float8":
        amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / FP8_MAX
        q = (t / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
        return (q.to(torch.float64) * scale).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def sums_by_key(rows: torch.Tensor, key: torch.Tensor, n_keys: int):
    """[n_keys, F] sums of ``rows`` by ``key`` (keys outside [0, n_keys)
    add nothing), as one one-hot product in the rows' dtype."""
    keep = (key >= 0) & (key < n_keys)
    onehot = torch.zeros((rows.shape[0], n_keys), dtype=rows.dtype,
                         device=rows.device)
    idx = torch.nonzero(keep)[:, 0]
    onehot[idx, key[idx]] = 1.0
    return onehot.T @ rows


def niw_posterior(prior: dict, stats: dict, dtype=torch.float64) -> dict:
    """NIW posterior (kappa, m, nu, psi) of per-slot ``prior`` [...] and
    ``stats`` {n [...], sum_x [..., D], sum_xx [..., D, D]}, computed in
    ``dtype``; slots with n == 0 keep the prior."""
    c = {k: v.to(dtype) for k, v in prior.items()}
    s = {k: v.to(dtype) for k, v in stats.items()}
    n = s["n"]
    kappa = c["kappa"] + n
    nu = c["nu"] + n
    m = (c["kappa"][..., None] * c["m"] + s["sum_x"]) / kappa[..., None]
    outer = lambda v: v[..., :, None] * v[..., None, :]
    psi = (c["nu"][..., None, None] * c["psi"]
           + c["kappa"][..., None, None] * outer(c["m"])
           - kappa[..., None, None] * outer(m) + s["sum_xx"]) \
        / nu[..., None, None]
    psi = 0.5 * (psi + psi.mT)
    has = n > 0
    return {"kappa": torch.where(has, kappa, c["kappa"]),
            "m": torch.where(has[..., None], m, c["m"]),
            "nu": torch.where(has, nu, c["nu"]),
            "psi": torch.where(has[..., None, None], psi, c["psi"])}


posterior = niw_posterior


def default_prior(d: int, device) -> dict:
    """The configurations' prior, NIW(kappa 1, m 0, nu D + 3, psi I)."""
    f64 = torch.float64
    return {"kappa": torch.ones((), dtype=f64, device=device),
            "m": torch.zeros(d, dtype=f64, device=device),
            "nu": torch.full((), d + 3.0, dtype=f64, device=device),
            "psi": torch.eye(d, dtype=f64, device=device)}


def standardized_prior(prior: dict, mean: torch.Tensor,
                       scale: torch.Tensor) -> dict:
    """``prior`` of the raw points carried over to the points
    standardized as ``(x - mean) * scale``."""
    return {**prior, "m": (prior["m"] - mean) * scale,
            "psi": prior["psi"] * (scale[:, None] * scale[None, :])}


def nmi(a: torch.Tensor, b: torch.Tensor) -> float:
    """Normalised mutual information I / sqrt(H_a H_b) of two labelings."""
    _, ai = torch.unique(a, return_inverse=True)
    _, bi = torch.unique(b, return_inverse=True)
    na, nb = int(ai.max()) + 1, int(bi.max()) + 1
    table = torch.bincount(ai.long() * nb + bi.long(), minlength=na * nb)
    return nmi_of_table(table.view(na, nb))


def nmi_of_table(table: torch.Tensor) -> float:
    """:func:`nmi` of the two labelings whose contingency table (counts by
    (a, b); empty rows and columns add nothing) is ``table``."""
    t = table[table.sum(1) > 0][:, table.sum(0) > 0]
    p = t.to(torch.float64) / float(t.sum())
    pa, pb = p.sum(1), p.sum(0)

    def entropy(q):
        q = q[q > 0]
        return float(-(q * torch.log(q)).sum())

    nz = p > 0
    mi = float((p[nz] * (torch.log(p[nz])
                         - torch.log(torch.outer(pa, pb)[nz]))).sum())
    denom = math.sqrt(entropy(pa) * entropy(pb))
    return mi / denom if denom > 0 else 0.0
