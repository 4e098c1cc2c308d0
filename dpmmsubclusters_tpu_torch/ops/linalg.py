"""Batched linear-algebra / special-function primitives for the DPMM sampler.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.ops.linalg`: the same
functions with the same masking semantics (inactive slots contribute exactly
0, never NaN), batched over leading dimensions.  Random draws take an
explicit ``torch.Generator`` that lives on the tensors' device.

All table math stays float32.  The only matrix products here are
``[..., D, D]`` batches, which run in full float32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's default).
"""
from __future__ import annotations

import math

import torch

LOG_PI = math.log(math.pi)
LOG_2PI = math.log(2.0 * math.pi)


def log_multivariate_gamma(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Multivariate log-gamma ``log Gamma_D(a)``, batched over ``a``.

    ``log Gamma_D(a) = D(D-1)/4 * log(pi) + sum_{d=1}^{D} lgamma(a + (1-d)/2)``
    (reference: ``src/utils.jl:66-72``).
    """
    d = torch.arange(1, dim + 1, dtype=a.dtype, device=a.device)
    terms = torch.lgamma(a[..., None] + (1.0 - d) / 2.0)
    return dim * (dim - 1) / 4.0 * LOG_PI + terms.sum(-1)


def masked_cholesky(mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a batch of SPD matrices, substituting the
    identity where ``mask`` is False so inactive slots never produce NaNs.

    ``cholesky_ex`` never raises: a slot that is not positive definite gets
    a partial factor and a nonzero ``info`` instead of an exception."""
    d = mat.shape[-1]
    eye = torch.eye(d, dtype=mat.dtype, device=mat.device)
    safe = torch.where(mask[..., None, None], mat, eye)
    return torch.linalg.cholesky_ex(safe)[0]


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log|A| given the lower Cholesky factor of A.  [..., D, D] -> [...]."""
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def _batched_tri_solve(l: torch.Tensor, b: torch.Tensor, *,
                       trans: bool) -> torch.Tensor:
    """Solve ``L x = b`` (or ``L^T x = b``) for lower-triangular L, batched.

    l: [..., D, D] lower triangular; b: [..., D, M]."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def sample_wishart_precision(gen: torch.Generator, nu, psi: torch.Tensor,
                             mask: torch.Tensor, chol_psi=None):
    """Sample ``P ~ Wishart(nu, (nu*Psi)^-1)`` batched, via Bartlett.

    Same contract as the JAX function: returns ``(prec, factors,
    logdet_sigma)`` with ``factors = {"l": chol(nu*Psi), "b": Bartlett B}``
    and ``logdet_sigma = -log|P|``.  ``chol_psi``: optional precomputed
    masked Cholesky of ``psi`` (``chol(nu*psi) = sqrt(nu)*chol(psi)``)."""
    d = psi.shape[-1]
    batch_shape = psi.shape[:-2]
    nu = torch.as_tensor(nu, dtype=psi.dtype, device=psi.device)
    nu = nu.expand(batch_shape)

    if chol_psi is not None:
        l = torch.sqrt(nu)[..., None, None] * chol_psi
    else:
        l = masked_cholesky(nu[..., None, None] * psi, mask)

    # Bartlett: B lower-triangular, B_ii^2 ~ chi^2_{nu - i}, B_ij ~ N(0,1)
    i = torch.arange(d, dtype=psi.dtype, device=psi.device)
    df = torch.clamp(nu[..., None] - i, min=1e-3)  # guard masked slots
    chi2 = 2.0 * torch._standard_gamma(df / 2.0, generator=gen)
    diag = torch.sqrt(torch.clamp(chi2, min=1e-30))
    normals = torch.randn(batch_shape + (d, d), generator=gen,
                          dtype=psi.dtype, device=psi.device)
    b = torch.tril(normals, diagonal=-1) + torch.diag_embed(diag)

    # A = L^-T B is the Wishart factor: P = A A^T, |P| = (|B| / |L|)^2
    a = _batched_tri_solve(l, b, trans=True)
    prec = a @ a.mT
    prec = 0.5 * (prec + prec.mT)
    logdet_prec = 2.0 * (
        torch.log(diag + 1e-30).sum(-1)
        - torch.log(torch.diagonal(l, dim1=-2, dim2=-1).abs() + 1e-30).sum(-1)
    )
    return prec, {"l": l, "b": b}, -logdet_prec


def sample_mvn_from_precision_factors(gen: torch.Generator,
                                      mean: torch.Tensor, factors,
                                      kappa: torch.Tensor) -> torch.Tensor:
    """Sample ``mu ~ N(mean, Sigma / kappa)`` for ``Sigma^-1 = A A^T``,
    ``A = L^-T B`` as produced by :func:`sample_wishart_precision`
    (``A^-T z = L (B^-T z)``: two triangular ops)."""
    z = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                    device=mean.device)
    y = _batched_tri_solve(factors["b"], z[..., None], trans=True)
    x = (factors["l"] @ y)[..., 0]
    return mean + x / torch.sqrt(kappa)[..., None]


def sample_dirichlet(gen: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Dirichlet sample along the last axis via normalized Gammas.

    Entries with ``alpha <= 0`` get weight exactly 0 (used for masked slots).
    """
    safe = torch.clamp(alpha, min=1e-6)
    g = torch._standard_gamma(safe, generator=gen)
    g = torch.where(alpha > 0, g, torch.zeros_like(g))
    denom = g.sum(-1, keepdim=True)
    return g / torch.clamp(denom, min=1e-30)
