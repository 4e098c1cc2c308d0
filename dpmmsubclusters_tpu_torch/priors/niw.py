"""Normal-Inverse-Wishart conjugate prior for multivariate-Gaussian clusters.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.priors.niw`, with the same
parameterization (``psi`` is the "divided-by-nu" scale, the inverse-Wishart
scale matrix is ``nu * psi``), the same packed feature rows
``[1, x, triu(x x^T)]`` and the same ``phi`` natural-parameter rows that the
assignment kernel contracts.  Hyperparameters, statistics and sampled
parameters are dicts of float32 tensors with arbitrary leading batch dims.
"""
from __future__ import annotations

import functools

import torch

from ..ops import linalg
from ..ops.linalg import LOG_PI, LOG_2PI


@functools.lru_cache(maxsize=32)
def _triu(d: int, device: torch.device):
    """Row-major upper-triangle indices (numpy ``triu_indices`` order)."""
    iu, ju = torch.triu_indices(d, d, device=device)
    return iu, ju


class GaussianFamily:
    name = "gaussian"

    # ---- shapes -----------------------------------------------------------
    def feature_dim(self, d: int) -> int:
        return 1 + d + (d * (d + 1)) // 2

    def stat_dim(self, d: int) -> int:
        return self.feature_dim(d)

    # ---- per-point linear maps -------------------------------------------
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, 1 + D + D(D+1)/2]: rows [1, x, packed(x x^T)].

        Each product ``x_i * x_j`` is one float32 multiply, so the rows are
        bit-identical to the JAX build.  Written segment by segment into one
        preallocated tensor: at 1M x 32-d a gather-based build would hold
        several GB of temporaries on the card."""
        n, d = x.shape
        out = torch.empty((n, self.feature_dim(d)), dtype=x.dtype,
                          device=x.device)
        out[:, 0] = 1.0
        out[:, 1:1 + d] = x
        col = 1 + d
        for j in range(d):
            torch.mul(x[:, j:j + 1], x[:, j:], out=out[:, col:col + d - j])
            col += d - j
        return out

    def pack_sym(self, mat: torch.Tensor, double_offdiag: bool) -> torch.Tensor:
        """[..., D, D] symmetric -> packed [..., D(D+1)/2] (triu row-major).
        ``double_offdiag=True`` packs a coefficient vector (off-diagonals
        doubled) so ``packed(coeff) . packed(xx)`` is the full bilinear form."""
        d = mat.shape[-1]
        iu, ju = _triu(d, mat.device)
        out = mat[..., iu, ju]
        if double_offdiag:
            scale = torch.where(iu == ju, 1.0, 2.0).to(mat.dtype)
            out = out * scale
        return out

    def unpack_sym(self, packed: torch.Tensor, d: int) -> torch.Tensor:
        """packed [..., D(D+1)/2] -> full symmetric [..., D, D]."""
        iu, ju = _triu(d, packed.device)
        full = packed.new_zeros(packed.shape[:-1] + (d, d))
        full[..., iu, ju] = packed
        full[..., ju, iu] = packed
        return full

    # ---- sufficient statistics -------------------------------------------
    def empty_stats(self, batch_shape: tuple, d: int, device="cpu"):
        z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
        return {
            "n": z(batch_shape),
            "sum_x": z(batch_shape + (d,)),
            "sum_xx": z(batch_shape + (d, d)),
        }

    def stats_from_flat(self, flat: torch.Tensor, d: int):
        s = self.stat_dim(d)
        return {
            "n": flat[..., 0],
            "sum_x": flat[..., 1:1 + d],
            "sum_xx": self.unpack_sym(flat[..., 1 + d:s], d),
        }

    def stats_to_flat(self, stats) -> torch.Tensor:
        return torch.cat(
            [
                stats["n"][..., None],
                stats["sum_x"],
                self.pack_sym(stats["sum_xx"], double_offdiag=False),
            ],
            dim=-1,
        )

    # ---- conjugate updates ------------------------------------------------
    def calc_posterior(self, prior, stats):
        """Batched NIW posterior update (reference src/priors/niw.jl:20-31).
        Slots with N == 0 return the prior unchanged."""
        n = stats["n"]
        has = n > 0
        kappa = prior["kappa"] + n
        nu = prior["nu"] + n
        m = (prior["kappa"][..., None] * prior["m"] + stats["sum_x"]) \
            / kappa[..., None]
        mm0 = prior["m"][..., :, None] * prior["m"][..., None, :]
        mm1 = m[..., :, None] * m[..., None, :]
        psi = (
            prior["nu"][..., None, None] * prior["psi"]
            + prior["kappa"][..., None, None] * mm0
            - kappa[..., None, None] * mm1
            + stats["sum_xx"]
        ) / nu[..., None, None]
        psi = 0.5 * (psi + psi.mT)
        return {
            "kappa": torch.where(has, kappa, prior["kappa"]),
            "m": torch.where(has[..., None], m, prior["m"]),
            "nu": torch.where(has, nu, prior["nu"]),
            "psi": torch.where(has[..., None, None], psi, prior["psi"]),
        }

    def augment_prior(self, prior_k):
        """Attach per-slot caches of the prior-only log-marginal terms
        (``ld0`` = log|psi0|, ``lgmv0`` = log Gamma_D(nu0/2)); they ride
        along every prior-row scatter and remap."""
        d = prior_k["m"].shape[-1]
        psi = prior_k["psi"]
        ones = torch.ones(psi.shape[:-2], dtype=torch.bool, device=psi.device)
        ld0 = linalg.chol_logdet(linalg.masked_cholesky(psi, ones))
        lgmv0 = linalg.log_multivariate_gamma(prior_k["nu"] / 2.0, d)
        return {**prior_k, "ld0": ld0, "lgmv0": lgmv0}

    def posterior_cache(self, posterior, mask):
        """Factor the posterior psi once per (post, mask): the factor serves
        both :meth:`log_marginal` and :meth:`sample_params`."""
        chol = linalg.masked_cholesky(posterior["psi"], mask)
        return {"chol": chol, "ld": linalg.chol_logdet(chol)}

    def log_marginal(self, prior, posterior, stats, mask,
                     cache=None) -> torch.Tensor:
        """Batched log marginal likelihood (reference src/priors/niw.jl:53-62).
        Returns 0 where ``mask`` is False or N == 0."""
        d = prior["m"].shape[-1]
        valid = mask & (stats["n"] > 0)
        if "ld0" in prior:
            ld0, lgmv0 = prior["ld0"], prior["lgmv0"]
        else:
            ld0 = linalg.chol_logdet(
                linalg.masked_cholesky(prior["psi"], valid))
            lgmv0 = linalg.log_multivariate_gamma(prior["nu"] / 2.0, d)
        if cache is not None:
            ld1 = cache["ld"]
        else:
            ld1 = linalg.chol_logdet(
                linalg.masked_cholesky(posterior["psi"], valid))
        nu0, nu1 = prior["nu"], posterior["nu"]
        out = (
            -stats["n"] * d * 0.5 * LOG_PI
            + linalg.log_multivariate_gamma(nu1 / 2.0, d)
            - lgmv0
            + (nu0 / 2.0) * (d * torch.log(nu0) + ld0)
            - (nu1 / 2.0) * (d * torch.log(nu1) + ld1)
            + (d / 2.0) * torch.log(prior["kappa"] / posterior["kappa"])
        )
        return torch.where(valid, out, torch.zeros_like(out))

    def log_marginal_pairwise(self, prior, stats, mask) -> torch.Tensor:
        """[K, K] log marginal likelihood of every merged pair (i, j), with
        the prior-only terms per slot and only the merged-posterior Cholesky
        per pair (the reference's should_merge!, src/shared_actions.jl:21-38,
        with prior_i)."""
        d = prior["m"].shape[-1]
        n_m = stats["n"][:, None] + stats["n"][None, :]
        sx = stats["sum_x"][:, None, :] + stats["sum_x"][None, :, :]
        sxx = stats["sum_xx"][:, None] + stats["sum_xx"][None, :]

        k0 = prior["kappa"][:, None]
        nu0 = prior["nu"][:, None]
        m0 = prior["m"][:, None, :]
        kappa1 = k0 + n_m
        nu1 = nu0 + n_m
        m1 = (k0[..., None] * m0 + sx) / kappa1[..., None]
        mm0 = m0[..., :, None] * m0[..., None, :]
        mm1 = m1[..., :, None] * m1[..., None, :]
        psi1 = (
            nu0[..., None, None] * prior["psi"][:, None]
            + k0[..., None, None] * mm0
            - kappa1[..., None, None] * mm1
            + sxx
        ) / nu1[..., None, None]
        psi1 = 0.5 * (psi1 + psi1.mT)

        pair_mask = mask[:, None] & mask[None, :] & (n_m > 0)
        ld1 = linalg.chol_logdet(linalg.masked_cholesky(psi1, pair_mask))
        if "ld0" in prior:
            ld0 = prior["ld0"][:, None]
            lgmv0 = prior["lgmv0"][:, None]
        else:
            ld0 = linalg.chol_logdet(
                linalg.masked_cholesky(prior["psi"], mask))[:, None]
            lgmv0 = linalg.log_multivariate_gamma(
                prior["nu"] / 2.0, d)[:, None]
        out = (
            -n_m * d * 0.5 * LOG_PI
            + linalg.log_multivariate_gamma(nu1 / 2.0, d)
            - lgmv0
            + (nu0 / 2.0) * (d * torch.log(nu0) + ld0)
            - (nu1 / 2.0) * (d * torch.log(nu1) + ld1)
            + (d / 2.0) * torch.log(k0 / kappa1)
        )
        return torch.where(pair_mask, out, torch.zeros_like(out))

    def merge_screen_score(self, post_w, params_w) -> torch.Tensor:
        """Cheap [K, K] mergeability score (lower = closer): symmetric
        Mahalanobis distance between posterior means under the sampled
        precisions (top-M candidate screen of ``merge_candidates``)."""
        mu = post_w["m"]
        prec = params_w["prec"]
        k, d = mu.shape
        pm = torch.einsum("ide,ie->id", prec, mu)
        s = torch.einsum("id,id->i", pm, mu)
        c = mu @ pm.T
        m2 = (mu[:, :, None] * mu[:, None, :]).reshape(k, d * d)
        q = prec.reshape(k, d * d) @ m2.T
        dist = q - 2.0 * c.T + s[:, None]
        return dist + dist.T

    # ---- sampling ---------------------------------------------------------
    def sample_params(self, gen: torch.Generator, hyper, mask, cache=None):
        """Draw (mu, Sigma) from the NIW and pack natural parameters
        (reference src/priors/niw.jl:34-40, via Bartlett on the precision).
        Returns ``{"phi" [..., F], "mu" [..., D], "prec" [..., D, D],
        "logdet_sigma" [...]}``."""
        d = hyper["m"].shape[-1]
        prec, factors, logdet_sigma = linalg.sample_wishart_precision(
            gen, hyper["nu"], hyper["psi"], mask,
            chol_psi=None if cache is None else cache["chol"],
        )
        mu = linalg.sample_mvn_from_precision_factors(
            gen, hyper["m"], factors, hyper["kappa"])
        h = torch.einsum("...ij,...j->...i", prec, mu)
        quad = torch.einsum("...i,...i->...", mu, h)
        c = -0.5 * (d * LOG_2PI + logdet_sigma + quad)
        phi = torch.cat(
            [c[..., None], h, self.pack_sym(-0.5 * prec, double_offdiag=True)],
            dim=-1,
        )
        return {"phi": phi, "mu": mu, "prec": prec,
                "logdet_sigma": logdet_sigma}

    # ---- prediction -------------------------------------------------------
    def posterior_predictive(self, x: torch.Tensor, hyper) -> torch.Tensor:
        """Multivariate Student-t posterior predictive log-density
        (reference src/priors/niw.jl:68-76).  x: [N, D]; hyper batched
        [...]; returns [N, ...]."""
        d = x.shape[-1]
        nu_t = hyper["nu"] - d + 1.0
        scale = (
            ((hyper["kappa"] + 1.0) / (hyper["kappa"] * nu_t))[..., None, None]
            * hyper["nu"][..., None, None]
            * hyper["psi"]
        )
        ones = torch.ones(nu_t.shape, dtype=torch.bool, device=x.device)
        chol = linalg.masked_cholesky(scale, ones)
        logdet = linalg.chol_logdet(chol)
        diffs = x.T - hyper["m"][..., None]                 # [..., D, N]
        y = torch.linalg.solve_triangular(chol, diffs, upper=False)
        m2 = (y * y).sum(-2)                                # [..., N]
        ll = (
            torch.lgamma((nu_t + d) / 2.0)
            - torch.lgamma(nu_t / 2.0)
            - 0.5 * d * (torch.log(nu_t) + LOG_PI)
            - 0.5 * logdet
        )[..., None] - 0.5 * (nu_t[..., None] + d) * torch.log1p(
            m2 / nu_t[..., None])
        return torch.movedim(ll, -1, 0)

    # ---- convenience ------------------------------------------------------
    def default_prior(self, d: int, device="cpu"):
        """Weak default prior NIW(1, 0, D+3, I) (reference
        src/dp-parallel-sampling.jl:270-277)."""
        return self.make_prior(1.0, torch.zeros(d), d + 3.0, torch.eye(d),
                               device=device)

    def make_prior(self, kappa, m, nu, psi, device="cpu"):
        f = functools.partial(torch.as_tensor, dtype=torch.float32,
                              device=device)
        return {"kappa": f(kappa), "m": f(m), "nu": f(nu), "psi": f(psi)}

    def tile_prior(self, prior, batch_shape: tuple):
        return {k: v.expand(batch_shape + v.shape).clone()
                for k, v in prior.items()}

    def shift_prior(self, prior, shift):
        """Translate the prior mean (used by data auto-centering)."""
        return {**prior, "m": prior["m"] + torch.as_tensor(
            shift, dtype=torch.float32, device=prior["m"].device)}

    def scale_prior(self, prior, scale):
        """Rescale the prior for per-dimension standardized data x' = s*x:
        m' = s*m, psi' = diag(s) psi diag(s)."""
        s = torch.as_tensor(scale, dtype=torch.float32,
                            device=prior["m"].device)
        return {**prior, "m": prior["m"] * s,
                "psi": prior["psi"] * (s[:, None] * s[None, :])}


GAUSSIAN = GaussianFamily()
