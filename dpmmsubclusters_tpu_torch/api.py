"""Public API: ``fit`` and the fitted model.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.api` for the Gaussian and
multinomial families on one device: the same ``fit`` signature and config
fields, the same centering and standardization of Gaussian data with the
prior mapped along, and a ``DPMMModel`` with ``labels``, ``k``, ``weights``,
``counts``, ``predict`` and ``log_posterior``.  ``fit`` runs on
``device="cuda"`` by default and raises when no card is present; pass
``device="cpu"`` for the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import DPMMConfig
from .priors import GAUSSIAN, MULTINOMIAL
from .sampler.driver import (DPMMEngine, IterStats, desired_tier, run_loop,
                             tier_sequence)
from .sampler.table import log_posterior as _table_log_posterior

_NOT_PORTED = "see ROADMAP.md for the slices of the port still to come"
_FAMILIES = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}


def _cache_row_bytes(fam, cfg: DPMMConfig, d: int) -> int:
    """Bytes per point of the unpadded feature cache in its layout: F x 4
    (float32), F x 2 (bfloat16), F x 2 + D x 4 (hybrid: the bf16 cache and
    the raw points beside it)."""
    f = fam.feature_dim(d)
    return {"float32": 4 * f, "bfloat16": 2 * f,
            "hybrid": 2 * f + 4 * d}[cfg.feature_dtype]


def _resolve_precompute(fam, cfg: DPMMConfig, n: int, d: int) -> DPMMConfig:
    """Resolve ``precompute_features`` (None = auto: on for Gaussian data
    when the unpadded cache, in ``feature_dtype``'s layout, fits
    ``feature_cache_bytes``).  An explicit True builds the cache for either
    family; without it the kernels build the feature rows from the raw
    points and ``feature_dtype`` has no effect."""
    pf = cfg.precompute_features
    if pf is None:
        pf = (fam.name == "gaussian"
              and n * _cache_row_bytes(fam, cfg, d)
              <= cfg.feature_cache_bytes)
    return cfg.replace(precompute_features=bool(pf))


def _tier_setup(cfg: DPMMConfig):
    """(starting capacity, tier list or None) for adaptive table capacity;
    a ``max_clusters`` cap bounds the useful capacity."""
    if not cfg.resolved_auto_tier():
        return cfg.k_max, None
    ceiling = cfg.k_max
    if cfg.max_clusters is not None:
        need = int(cfg.max_clusters) + (1 if cfg.outlier_mod > 0 else 0)
        fits = [t for t in tier_sequence(cfg.k_max) if t >= need]
        if fits:
            ceiling = min(ceiling, fits[0])
    tiers = tier_sequence(ceiling)
    init_active = cfg.init_clusters + (1 if cfg.outlier_mod > 0 else 0)
    return min(desired_tier(init_active, tiers[0], tiers), ceiling), tiers


_PRIOR_SHAPES = {
    "gaussian": lambda d: {"kappa": (), "m": (d,), "nu": (), "psi": (d, d)},
    "multinomial": lambda d: {"alpha": (d,)},
}


def _validate_prior(fam, prior: dict, d: int, name: str = "prior") -> dict:
    """Check a user prior's keys and shapes against the family and the data
    dimension and convert it to float32 tensors."""
    shapes = _PRIOR_SHAPES[fam.name](d)
    if set(prior) != set(shapes):
        raise ValueError(
            f"{name} for the {fam.name} family must have exactly the keys "
            f"{list(shapes)}; got {sorted(prior)}")
    out = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
           prior.items()}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{name}[{k!r}] must have shape {shape} for "
                             f"D={d} data; got {tuple(out[k].shape)}")
    if fam.name != "gaussian":
        return out
    if not float(out["kappa"]) > 0:
        raise ValueError(f"{name}['kappa'] must be > 0")
    if not float(out["nu"]) > d - 1:
        raise ValueError(f"{name}['nu'] must be > D-1={d - 1} for a proper "
                         f"NIW prior; got {float(out['nu'])}")
    return out


def _resolve_family(family, prior):
    """A family name, a family object, or None: the multinomial family for a
    prior with ``alpha``, else the Gaussian."""
    if family is None:
        if prior is not None and "alpha" in prior:
            return MULTINOMIAL
        return GAUSSIAN
    if isinstance(family, str):
        return _FAMILIES[family]
    return family


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fit(device='cuda'): CUDA is not available; pass "
                           "device='cpu' for the plain PyTorch path")
    return device


@dataclasses.dataclass
class DPMMModel:
    """A fitted model: the cluster table and what maps data to it."""

    family: Any
    table: Any                  # dict of tensors on the fit's device
    shift: np.ndarray           # centering shift applied to the data
    cfg: DPMMConfig
    n_points: int
    labels_raw: np.ndarray      # slot-id labels, [n_points]
    sublabels: np.ndarray       # {0,1}, [n_points]
    step: int = 0
    scale: Optional[np.ndarray] = None  # x' = scale * (x - shift)

    @property
    def _scale(self) -> np.ndarray:
        return np.ones_like(self.shift) if self.scale is None else self.scale

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.table["active"].cpu().numpy())

    @property
    def k(self) -> int:
        return len(self.active_slots)

    @property
    def labels(self) -> np.ndarray:
        """Dense 0-based labels."""
        lut = np.zeros(self.table["active"].shape[0], np.int32)
        lut[self.active_slots] = np.arange(self.k, dtype=np.int32)
        return lut[self.labels_raw]

    @property
    def weights(self) -> np.ndarray:
        """Sampled mixture weights of the active clusters (dense order)."""
        w = np.exp(self.table["log_weights"].cpu().numpy().astype(np.float64))
        return w[self.active_slots]

    @property
    def counts(self) -> np.ndarray:
        return self.table["stats"]["n"][:, 0].cpu().numpy()[self.active_slots]

    def predict(self, x: np.ndarray, return_probs: bool = True,
                chunk: int = 1 << 16):
        """Posterior-predictive hard assignment of new points (reference
        ``predict``, src/dp-parallel-sampling.jl:532-537), in ``chunk``-row
        tiles on the model's device.  Returns ``(labels int32 [N] dense
        0-based, probs float32 [N, K] or None)``."""
        dev = self.table["active"].device
        x = (np.asarray(x, np.float32) - self.shift) * self._scale
        slots = torch.as_tensor(self.active_slots, device=dev)
        post = {k: v[slots, 0] for k, v in self.table["post"].items()}
        w = self.counts + self.cfg.alpha
        log_w = torch.as_tensor(np.log(w / w.sum()), dtype=torch.float32,
                                device=dev)
        labels, probs = [], []
        for p0 in range(0, len(x), chunk):
            xc = torch.as_tensor(x[p0:p0 + chunk]).to(dev)
            logits = self.family.posterior_predictive(xc, post) + log_w
            labels.append(torch.argmax(logits, dim=-1).to(torch.int32).cpu())
            if return_probs:
                probs.append(torch.softmax(logits, dim=-1).cpu())
        labels = torch.cat(labels).numpy()
        return labels, (torch.cat(probs).numpy() if return_probs else None)

    def log_posterior(self) -> float:
        """DP-CRP + marginal-likelihood log posterior (reference
        ``calculate_posterior``, src/dp-parallel-sampling.jl:458-470),
        mapped back to the data space (n * sum(log scale))."""
        lp = _table_log_posterior(self.family, self.table, self.cfg.alpha,
                                  float(self.n_points))
        return float(lp) + self.n_points * float(np.log(self._scale).sum())


@dataclasses.dataclass
class FitResult:
    """What ``fit`` returns."""

    model: DPMMModel
    history: IterStats

    @property
    def labels(self):
        return self.model.labels

    @property
    def weights(self):
        return self.model.weights

    @property
    def k(self):
        return self.model.k

    def predict(self, x):
        return self.model.predict(x)


def _prepare_data(data, transposed: bool) -> np.ndarray:
    x = np.asarray(data, np.float32)
    if x.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {x.shape}")
    if transposed:
        x = x.T
    return np.ascontiguousarray(x)


def fit(
    data,
    alpha: float = 10.0,
    prior: Optional[dict] = None,
    *,
    family=None,
    gt=None,
    device="cuda",
    outlier_prior: Optional[dict] = None,
    transposed: bool = False,
    config: Optional[DPMMConfig] = None,
    **overrides,
) -> FitResult:
    """Fit a DPMM with the sub-cluster split/merge sampler.

    ``data`` is [N, D] (``transposed=True`` accepts D x N).  ``family`` is
    "gaussian" (the default) or "multinomial" (also chosen by a prior with
    ``alpha``); ``prior=None`` uses the family's weak default, for the
    Gaussian NIW(1, 0, D+3, I) stated in data space.  Any
    :class:`DPMMConfig` field can be passed as a keyword override.  Runs on
    ``device`` ("cuda" by default).
    """
    x = _prepare_data(data, transposed)
    n, d = x.shape
    cfg = config if config is not None else DPMMConfig()
    if alpha is not None:
        overrides.setdefault("alpha", float(alpha))
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.enable_saving:
        raise NotImplementedError(
            f"enable_saving: checkpoints are not ported yet; {_NOT_PORTED}")
    dev = _resolve_device(device)

    fam = _resolve_family(family, prior)
    prior = (fam.default_prior(d) if prior is None
             else _validate_prior(fam, prior, d))
    if outlier_prior is not None:
        outlier_prior = _validate_prior(fam, outlier_prior, d,
                                        name="outlier_prior")

    # Gaussian data only: centering keeps the f32 sum_xx accurate; per-dim
    # standardization keeps the posterior scatter well-conditioned
    # (DPMMConfig.standardize_data).  Both are exact model transforms: the
    # prior, stated in data space, is mapped along and results are mapped
    # back.  Counts are left as they are.
    shift = np.zeros(d, np.float32)
    scale = np.ones(d, np.float32)
    if fam.name == "gaussian" and cfg.center_data:
        shift = x.mean(axis=0)
        x = x - shift
        prior = fam.shift_prior(prior, -shift)
        if outlier_prior is not None:
            outlier_prior = fam.shift_prior(outlier_prior, -shift)
    if fam.name == "gaussian" and cfg.standardize_data:
        sd = x.std(axis=0)
        scale = np.where(sd > 1e-12, 1.0 / sd, 1.0).astype(np.float32)
        x = x * scale
        prior = fam.scale_prior(prior, scale)
        if outlier_prior is not None:
            outlier_prior = fam.scale_prior(outlier_prior, scale)

    cfg = _resolve_precompute(fam, cfg, n, d)
    k_start, tiers = _tier_setup(cfg)
    engine = DPMMEngine(fam, cfg.replace(k_max=int(k_start)), dev)
    points, valid, n_total = engine.shard_points(x)
    seed = (cfg.seed if cfg.seed is not None
            else int(np.random.randint(0, 2**31 - 1)))
    if cfg.precompute_features:
        points = engine.featurize(points, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = engine.init_state(gen, points, valid, prior, outlier_prior)
    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        gt=np.asarray(gt) if gt is not None else None, n_valid=n,
        tiers=tiers,
    )
    model = DPMMModel(
        family=fam, table=state.table, shift=np.asarray(shift, np.float32),
        cfg=cfg, n_points=n, labels_raw=state.labels.cpu().numpy(),
        sublabels=state.sublabels.cpu().numpy(), step=state.step,
        scale=np.asarray(scale, np.float32),
    )
    return FitResult(model=model, history=hist)
