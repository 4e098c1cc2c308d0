"""Public API: ``fit`` and the fitted model.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.api` for the Gaussian and
multinomial families on one device: the same ``fit`` and
``run_from_checkpoint`` signatures and config fields, the same centering
and standardization of Gaussian data with the prior mapped along, and the
same ``DPMMModel`` (``labels``, ``k``, ``weights``, ``counts``,
``cluster_params``, ``predict``, ``log_posterior``, ``cluster_statistics``,
``save``), whose checkpoints each package loads.  ``fit_distributed`` and
``run_from_checkpoint_distributed`` are the multi-process fit and its
resume (:mod:`.parallel.distributed`): each process passes its own rows.
The entry points run on ``device="cuda"`` by default and raise when no
card is present; pass ``device="cpu"`` for the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .config import DPMMConfig
from .interop import table_from_jax
from .io.checkpoint import (jax_key, load_checkpoint,
                            load_checkpoint_distributed, restore_generator,
                            save_checkpoint, save_checkpoint_distributed,
                            seed_from_key)
from .ops import sweep_kernels
from .parallel.distributed import RowLayout, row_layout
from .priors import GAUSSIAN, MULTINOMIAL
from .sampler.driver import (DPMMEngine, DPMMState, IterStats, desired_tier,
                             migrate, run_loop, tier_sequence)
from .sampler.table import log_posterior as _table_log_posterior

_FAMILIES = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}


def _cache_row_bytes(fam, cfg: DPMMConfig, d: int) -> int:
    """Bytes per point of the feature cache in its layout: F x 4 (float32),
    ld x 2 (bfloat16: its rows ``ld = sweep_kernels.bf16_row_stride(F)``
    values apart), ld x 2 + D x 4 (hybrid: the bf16 cache and the raw points
    beside it)."""
    f = fam.feature_dim(d)
    ld = sweep_kernels.bf16_row_stride(f)
    return {"float32": 4 * f, "bfloat16": 2 * ld,
            "hybrid": 2 * ld + 4 * d}[cfg.feature_dtype]


def _resolve_precompute(fam, cfg: DPMMConfig, n: int, d: int) -> DPMMConfig:
    """Resolve ``precompute_features`` (None = auto: on for Gaussian data
    when the cache, in ``feature_dtype``'s layout, fits
    ``feature_cache_bytes``).  An explicit True builds the cache for either
    family; without it the kernels build the feature rows from the raw
    points and ``feature_dtype`` has no effect."""
    pf = cfg.precompute_features
    if pf is None:
        pf = (fam.name == "gaussian"
              and n * _cache_row_bytes(fam, cfg, d)
              <= cfg.feature_cache_bytes)
    return cfg.replace(precompute_features=bool(pf))


def _tier_setup(cfg: DPMMConfig, k_start: Optional[int] = None):
    """(starting capacity, tier list or None) for adaptive table capacity;
    a ``max_clusters`` cap bounds the useful capacity.  ``k_start`` (a
    checkpointed table's width) is taken as it is: the tier loop moves it
    toward the tiers at the first boundary."""
    if not cfg.resolved_auto_tier():
        return cfg.k_max, None
    ceiling = cfg.k_max
    if cfg.max_clusters is not None:
        need = int(cfg.max_clusters) + (1 if cfg.outlier_mod > 0 else 0)
        fits = [t for t in tier_sequence(cfg.k_max) if t >= need]
        if fits:
            ceiling = min(ceiling, fits[0])
    tiers = tier_sequence(ceiling)
    if k_start is None:
        init_active = cfg.init_clusters + (1 if cfg.outlier_mod > 0 else 0)
        k_start = min(desired_tier(init_active, tiers[0], tiers), ceiling)
    return k_start, tiers


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


def _check_n_devices(n_devices) -> None:
    """One process drives one card: the JAX package's single-process
    ``n_devices`` / mesh data parallelism has no counterpart here."""
    if n_devices not in (None, 1):
        raise ValueError(
            f"n_devices={n_devices}: one process drives one card; to fit "
            f"across cards run fit_distributed in one process per card "
            f"(torchrun --nproc-per-node=N)")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda': CUDA is not available; pass "
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
    # the random state in place of the JAX package's ``key``: the fit's seed
    # (the checkpoint's JAX key is derived from it and ``step``) and the
    # generator's state (``torch.Generator.get_state()``) on ``gen_device``
    seed: int = 0
    gen_state: Optional[np.ndarray] = None
    gen_device: str = "cpu"

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

    def cluster_params(self) -> list:
        """Per active cluster (dense order) a dict of its slot, posterior
        hyperparameters and sampled parameters, mapped back to the data
        space (de-standardized and de-centred): ``mu``, ``cov`` and the
        posterior's ``m``/``psi`` for the Gaussian family, ``log_p`` for the
        multinomial; and ``weight``."""
        out = []
        shift, s = self.shift, self._scale
        post_all = {k: v.cpu().numpy() for k, v in self.table["post"].items()}
        params = {k: v.cpu().numpy() for k, v in self.table["params"].items()}
        weights = self.weights
        for dense_i, slot in enumerate(self.active_slots):
            post = {k: v[slot, 0] for k, v in post_all.items()}
            entry = {"slot": int(slot), "posterior": post}
            if "m" in post:
                post["m"] = post["m"] / s + shift
                if "psi" in post:
                    post["psi"] = post["psi"] / (s[:, None] * s[None, :])
                entry["mu"] = params["mu"][slot, 0] / s + shift
                entry["cov"] = (np.linalg.inv(params["prec"][slot, 0])
                                / (s[:, None] * s[None, :]))
            else:
                entry["log_p"] = params["log_p"][slot, 0]
            entry["weight"] = weights[dense_i]
            out.append(entry)
        return out

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
        factor = self.family.predictive_factor(post, x.shape[1])  # once
        labels, probs = [], []
        for p0 in range(0, len(x), chunk):
            xc = torch.as_tensor(x[p0:p0 + chunk]).to(dev)
            logits = self.family.predictive_logpdf(xc, factor) + log_w
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

    def cluster_statistics(self, x: np.ndarray, labels: np.ndarray,
                           chunk: int = 1 << 16):
        """Average per-cluster log-likelihood and responsibility of ``x``
        under the sampled cluster distributions (reference
        ``cluster_statistics``, src/dp-parallel-sampling.jl:509-530, with the
        correct Gaussian normalizer), log-likelihoods in the data space.
        ``labels`` are dense 0-based; a label outside ``[0, K)`` counts
        nowhere.  Returns ``(avg_ll, avg_prob)``, float64 [K].

        The active slots' ``phi`` is selected once; then ``chunk`` rows at a
        time go to the model's device, where ``features(x) @ phi.T`` (a
        plain float32 product, as in the JAX package, with TF32 off as
        PyTorch leaves it) gives the ``[chunk, K]`` log-likelihoods and
        each chunk's sums are added in float64: the ``[N, K]`` matrix never
        exists."""
        dev = self.table["active"].device
        x = (np.asarray(x, np.float32) - self.shift) * self._scale
        labels = np.asarray(labels, np.int32).reshape(-1)
        slots = torch.as_tensor(self.active_slots, device=dev)
        k = len(slots)
        phi_t = self.table["params"]["phi"][slots, 0].T.contiguous()
        ids = torch.arange(k, device=dev)
        acc = torch.zeros((3, k), dtype=torch.float64, device=dev)
        for p0 in range(0, len(x), chunk):
            xc = torch.as_tensor(x[p0:p0 + chunk]).to(dev)
            lc = torch.as_tensor(labels[p0:p0 + chunk]).to(dev)
            ll = self.family.features(xc) @ phi_t              # [C, K]
            resp = torch.softmax(ll, dim=-1)
            oh = (lc[:, None] == ids).to(torch.float32)
            acc += torch.stack([(oh * ll).sum(0), (oh * resp).sum(0),
                                oh.sum(0)]).double()
        s_ll, s_resp, cnt = acc.cpu().numpy()
        cnt = np.maximum(cnt, 1.0)
        # density change of variables back to the data space
        return s_ll / cnt + float(np.log(self._scale).sum()), s_resp / cnt

    def _file_fields(self) -> dict:
        """What a checkpoint of this model holds, both formats alike."""
        return dict(table=self.table, labels=self.labels_raw,
                    sublabels=self.sublabels,
                    key=jax_key(self.seed, self.step), step=self.step,
                    shift=self.shift, cfg=self.cfg,
                    family_name=self.family.name, scale=self.scale,
                    gen_state=self.gen_state, gen_device=self.gen_device)

    def save(self, path: str):
        """Write a checkpoint (:mod:`.io.checkpoint`) that either package
        resumes."""
        save_checkpoint(path, n_points=self.n_points, **self._file_fields())


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


def _standardize(fam, cfg: DPMMConfig, x: np.ndarray, prior, outlier_prior,
                 layout: RowLayout):
    """Centering and per-dim standardization of Gaussian data, with the
    prior mapped along: ``(x, prior, outlier_prior, shift, scale)``.  Both
    are exact model transforms, and results are mapped back; centering
    keeps the f32 sum_xx accurate, standardization keeps the posterior
    scatter well-conditioned (DPMMConfig.standardize_data).  The moments
    are the global ones of every rank's rows (``layout.moments``).  Counts
    are left as they are."""
    d = x.shape[1]
    shift = np.zeros(d, np.float32)
    scale = np.ones(d, np.float32)
    if fam.name != "gaussian" or not (cfg.center_data
                                      or cfg.standardize_data):
        return x, prior, outlier_prior, shift, scale
    mean, sd = layout.moments(x)
    if cfg.center_data:
        shift = mean
        x = x - shift
        prior = fam.shift_prior(prior, -shift)
        if outlier_prior is not None:
            outlier_prior = fam.shift_prior(outlier_prior, -shift)
    if cfg.standardize_data:
        scale = np.where(sd > 1e-12, 1.0 / sd, 1.0).astype(np.float32)
        x = x * scale
        prior = fam.scale_prior(prior, scale)
        if outlier_prior is not None:
            outlier_prior = fam.scale_prior(outlier_prior, scale)
    return x, prior, outlier_prior, shift, scale


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
    n_devices: Optional[int] = None,
    config: Optional[DPMMConfig] = None,
    **overrides,
) -> FitResult:
    """Fit a DPMM with the sub-cluster split/merge sampler.

    ``data`` is [N, D] (``transposed=True`` accepts D x N).  ``family`` is
    "gaussian" (the default) or "multinomial" (also chosen by a prior with
    ``alpha``); ``prior=None`` uses the family's weak default, for the
    Gaussian NIW(1, 0, D+3, I) stated in data space.  Any
    :class:`DPMMConfig` field can be passed as a keyword override.  Runs on
    ``device`` ("cuda" by default); ``n_devices`` may only be None or 1
    (:func:`fit_distributed` fits across cards).
    """
    _check_n_devices(n_devices)
    return _fit(_prepare_data(data, transposed), alpha, prior, family,
                device, outlier_prior, config, overrides, gt=gt)


def fit_distributed(
    x_local,
    alpha: float = 10.0,
    prior: Optional[dict] = None,
    *,
    family=None,
    device="cuda",
    outlier_prior: Optional[dict] = None,
    config: Optional[DPMMConfig] = None,
    **overrides,
) -> FitResult:
    """Multi-process ``fit``: every process passes only ITS rows [N_local,
    D] and drives one card (``device``; under
    :func:`.parallel.distributed.initialize`, the rank's own).

    Counterpart of the JAX package's ``fit_distributed`` and of the
    reference's multi-machine mode (``addprocs`` +
    ``DistributedArrays.distribute``, ``docs/src/perf.md:3``,
    ``src/dp-parallel-sampling.jl:42``).  Call ``initialize()`` first on
    every process (without it this is a world of one, and the result is
    ``fit``'s bit for bit).  The global row order is the ranks' rows in rank
    order; centering and standardization use the moments of every rank's
    rows; a ``seed`` of None takes rank 0's draw.  The table, its
    parameters and the history are the same on every rank; the returned
    model's ``labels`` cover this rank's rows only, and its ``n_points``
    counts every rank's.  Labels across rank counts are bit-identical where
    the float32 statistics sums are exact (:mod:`.parallel.distributed`).
    With ``enable_saving`` every rank writes its label shard and rank 0 the
    master file (:func:`.io.checkpoint.save_checkpoint_distributed`).
    """
    x = _prepare_data(x_local, False)
    return _fit(x, alpha, prior, family, device, outlier_prior, config,
                overrides, layout=row_layout(x.shape[0]))


def _fit(x: np.ndarray, alpha, prior, family, device, outlier_prior,
         config, overrides: dict, *, gt=None,
         layout: Optional[RowLayout] = None) -> FitResult:
    """``fit`` (``layout`` None) and ``fit_distributed`` (this rank's
    layout) on this process's rows ``x``."""
    n, d = x.shape
    cfg = config if config is not None else DPMMConfig()
    if alpha is not None:
        overrides.setdefault("alpha", float(alpha))
    if overrides:
        cfg = cfg.replace(**overrides)
    dev = _resolve_device(device)

    fam = _resolve_family(family, prior)
    prior = (fam.default_prior(d) if prior is None
             else _validate_prior(fam, prior, d))
    if outlier_prior is not None:
        outlier_prior = _validate_prior(fam, outlier_prior, d,
                                        name="outlier_prior")
    lay = RowLayout() if layout is None else layout
    x, prior, outlier_prior, shift, scale = _standardize(
        fam, cfg, x, prior, outlier_prior, lay)

    # the cache is per rank: the largest rank's rows decide, alike on all
    cfg = _resolve_precompute(fam, cfg, max(lay.counts, default=n), d)
    k_start, tiers = _tier_setup(cfg)
    engine = DPMMEngine(fam, cfg.replace(k_max=int(k_start)), dev, lay)
    points, valid, n_total = engine.shard_points(x)
    seed = lay.first(cfg.seed if cfg.seed is not None
                     else int(np.random.randint(0, 2**31 - 1)))
    if cfg.precompute_features:
        points = engine.featurize(points, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = engine.init_state(gen, points, valid, prior, outlier_prior)
    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        gt=np.asarray(gt) if gt is not None else None, n_valid=n,
        callback=_save_callback(fam, cfg, shift, n, scale, seed, layout),
        verbose=None if layout is None else False, tiers=tiers,
    )
    model = _model_from_state(fam, cfg, state, shift, n, scale, seed,
                              int(n_total))
    return FitResult(model=model, history=hist)


def _model_from_state(fam, cfg: DPMMConfig, state: DPMMState, shift, n: int,
                      scale, seed: int,
                      n_points: Optional[int] = None) -> DPMMModel:
    """The model of ``state``: this process's ``n`` rows' labels, and
    ``n_points`` (all ranks' rows; ``n`` by default)."""
    return DPMMModel(
        family=fam, table=state.table, shift=np.asarray(shift, np.float32),
        cfg=cfg, n_points=n if n_points is None else n_points,
        labels_raw=state.labels.cpu().numpy()[:n],
        sublabels=state.sublabels.cpu().numpy()[:n], step=state.step,
        scale=None if scale is None else np.asarray(scale, np.float32),
        seed=int(seed), gen_state=state.gen.get_state().numpy(),
        gen_device=state.gen.device.type,
    )


def _save_callback(fam, cfg: DPMMConfig, shift, n: int, scale, seed: int,
                   layout: Optional[RowLayout] = None):
    """With ``cfg.enable_saving``, the ``run_loop`` callback that writes
    ``{save_path}{save_file_prefix}{it + 1}.npz`` every
    ``model_save_interval`` sweeps (reference run_model,
    src/dp-parallel-sampling.jl:396-401); else None.  With a ``layout``
    (``fit_distributed``) every rank writes its shard of ``n`` rows and
    rank 0 the master file."""
    if not cfg.enable_saving:
        return None

    def callback(it, st, _metrics):
        if (it + 1) % cfg.model_save_interval:
            return
        path = f"{cfg.save_path}{cfg.save_file_prefix}{it + 1}.npz"
        if layout is None:
            _model_from_state(fam, cfg, st, shift, n, scale, seed).save(path)
            return
        model = _model_from_state(fam, cfg, st, shift, n, scale, seed,
                                  layout.n_global)
        save_checkpoint_distributed(path, n_points_global=layout.n_global,
                                    n_local=n, **model._file_fields())

    return callback


def _check_capacity(cfg: DPMMConfig, tiers, table) -> None:
    """Refuse a resume that would run below the checkpoint's live clusters
    (the JAX package's resume shrinks the table under them and drops
    clusters, ROADMAP R1): the fixed ``k_max``, the tier ceiling and
    ``max_clusters`` must each hold them."""
    active = np.asarray(table["active"], bool)
    live = int(active.sum())
    real = int((active & ~np.asarray(table["is_outlier"], bool)).sum())
    cap = tiers[-1] if tiers is not None else cfg.k_max
    what = "the tier ceiling" if tiers is not None else "k_max"
    if cap < live:
        raise ValueError(
            f"resume would drop clusters: the checkpoint has {live} live "
            f"slots, but {what} is {cap}; raise k_max (or max_clusters)")
    if cfg.max_clusters is not None and cfg.max_clusters < real:
        raise ValueError(
            f"resume would drop clusters: the checkpoint has {real} live "
            f"clusters, above max_clusters={cfg.max_clusters}")


def run_from_checkpoint(
    path: str,
    data,
    *,
    iters: Optional[int] = None,
    gt=None,
    device="cuda",
    transposed: bool = False,
    n_devices: Optional[int] = None,
    **overrides,
) -> FitResult:
    """Resume a run from a checkpoint of either package (reference
    ``run_model_from_checkpoint``, src/dp-parallel-sampling.jl:428-447).
    ``data`` must be the dataset the checkpoint was trained on; any
    :class:`DPMMConfig` field of the checkpoint's config can be overridden.
    The engine starts at the saved table's width (a fixed ``k_max`` migrates
    it there) and continues from sweep ``step`` with the saved generator
    state (:func:`.io.checkpoint.restore_generator`).  Raises
    ``ValueError`` for data of the wrong size, for the master file of a
    distributed run (:func:`run_from_checkpoint_distributed` resumes it),
    and when the capacity or ``max_clusters`` asked for lies below the
    checkpoint's live clusters.  ``n_devices`` may only be None or 1."""
    _check_n_devices(n_devices)
    ck = load_checkpoint(path)
    x = _prepare_data(data, transposed)
    if x.shape[0] != ck["n_points"]:
        raise ValueError(
            f"checkpoint was trained on {ck['n_points']} points, got "
            f"{x.shape[0]}")
    if len(ck["labels"]) != ck["n_points"]:
        raise ValueError(
            f"{path} is the master file of a distributed run (labels of "
            f"{len(ck['labels'])} of its {ck['n_points']} points); resume "
            f"it with run_from_checkpoint_distributed")
    return _resume(ck, ck["labels"], ck["sublabels"], x, iters, device,
                   overrides, gt=gt)


def run_from_checkpoint_distributed(
    path: str,
    x_local,
    *,
    iters: Optional[int] = None,
    device="cuda",
    **overrides,
) -> FitResult:
    """Resume a :func:`fit_distributed` run (or any checkpoint of either
    package's ``fit_distributed``).  Every process passes its own rows; the
    global row order (the ranks' rows in rank order) must be the original
    run's, but the rank count and the split may differ: the label stream
    is then re-sharded onto the new ranks
    (:func:`.io.checkpoint.load_checkpoint_distributed`; the reference
    refuses this, its ``run_model_from_checkpoint`` re-distributes over the
    same workers, src/dp-parallel-sampling.jl:428-447).  The table, the
    random state and the step come from the master file, replicated."""
    x = _prepare_data(x_local, False)
    layout = row_layout(x.shape[0])
    ck, shard = load_checkpoint_distributed(path, n_local=x.shape[0])
    if layout.n_global != ck["n_points"]:
        raise ValueError(
            f"checkpoint was trained on {ck['n_points']} points, the ranks "
            f"hold {layout.n_global}")
    return _resume(ck, shard["labels"], shard["sublabels"], x, iters,
                   device, overrides, layout=layout)


def _resume(ck: dict, labels, sublabels, x: np.ndarray, iters, device,
            overrides: dict, *, gt=None,
            layout: Optional[RowLayout] = None) -> FitResult:
    """The resume of ``run_from_checkpoint`` (``layout`` None) and of
    ``run_from_checkpoint_distributed``: ``ck``'s table, random state and
    step with this process's ``labels`` / ``sublabels`` of its rows
    ``x``."""
    cfg: DPMMConfig = ck["config"]
    if iters is not None:
        overrides["iters"] = iters
    if overrides:
        cfg = cfg.replace(**overrides)
    fam = _FAMILIES[ck["family"]]
    n, d = x.shape
    dev = _resolve_device(device)
    shift = np.asarray(ck["shift"], np.float32)
    scale = (np.ones(d, np.float32) if ck["scale"] is None
             else np.asarray(ck["scale"], np.float32))
    x = (x - shift) * scale

    lay = RowLayout() if layout is None else layout
    cfg = _resolve_precompute(fam, cfg, max(lay.counts, default=n), d)
    k_saved = int(ck["table"]["active"].shape[0])
    k_start, tiers = _tier_setup(cfg, k_start=k_saved)
    _check_capacity(cfg, tiers, ck["table"])
    engine = DPMMEngine(fam, cfg.replace(k_max=int(k_start)), dev, lay)
    points, valid, n_total = engine.shard_points(x)
    if cfg.precompute_features:
        # the bf16 dither: the original fit's when it was seeded
        points = engine.featurize(
            points, seed=cfg.seed if cfg.seed is not None else 0)

    def stream(a):
        """This rank's label stream, padded to its rows (pad rows are
        invalid)."""
        out = torch.zeros(valid.shape[0], dtype=torch.int32)
        out[:n] = torch.as_tensor(np.asarray(a, np.int32).reshape(-1))
        return out.to(dev)

    state = DPMMState(table=table_from_jax(ck["table"], dev),
                      labels=stream(labels), sublabels=stream(sublabels),
                      gen=restore_generator(ck, dev), step=ck["step"])
    if tiers is None and k_saved != cfg.k_max:
        state = migrate(fam, state, cfg.k_max)
    seed = seed_from_key(ck["key"], ck["step"])
    state, hist = run_loop(
        engine, state, points, valid, n_total, cfg.iters,
        first_iter=ck["step"],
        gt=np.asarray(gt) if gt is not None else None, n_valid=n,
        callback=_save_callback(fam, cfg, shift, n, scale, seed, layout),
        verbose=None if layout is None else False, tiers=tiers,
    )
    model = _model_from_state(fam, cfg, state, shift, n, scale, seed,
                              int(n_total))
    return FitResult(model=model, history=hist)
