"""Configuration for the PyTorch/CUDA DPMM sampler.

The same frozen dataclass as :mod:`dpmmsubclusters_tpu.config`, field for
field, so a config built from the same keyword arguments gives the same
``dataclasses.asdict`` in both packages and checkpoint ``meta`` round-trips.

Knobs that only steer the TPU build are accepted and ignored here:
``use_pallas`` (the kernel is chosen by the tensor's device),
``compile_cache_dir`` (nothing is traced) and ``chunk_size`` (the CUDA
kernels pick their own point blocks).  ``fused_block`` is the number of
sweeps between block-boundary smart passes and tier checks.
``ll_precision`` is honoured with the JAX package's meaning (kernel A,
:func:`.ops.sweep_kernels.fused_assign`): "default" and "bf16" round the
feature rows and phi to bf16 and sum the products in float32, one pass of
the card's tensor cores; "high" is the float32-faithful three-pass bf16
split there; "highest" is the exact float32 product.  ``stats_precision`` is
accepted;
the CUDA kernels compute the statistics in exact float32 on every setting.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DPMMConfig:
    # --- model (reference src/global_params.jl:7-31) -----------------------
    alpha: float = 10.0
    iters: int = 100
    init_clusters: int = 1
    burnout: int = 20               # burnout_period
    argmax_sample_stop: int = 5     # switch to argmax labels for last k iters
    split_stop: int = 5             # stop split/merge for last k iters
    hard_clustering: bool = False
    max_clusters: Optional[int] = None
    outlier_mod: float = 0.0        # weight of the fixed outlier component
    smart_splits: Optional[bool] = None  # PCA + 2-means sub-label init of
    # new/first clusters (the reference's smart_cluster_init!,
    # src/local_clusters_actions.jl:555-653).  None = AUTO: on for the
    # Gaussian family, off for multinomial (the init is covariance-PCA
    # based).  DELIBERATE DEFAULT DIVERGENCE from the reference's
    # smart_splits=false: without it the exact sampler's sub-cluster chain
    # sits on a symmetric saddle for slots holding >= 2 well-separated
    # components -- the sampled l/r parameters fit the merged blob almost
    # identically, sub-labels stay near coin-flips, and the chain
    # under-splits for hundreds of sweeps (measured round 4: 1M x 32-d
    # 64-component data stalls at K~40/NMI 0.93 without smart splits vs
    # K=64/NMI 1.0 with them; the round-3 kernel masked this by accident --
    # its bf16 sub-logit cancellation noise acted as a tempering kick).
    # Smart splits only (re)initialize sub-labels of newborn clusters; every
    # split/merge decision remains the exact MH rule on realized statistics.
    max_split_iter: int = 20

    # --- TPU execution -----------------------------------------------------
    k_max: int = 64                 # padded cluster-table capacity
    chunk_size: int = 16384         # points per on-chip tile of the sweep
    center_data: bool = True        # subtract global mean; shifts prior mean
    standardize_data: bool = True   # ALSO divide each dimension by its
    # global std (gaussian only; prior m/psi are rescaled to match, results
    # are mapped back).  The NIW model is exactly closed under diagonal
    # scaling -- every Hastings ratio and assignment probability is
    # invariant -- but float32 is not: with raw pixel-coordinate features
    # (variance ~1e4 next to rgb variance ~1e-2, the reference's image-seg
    # workload) the posterior scatter matrix has condition ~1e6 and the f32
    # Cholesky logdet noise is amplified by nu_post ~ n into O(100)-nat
    # errors in the split/merge decisions.  The reference dodges this by
    # keeping m/psi/suff-stats in Float64 (src/priors/niw.jl:7-17);
    # standardizing instead keeps the whole pipeline f32/TPU-native.
    use_pallas: Optional[bool] = None  # None = auto (TPU only)
    fused_block: int = 16           # sweeps fused per dispatch (async mode)
    merge_candidates: Optional[int] = None  # None = exact all-pairs merge
    # scan; an int M evaluates only the top-M screen-score pairs (O(M)
    # Cholesky work instead of O(K^2))
    precompute_features: Optional[bool] = None  # build the [N, F] feature
    # rows ONCE per fit and stream them per sweep instead of rebuilding in
    # the kernel (the build is VPU-bound narrow-lane work, ~25% of the
    # Gaussian kernel at D=32).  None = auto: on when the per-device
    # feature cache fits feature_cache_bytes.  Composes with smart splits
    # (the raw points are recovered from cache columns 1..D)
    feature_cache_bytes: int = 4 << 30  # per-device budget for the cache
    feature_dtype: str = "float32"  # storage layout of the precomputed
    # feature cache:
    #   "float32"  (default) -- one f32 cache serves both the likelihood
    #     matmul and the statistics contraction.  Round-5 measurement: the
    #     fused kernel is COMPUTE-bound, not DMA-bound (halving the input
    #     stream saves only ~1.4 ms of 8.2 at the flagship), so cheaper
    #     cache layouts buy little; see docs/perf.md "Roofline autopsy".
    #   "hybrid"   -- a bf16 [N, F] cache feeds ONLY the likelihood matmul
    #     (bf16 logit noise is far below the Gumbel sampling noise) while
    #     the statistics contraction rebuilds exact f32 feature rows
    #     in-kernel from the raw [N, D] points stored alongside.  45% less
    #     cache memory + traffic at full statistical quality -- use when
    #     HBM capacity is the constraint.
    #   "bfloat16" -- one bf16 cache serves both: halves traffic but the
    #     ~2^-9 per-point rounding leaves ~0.1% rms noise on each cluster
    #     covariance, which nu_post ~ n_k amplifies into O(30)-nat noise on
    #     every split/merge Hastings ratio: the chain under-splits (fails
    #     the 200k x 32-d gate; benchmarks/results/stats_precision_r3.json).
    #     Serving/assignment-dominated workloads only.
    auto_tier: Optional[bool] = None  # adaptive table capacity: run at the
    # smallest tier (16, 32, ..., k_max) with >=4x split headroom over the
    # live cluster count, migrating between compiled tiers as K changes.
    # None = on when k_max >= 64 (small tables aren't worth extra compiles)
    track_posterior: bool = True    # per-sweep log-posterior metric (the
    # reference computes it only when verbose, dp-parallel-sampling.jl:379)
    ll_precision: str = "default"   # precision of kernel A's ll product:
    # "default" / "bf16" = rows and phi rounded to bf16, float32 sums, one
    # tensor-core pass (logit noise ~1e-3 relative -- far below the Gumbel
    # sampling noise); "high" = the three-pass bf16 split (f32-faithful);
    # "highest" = exact f32
    stats_precision: str = "split2"  # statistics-matmul precision.  The
    # covariance suff stat cancels E[xx] - mu mu^T, so plain bf16 ("default")
    # is unusable (K=17/NMI 0.964 on the 200k x 32-d gate).  "split2"/"split3"
    # are one-sided bf16 splits (ops/pallas_sweep._stats_dot): the one-hot
    # operand is exact in bf16, so 2 feature planes give a ~16-bit mantissa
    # (rtol 3e-5 vs exact f32) and 3 planes >= f32's 24 bits (rtol 2e-6),
    # at 1/3 resp. 1/2 the MXU passes of "highest" (6).  Default split2:
    # passes every quality gate at full NMI (round-4 TPU evidence: 200k x
    # 32-d K=20/NMI 1.0, flagship K=64/NMI 1.0, 20/20 parity runs) and cuts
    # the fused kernel ~2.3 ms/sweep at the flagship vs split3
    # (benchmarks/kernel_tile_study.py).  Use "split3"/"highest" for extra
    # margin on ill-conditioned unstandardized data.
    reference_splittable_gate: bool = False  # reproduce the reference's
    # biased splittable gate verbatim: its burnout window "mean" divides by
    # (b - 0.1) instead of b (shared_actions.jl:54-63), so clusters with
    # POSITIVE sub-marginal sums (tight, low-variance clusters whose log
    # densities exceed 0) can never become splittable -- a reference bug
    # that caps K below the posterior optimum on such data.  Default False
    # = unbiased mean (see sampler/moves.py:sample_params_step).
    resample_outlier_params: bool = True  # redraw the outlier component's
    # distribution from its posterior every sweep, like every other active
    # slot.  DOCUMENTED DIVERGENCE: the reference never resamples it --
    # sample_clusters! skips slot 1 (src/local_clusters_actions.jl:425-427),
    # so its likelihood column stays frozen at the init-posterior draw for
    # the whole run.  False reproduces that verbatim (and is bundled into
    # reference_verbatim()); see docs/design.md "Outlier component".
    exact_post_move_stats: bool = False  # reference-exact chain: after
    # bad-cluster resets and accepted splits, re-randomize the affected
    # points' sub-labels and recompute realized statistics with an O(N)
    # pass (reference reset_bad_clusters!/split_cluster_local_worker!,
    # src/local_clusters_actions.jl:265-278,481-516).  The default False
    # replaces both with their exact expectation (sub-stats = whole/2) --
    # benchmarks/parity.py quantifies that the two chains are
    # statistically indistinguishable; this flag exists for that A/B and
    # for users who want the reference chain verbatim.

    # --- run control -------------------------------------------------------
    seed: Optional[int] = None
    verbose: bool = True
    compile_cache_dir: Optional[str] = "~/.cache/dpmmsubclusters_tpu/xla"
    # persistent XLA compilation cache (None/"" disables).  Applied once, on
    # first engine construction, and only if the process hasn't already set
    # jax_compilation_cache_dir -- a fresh process then pays seconds instead
    # of minutes of compiles for every (shape, tier) program it has seen
    # before.  No reference counterpart; TPU table stakes.

    # --- checkpointing (reference src/global_params.jl:36-40) --------------
    enable_saving: bool = False
    model_save_interval: int = 1000
    save_path: str = "./"
    save_file_prefix: str = "checkpoint_"

    def __post_init__(self):
        """Range-check the knobs users most often mistype; a bad value here
        otherwise surfaces as an opaque shape/trace error deep inside jit
        (cf. the reference's silent acceptance of unused params-file keys,
        src/global_params.jl:39)."""
        def _bad(msg):
            raise ValueError(f"DPMMConfig: {msg}")

        if not (self.alpha > 0):
            _bad(f"alpha must be > 0, got {self.alpha}")
        if self.iters < 1:
            _bad(f"iters must be >= 1, got {self.iters}")
        if self.init_clusters < 1:
            _bad(f"init_clusters must be >= 1, got {self.init_clusters}")
        if self.burnout < 1:
            _bad(f"burnout must be >= 1, got {self.burnout}")
        if self.k_max < 2:
            _bad(f"k_max must be >= 2, got {self.k_max}")
        if self.chunk_size < 1:
            _bad(f"chunk_size must be >= 1, got {self.chunk_size}")
        if not (0.0 <= self.outlier_mod < 1.0):
            _bad(f"outlier_mod must be in [0, 1), got {self.outlier_mod}")
        if self.max_clusters is not None and self.max_clusters < 1:
            _bad(f"max_clusters must be >= 1, got {self.max_clusters}")
        if self.feature_dtype not in ("float32", "bfloat16", "hybrid"):
            _bad(f"feature_dtype must be 'float32', 'bfloat16' or 'hybrid', "
                 f"got {self.feature_dtype!r}")
        ll_allowed = ("default", "high", "highest", "bf16")
        if self.ll_precision not in ll_allowed:
            _bad(f"ll_precision must be one of {ll_allowed}, "
                 f"got {self.ll_precision!r}")
        st_allowed = ("default", "high", "highest", "split2", "split3")
        if self.stats_precision not in st_allowed:
            _bad(f"stats_precision must be one of {st_allowed}, "
                 f"got {self.stats_precision!r}")

    @classmethod
    def reference_verbatim(cls, **kw) -> "DPMMConfig":
        """Preset bundling EVERY reference-verbatim behavior flag, so
        reference-exact A/B chains can't partially opt out (the individually
        documented defaults deliberately diverge -- unbiased splittable-gate
        mean, standardization, expectation post-move stats):

          * ``reference_splittable_gate=True``  -- the 1/(b - 0.1) window
            mean of shared_actions.jl:54-63, bias included;
          * ``standardize_data=False``          -- raw-coordinate chains;
          * ``exact_post_move_stats=True``      -- realized O(N) stats after
            splits/resets instead of their expectation;
          * ``smart_splits=False``              -- the reference default
            (src/global_params.jl:43);
          * ``resample_outlier_params=False``   -- the outlier component's
            distribution stays frozen at its init draw
            (src/local_clusters_actions.jl:425-427).

        Keyword overrides apply on top (e.g. seed, iters).
        """
        base = dict(
            reference_splittable_gate=True,
            standardize_data=False,
            exact_post_move_stats=True,
            smart_splits=False,
            resample_outlier_params=False,
        )
        base.update(kw)
        return cls(**base)

    def resolved_max_clusters(self) -> float:
        return math.inf if self.max_clusters is None else self.max_clusters

    def resolved_smart_splits(self, family_name: str) -> bool:
        """None = auto: on for Gaussian (covariance-PCA init), off
        otherwise.  Explicit True with a non-Gaussian family fails fast --
        the init needs the sum_xx covariance statistic."""
        if self.smart_splits is None:
            return family_name == "gaussian"
        if self.smart_splits and family_name != "gaussian":
            raise ValueError(
                "smart_splits=True requires the gaussian family (the "
                "PCA + 2-means init is covariance-based); "
                f"got family {family_name!r}"
            )
        return bool(self.smart_splits)

    def resolved_auto_tier(self) -> bool:
        if self.auto_tier is None:
            return self.k_max >= 64
        return self.auto_tier

    def replace(self, **kw) -> "DPMMConfig":
        return dataclasses.replace(self, **kw)
