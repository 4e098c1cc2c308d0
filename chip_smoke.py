"""Smoke test of the PyTorch/CUDA port (dpmmsubclusters_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels from csrc/, checks each kernel
and variant against its plain PyTorch version at the shapes the fits give it
(kernel A under both ll_precision "highest", the exact float32 product, and
"default" -- on float32 rows the three-pass bf16 split on the tensor
cores, "high"'s kernel bit for bit; on a bf16 cache one bf16 pass --, with
the two times side by side, "bf16" (the earlier "default") beside them at
every f32 shape the earlier "default" was checked at, and at two shapes
under "high"; and the
raw-point and bf16 variants against the f32 cache variant bit for bit
under both; kernel B under uniform labels, every point in one key and the
labels of one kernel A call, its key sort equal to the plain sort, and its
output on a fixed input equal to the earlier kernel's by sha256; kernel
A's exact route's labels and sub-labels on fixed inputs equal to the
earlier exact kernel's by sha256, beside the strict-fp32 SGEMM of its
whole columns as a yardstick), runs
kernel E's build gate (a well-formed kernel builds and runs, its
ill-formed twin makes the build raise), checks the kernel studies'
kernels at their full sizes (kernel C's column sums and kernel A's 64-,
128- and 256-point blocks at 1M x 640, K=128, whose labels must not depend
on the block; each of kernel D's 8 stage sets at 1M x 561, K=128), runs
the card-only tests (tests/test_torch_card_*.py, in a subprocess with no
conftest; every one must pass), runs the kernel studies' entry points
(the tile study and the ablation), then drives ``fit``
through every path of the port, at the config's default ll_precision
("default") unless it names another:

* Gaussian with the f32 feature cache: the 4-corner gate, the 200k x 32-d
  recovery gate and the 1M x 32-d flagship (also under "highest");
* Gaussian with the rows built in the kernels: the flagship without its
  cache, and the 10M x 64-d fit whose f32 cache (86 GB) would not fit the
  card;
* Gaussian with a bf16 cache: "bfloat16" (4 corners, the flagship) and
  "hybrid" (200k x 32-d, the flagship, and the 10M x 64-d fit with its
  42.9 GB cache);
* multinomial: 50k x 100-d and 1M x 100-d;
* under "highest", one small fit of every other variant (the exact
  kernels' paths), and under "high" a 4-corner and a 200k x 32-d fit;
* persistence at the flagship's width: a saving fit, two resumes of its
  sweep-60 checkpoint (K=64, ``predict == labels``, ``cluster_params``,
  ``cluster_statistics``, kernels A and B launched, the same labels), a
  bit-exact continuation without smart splits, and the CLI's fit and
  ``--resume`` in subprocesses; then ``cluster_statistics`` over the 10M x
  64-d fit's points;
* the distributed phase (``fit_distributed``, :func:`run_distributed`):
  one NCCL rank in this process equal to the flagship's ``fit`` bit for
  bit, two gloo ranks sharing the card on the flagship (K=64, equal
  tables, kernels A and B launched on each, the sums over ranks timed),
  the integer 4 corners at 2^20 points equal on one process and on two
  ranks, and the CLI's ``--distributed`` fit, resume and re-shard resume;

and profiles 8 steady sweeps of the flagship fit (f32 cache, under
"default" and "highest") and of each 10M x 64-d fit with torch.profiler.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-a    # kernel A: digests and times
    python3 chip_smoke.py --tc-digests  # kernel A at width 256: digests
    python3 chip_smoke.py --narrow-digests  # kernel A's resident passes
    python3 chip_smoke.py --kernel-b    # kernel B alone: digests and times
    python3 chip_smoke.py --chain-quality   # 1M x 64-d, seeds 1-5
    python3 chip_smoke.py --huge        # the 10M x 64-d fits alone
    python3 chip_smoke.py --studies     # kernels C, D's column sums, E

``--tc-digests`` prints kernel A's digests at a table width of 256 with
inactive slots (:data:`TC_DIGESTS`), ``--narrow-digests`` those at the
narrow widths the resident kernel takes (:data:`NARROW_DIGESTS`), one JSON
line each (a copy in another tree reads that tree's).
``--kernel-a`` prints the exact route's digests and kernel A's times in
each variant under every ll_precision, each with its share of the bound,
the tile study's blocks and kernel D's stage sets; ``--kernel-b`` prints kernel B's digests and its time in each variant
under the three label sets (with the device time of each of its kernels);
both one JSON line each, with whichever dpmmsubclusters_tpu_torch sits
beside this file: a copy in another tree times that tree.
``--studies`` prints kernel C's and kernel D's column-sum sets' whole
calls and device times beside their library calls', and kernel E's, one
JSON line each (a copy in another tree times that tree).
``--huge`` runs the two 10M x 64-d fits alone and prints their ms/sweep
and device ms/sweep by part, one JSON line (a copy in another tree times
that tree).  ``--chain-quality`` fits 1M x 64-d (K_true=100, no cache) at
seeds 1-5
under "default" and "highest" and prints K, NMI, the first sweep at K=100
and ms/sweep of each fit.

Any failed check raises (non-zero exit).  On success the line before the
last is a JSON object describing each kernel variant (launches in the fit
that drives it, error against the plain version, kernel, plain and library
times, and the least time the card could take), preceded by the card's
name and power limit from nvidia-smi; the last line is ``{"ok": true,
"device": {...}}``.  Exits non-zero without a result when CUDA is
unavailable.  Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import gc
import hashlib
import json
import pathlib
import re
import sys
import tempfile
import time

import numpy as np

N_CHECK = 1_048_576
N_FLAG, D_FLAG, K_TRUE_FLAG, K_MAX_FLAG = 1_000_000, 32, 64, 128
HASH_TILE = 512
SEED = 12345
REPLACES = {
    "fused_assign": "dpmmsubclusters_tpu/ops/pallas_sweep.py:518",
    "stats_from_labels": "dpmmsubclusters_tpu/ops/pallas_sweep.py:439",
    "build_gate": "tests/test_mosaic_compile.py:88",
    "column_sum": "benchmarks/kernel_tile_study.py:58",
    "tile_study_full": "benchmarks/kernel_tile_study.py:58",
    "kernel_ablate": "benchmarks/kernel_ablate.py:150",
}
SOURCES = {
    "fused_assign": "dpmmsubclusters_tpu_torch/csrc/fused_assign.cu",
    "fused_assign_tc": "dpmmsubclusters_tpu_torch/csrc/fused_assign_tc.cu",
    "fused_assign_tc3": "dpmmsubclusters_tpu_torch/csrc/fused_assign_tc3.cu",
    "fused_assign_tc_tma":
        "dpmmsubclusters_tpu_torch/csrc/fused_assign_tc_tma.cuh",
    "fused_assign_tc_ring":
        "dpmmsubclusters_tpu_torch/csrc/fused_assign_tc_ring.cuh",
    "fused_assign_tc_resident":
        "dpmmsubclusters_tpu_torch/csrc/fused_assign_tc_resident.cuh",
    "stats_from_labels": "dpmmsubclusters_tpu_torch/csrc/stats_from_labels.cu",
    "build_gate": "chip_smoke.py",      # GATE_KERNEL, built by _build.py
    "column_sum": "dpmmsubclusters_tpu_torch/csrc/column_sum.cu",
    "tile_study_full": "dpmmsubclusters_tpu_torch/csrc/fused_assign.cu",
    "kernel_ablate": "dpmmsubclusters_tpu_torch/csrc/kernel_ablate.cu",
}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, and dense bf16 FLOP/s of the
# tensor cores (kernel A's ll product under ll_precision "default", "bf16"
# and "high")
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    from dpmmsubclusters_tpu_torch.utils.profiling import median_ms

    return median_ms(fn, "cuda", reps)


def separated_data(n: int, d: int, k_true: int, seed: int = 0):
    """bench.py's flagship mixture (benchmarks/suite.py's too): separated
    means (x8), unit covariances."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    labels = rng.integers(0, k_true, size=n)
    x = means[labels] + rng.standard_normal((n, d)).astype(np.float32)
    return x, labels


def least_time(nbytes: float, flop: float, peak: float = FP32_FLOP_S,
               more_flop: float = 0.0, more_peak: float = FP32_FLOP_S) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` and do ``flop`` operations of a type whose peak rate is
    ``peak`` (and ``more_flop`` of another type, at ``more_peak``): the
    larger of the bytes' time and the operations' at the peaks."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_flop = (flop / peak + more_flop / more_peak) * 1e3
    return dict(bound_ms=max(t_bytes, t_flop),
                bound_by="bytes" if t_bytes >= t_flop else "operations")


def close(torch, got, want, rtol: float, atol: float) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} entries outside rtol={rtol} "
                             f"atol={atol}; max abs err {float(err.max())}")
    return float(err.max())


class Case:
    """One kernel check's inputs on the card: the rows ``x`` of a variant
    (the raw points, or with ``cache`` the Gaussian feature cache in that
    layout: "float32", or "bfloat16" built as fit builds it, its rows
    padded to a multiple of 8 values), a [F, 2K] phi_mat drawn by the family at random posteriors, uniform log-weights
    and ``valid`` (the last 1000 rows invalid).  ``raw`` keeps the points
    (a bf16 cache's case turns "hybrid" with :meth:`as_hybrid`)."""

    def __init__(self, torch, dev, x_np, family: str, k: int,
                 cache: str = ""):
        from dpmmsubclusters_tpu_torch.priors import GAUSSIAN, MULTINOMIAL
        from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi
        from dpmmsubclusters_tpu_torch.sampler.driver import bf16_features

        self.family, self.k = family, k
        self.x = self.raw = torch.as_tensor(x_np).to(dev)
        self.x_raw = None
        n, d = self.x.shape
        gen = torch.Generator(device=dev).manual_seed(1)
        ones = torch.ones(k, 3, dtype=torch.bool, device=dev)
        if family == "multinomial":
            alpha = 0.5 + 2.5 * torch.rand((k, 3, d), generator=gen,
                                           device=dev)
            phi = MULTINOMIAL.sample_params(gen, {"alpha": alpha}, ones)
        else:
            post = {
                "kappa": torch.full((k, 3), 5.0, device=dev),
                "m": torch.randn((k, 3, d), generator=gen, device=dev),
                "nu": torch.full((k, 3), d + 5.0, device=dev),
                "psi": torch.eye(d, device=dev).expand(k, 3, d, d),
            }
            phi = GAUSSIAN.sample_params(gen, post, ones)
        self.phi_mat = _delta_phi(
            phi["phi"], torch.log(torch.full((k, 2), 0.5, device=dev)))
        self.log_w = torch.log(torch.full((k,), 1.0 / k, device=dev))
        self.valid = torch.ones(n, dtype=torch.bool, device=dev)
        self.valid[-1000:] = False
        self.gen = gen
        # multiplies a point's built rows need: triu(x x^T) for the Gaussian
        self.built = d * (d + 1) // 2 if family == "gaussian" else 0
        if cache == "float32":
            self.x, self.family = GAUSSIAN.features(self.x), "precomputed"
        elif cache == "bfloat16":
            self.x, self.family = bf16_features(GAUSSIAN, self.x,
                                                SEED), "bfloat16"
        if cache:
            self.built = 0

    def as_hybrid(self) -> "Case":
        """The same bf16 cache as a "hybrid" container: its statistics are
        built from the raw points."""
        h = copy.copy(self)
        h.family, h.x_raw = "hybrid", self.raw
        h.built = self.raw.shape[1] * (self.raw.shape[1] + 1) // 2
        return h

    def args(self):
        return (self.x, self.valid, self.phi_mat, self.log_w, SEED, 0)

    def kw(self):
        kw = dict(tile=HASH_TILE, family_name=self.family)
        if self.x_raw is not None:
            kw["x_raw"] = self.x_raw
        return kw

    def row_bytes(self) -> int:
        """Bytes of the rows the kernels read (the raw points beside a
        hybrid cache included)."""
        nb = self.x.numel() * self.x.element_size()
        if self.x_raw is not None:
            nb += self.x_raw.numel() * self.x_raw.element_size()
        return nb


def check_assign(torch, sk, name: str, case: Case, smi: str,
                 ll_precision: str = "highest") -> dict:
    """Kernel A against its plain version at one ``ll_precision``: labels
    identical except near ties (hard and soft, :func:`label_ties_only`),
    soft labels and sub-labels agreeing >= 0.999, statistics within 1e-5 of
    their terms' magnitudes of the plain float64 sums at the kernel's
    labels, two launches equal.  Under the tensor cores' products ("bf16",
    one pass, and "high", the three-pass split; "default" takes one of
    them) the sub-labels must also be equal wherever the labels are, hard
    and soft, but at near ties of the sub-label's draw
    (:func:`sub_ties_only`)."""
    route = sk.ll_route(case.family, ll_precision)
    x, valid, k = case.x, case.valid, case.k
    name = f"{name} [{ll_precision}]"
    kw = dict(case.kw(), ll_precision=ll_precision)

    def run(hard):
        return sk.fused_assign(*case.args(), hard, **kw)

    def plain(hard):
        return sk.fused_assign_reference(*case.args(), hard, **kw)

    lk, sk_, _ = run(True)
    lp, sp, _ = plain(True)
    torch.cuda.synchronize()
    flips = label_ties_only(torch, sk, case, lk, lp, route, True)
    n = x.shape[0]
    log(f"{name} hard: {n - flips}/{n} labels identical ({flips} near-tie "
        f"flips)")
    ties = []
    if route != "highest":
        ties.append(sub_ties_only(torch, sk, case, lk, sk_, sp, lk == lp,
                                  route))
    lk, sk_, stk = run(False)
    lp, sp, _ = plain(False)
    agree_l = float((lk == lp).float().mean())
    agree_s = float((sk_ == sp).float().mean())
    log(f"{name} soft: labels agree {agree_l:.6f}, sub-labels {agree_s:.6f}")
    assert agree_l >= 0.999 and agree_s >= 0.999, (name, agree_l, agree_s)
    flips = label_ties_only(torch, sk, case, lk, lp, route, False)
    log(f"{name} soft: {flips} label flips, each at a near tie of the noisy "
        f"logits")
    if route != "highest":
        ties.append(sub_ties_only(torch, sk, case, lk, sk_, sp, lk == lp,
                                  route))
        log(f"{name}: sub-labels equal to the plain version's wherever the "
            f"labels are, but {ties} (hard, soft) near ties of the "
            f"sub-label's draw")
    # the statistics at the kernel's labels against the plain sums in
    # float64, within 1e-5 of the terms' magnitudes (a float32 sum of many
    # terms that cancel can hold no bound relative to its result); hybrid's
    # statistics are the raw points' Gaussian rows
    stat_x, stat_family = ((x, case.family) if case.x_raw is None
                           else (case.x_raw, "gaussian"))
    want, mag = plain_stats_f64(torch, sk, stat_x, lk, sk_, valid, k,
                                stat_family)
    err = close_sums(torch, stk.double(), want, mag)
    # the earlier check (plain float32 sums, rtol 1e-4 / atol 1e-3): its
    # worst entry, with the kernel's and the float32 plain sums' distances
    # from float64, so a miss there shows which side the float64 sum backs
    st32 = sk.stats_from_labels_reference(stat_x, lk, sk_, valid, k,
                                          stat_family)
    ratio = (stk - st32).abs() / (1e-3 + 1e-4 * st32.abs())
    i = int(ratio.argmax())
    at = (t.reshape(-1)[i] for t in (ratio, stk.double(), st32.double(),
                                     want, mag))
    worst, kern, f32, f64, m = (float(v) for v in at)
    log(f"{name} statistics, the earlier check's worst entry (flat index "
        f"{i}): {int((ratio > 1).sum())} entries outside rtol 1e-4 / atol "
        f"1e-3 of the float32 plain sums (worst at {worst:.3g}x the "
        f"bound); there float64 {f64!r}, kernel {kern!r} (off "
        f"{abs(kern - f64):.3g}), float32 plain {f32!r} (off "
        f"{abs(f32 - f64):.3g}), sum of |terms| {m!r}")
    del want, mag, st32, ratio
    l2, s2, st2 = run(False)
    assert torch.equal(l2, lk) and torch.equal(s2, sk_) and torch.equal(
        st2, stk), f"{name} is not deterministic"
    ms = time_ms(torch, lambda: run(False))
    # the assign pass alone: the call less its statistics pass, which is
    # kernel B's launch on the same rows and labels
    pass_ms = ms - time_ms(torch, lambda: sk.stats_from_labels(
        stat_x, lk, sk_, valid, k, stat_family))
    plain_ms = time_ms(torch, lambda: plain(False))
    f = case.phi_mat.shape[0]
    b = assign_bound(case, route)
    yard_ms, yard = product_yardstick(torch, sk, case, route)
    log(f"{name}: {ms:.3f} ms (less kernel B's time, the assign pass: "
        f"{pass_ms:.3f} ms), plain {plain_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}; share "
        f"{b['bound_ms'] / ms:.1%}), yardstick ({yard}) {yard_ms:.3f} ms "
        f"(N={n}, F={f}, K={k}; {smi}); max abs err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                library_ms=None, yardstick_ms=yard_ms, pass_ms=pass_ms)


def assign_bound(case: Case, route: str) -> dict:
    """The least time the card could take for kernel A's call (assign and
    statistics pass) on ``case`` under the product ``route``: it needs each
    point's whole columns and its label's one delta column (2 flop a term;
    on the tensor cores at bf16's peak under "bf16", three such products
    under "high", else float32's), the built rows' products and one add a
    statistic (float32); it reads the rows, valid, phi and log_w once and
    writes labels, sub-labels and the statistics."""
    n, k, f = case.x.shape[0], case.k, case.phi_mat.shape[0]
    n_valid = int(case.valid.sum())
    nbytes = (case.row_bytes() + n + 4 * (f * 2 * k + k) + 8 * n
              + 4 * 2 * k * f)
    product = 2.0 * n * f * (k + 1)
    rest = n * case.built + n_valid * f
    passes = {"bf16": 1, "high": 3}.get(route)
    if passes:
        return least_time(nbytes, passes * product, BF16_FLOP_S, rest,
                          FP32_FLOP_S)
    return least_time(nbytes, product + rest)


def product_yardstick(torch, sk, case: Case, route: str):
    """A yardstick, not the library call (no one call computes kernel A):
    ``(ms, what)`` of the product of the K whole columns alone over rows
    built beforehand (not timed), by torch.matmul, never called by the
    port: under "highest" strict-fp32 SGEMM; under "bf16" one product of
    the rows and columns rounded to bf16; under "high" the three products
    of their bf16 hi and lo planes (hi x lo, lo x hi, hi x hi)."""
    rows = sk.feature_rows(case.x, case.family)
    whole = case.phi_mat[:, :case.k].contiguous()
    if route == "highest":
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ms = time_ms(torch, lambda: rows @ whole)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return ms, f"strict-fp32 torch.matmul of the {case.k} whole columns"
    r_hi, p_hi = rows.bfloat16(), whole.bfloat16()
    if route == "bf16":
        del rows
        return (time_ms(torch, lambda: r_hi @ p_hi),
                f"one bf16 torch.matmul of the {case.k} whole columns")
    r_lo = (rows - r_hi.float()).bfloat16()
    p_lo = (whole - p_hi.float()).bfloat16()
    del rows
    ms = time_ms(torch, lambda: (r_hi @ p_lo, r_lo @ p_hi, r_hi @ p_hi))
    return ms, (f"three bf16 torch.matmul of the planes of the {case.k} "
                f"whole columns")


def label_ties_only(torch, sk, case: Case, labels, labels_plain, route: str,
                    hard: bool) -> int:
    """Kernel A's labels against another kernel's or the plain version's of
    the same product ``route``: a label may differ only where the top two
    logits of the plain product (with the label noise, soft) tie to within
    1e-4 of the larger, the float32 rounding of an F-term dot product in
    another order (under "bf16" and "high" both sides round their operands
    to bf16 planes alike, so there too only the order of the float32 sums
    differs).  Returns the count of flips."""
    k = case.k
    diff = torch.nonzero(labels != labels_plain)[:, 0]
    if diff.numel():
        rows = sk.feature_rows(case.x[diff], case.family)
        ll = sk.ll_product(rows, case.phi_mat[:, :k], route) + case.log_w
        if not hard:
            g = diff.long()
            ll = ll + sk.gumbel_noise(sk.tile_seeds(SEED, g, HASH_TILE),
                                      g % HASH_TILE, k)
        top2 = torch.topk(ll, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        bad = gap > 1e-4 * top2[:, 0].abs().clamp(min=1.0)
        assert not bool(bad.any()), (
            f"labels differ beyond near ties at {int(bad.sum())} points "
            f"({'hard' if hard else 'soft'}, {route})")
    return int(diff.numel())


def sub_ties_only(torch, sk, case: Case, labels, sub, sub_plain,
                  same, route: str = "high") -> int:
    """Kernel A's sub-labels under the three-pass split against the plain
    version's at the points whose labels are equal (``same``): where they
    differ, the draw ``delta + (G_r - G_l) + 1e-30`` must lie within 2e-5
    of ``|row| . |delta column|`` of 0 (float64 here): both take the split,
    1.15e-5 of the terms off the float32 delta, in other orders.  Under
    one bf16 pass (``route`` "bf16") both sides' delta is the product of
    the bf16-rounded row and column, in other orders, so the draw is taken
    from those.  Returns the count of such ties."""
    idx = torch.nonzero(same & (sub != sub_plain))[:, 0]
    if not idx.numel():
        return 0
    k = case.k
    rows = sk.feature_rows(case.x[idx], case.family)
    col = case.phi_mat[:, k:].T[labels[idx].long()]
    if route == "bf16":
        rows, col = rows.bfloat16(), col.bfloat16()
    rows, col = rows.double(), col.double()
    delta = (rows * col).sum(1)
    scale = (rows.abs() * col.abs()).sum(1)
    g = idx.long()
    s = sk.tile_seeds(SEED, g, HASH_TILE) ^ 0xA5A5A5A5
    g2 = sk.gumbel_noise(s, g % HASH_TILE, 2).double()
    draw = (delta + (g2[:, 1] - g2[:, 0]) + 1e-30).abs()
    bad = draw > 2e-5 * scale + 1e-6
    assert not bool(bad.any()), (
        f"sub-labels differ beyond near ties at {int(bad.sum())} points")
    return int(idx.numel())


def check_assign_both(torch, sk, out: dict, key: str, name: str, case: Case,
                      smi: str, high: bool = False, bf16: bool = False
                      ) -> None:
    """Kernel A at both precisions, the two times side by side:
    ``out[key]`` is the "default" result (the fits' kernel), ``out[key +
    " highest"]`` the exact one; with ``high`` also the three-pass split
    ("high", ``out[key + " high"]``), with ``bf16`` also one bf16 pass of
    whole and delta columns (``out[key + " bf16"]``; on float32 rows the
    earlier "default")."""
    extra = (("high",) if high else ()) + (("bf16",) if bf16 else ())
    res = {p: check_assign(torch, sk, name, case, smi, p)
           for p in ("highest", "default") + extra}
    passes = {p: r.pop("pass_ms") for p, r in res.items()}
    hi, de = res["highest"], res["default"]
    for p in extra:
        out[f"{key} {p}"] = res[p]
        log(f"{name}: \"{p}\" {res[p]['ms']:.3f} ms, assign pass "
            f"alone {passes[p]:.3f} ms, same call ({smi})")
    log(f"{name}: \"default\" {de['ms']:.3f} ms beside \"highest\" "
        f"{hi['ms']:.3f} ms ({hi['ms'] / de['ms']:.2f}x); assign pass alone "
        f"{passes['default']:.3f} beside {passes['highest']:.3f} ms "
        f"({passes['highest'] / passes['default']:.2f}x), same call ({smi})")
    out[key] = de
    out[key + " highest"] = hi


def plain_stats_f64(torch, sk, x, labels, sub, valid, k: int, family: str):
    """The plain version's sums, and the sums of the terms' magnitudes,
    taken in float64: the reference where one key holds all N points (a
    float32 sum of N terms rounds by up to about N * 2^-24 of their
    magnitudes in any order, index_add_'s included)."""
    keys = sk.stat_keys(labels, sub, valid, k)
    f = sk.feature_dim(family, x.shape[1])
    out = torch.zeros((2, 2 * k + 1, f), dtype=torch.float64, device=x.device)
    for p0 in range(0, x.shape[0], 1 << 16):
        rows = sk.feature_rows(x[p0:p0 + (1 << 16)], family).double()
        out[0].index_add_(0, keys[p0:p0 + (1 << 16)], rows)
        out[1].index_add_(0, keys[p0:p0 + (1 << 16)], rows.abs())
    return out[0, :2 * k], out[1, :2 * k]


def check_stats(torch, sk, name: str, case: Case, smi: str) -> dict:
    """Kernel B against its plain version under each of stat_labelings'
    label sets (uniform, one key, fit): rtol 1e-4 / atol 1e-3 (one key,
    where each sum has N terms: against the plain sums in float64, within
    1e-5 of the terms' magnitudes), two launches equal, its key sort equal
    to the plain sort; each set timed.  The report keeps the uniform
    labels' numbers."""
    x, valid, k = case.x, case.valid, case.k
    n = x.shape[0]
    times, errs = {}, {}
    for what, (labels, sub) in stat_labelings(torch, sk, case).items():
        def run():
            return sk.stats_from_labels(x, labels, sub, valid, k, case.family)

        stb = run()
        if what == "one key":
            want, mag = plain_stats_f64(torch, sk, x, labels, sub, valid, k,
                                        case.family)
            errs[what] = close_sums(torch, stb.double(), want, mag)
        else:
            errs[what] = close(torch, stb, sk.stats_from_labels_reference(
                x, labels, sub, valid, k, case.family), 1e-4, 1e-3)
        assert torch.equal(stb, run()), f"{name} is not deterministic"
        got, want = (sk.key_sort(labels, sub, valid, k),
                     sk.key_sort_reference(labels, sub, valid, k))
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), \
            f"{name}: the key sort differs from the plain sort ({what})"
        times[what] = time_ms(torch, run)
        log(f"{name}, {what} labels ({key_profile(torch, labels, sub, valid, k)}"
            f"): {times[what]:.3f} ms; key sort equals the plain sort; max "
            f"abs err {errs[what]:.3g}")
        if what == "uniform":
            uniform, st_uniform = (labels, sub), stb
            sort_ms = time_ms(torch, lambda: sk.key_sort(*uniform, valid, k))
            plain_ms = time_ms(torch, lambda: sk.stats_from_labels_reference(
                x, *uniform, valid, k, case.family))
    ms, err = times["uniform"], errs["uniform"]
    labels, sub = uniform
    f = st_uniform.shape[1]
    library_ms = yardstick = None
    key = torch.where(valid, sub.long() * k + labels.long(), 2 * k)
    zeros = torch.zeros((2 * k + 1, f), device=x.device)
    if case.family == "precomputed":
        # the one PyTorch call that computes the same sums: index_add_ of
        # every row, invalid rows keyed to a spare row 2K
        def library():
            return torch.index_add(zeros, 0, key, x)

        close(torch, library()[:2 * k], st_uniform, 1e-4, 1e-3)
        library_ms = time_ms(torch, library)
    elif case.family in ("gaussian", "multinomial"):
        # a yardstick, not the library call: index_add_ over the rows built
        # beforehand (their build not timed)
        rows = sk.feature_rows(x, case.family)
        yardstick = time_ms(torch, lambda: torch.index_add(zeros, 0, key,
                                                           rows))
        del rows
    # reads the rows, labels, sub-labels and valid once, writes the
    # statistics; one add a statistic and the built rows' products
    b = least_time(case.row_bytes() + 9 * n + 4 * 2 * k * f,
                   n * case.built + int(valid.sum()) * f)
    log(f"{name}: {ms:.3f} ms uniform, {times['one key']:.3f} one key, "
        f"{times['fit']:.3f} fit labels (key sort alone {sort_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, library {library_ms} ms, index_add_ over "
        f"prebuilt rows {yardstick} ms (a yardstick), bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}) (N={n}, F={f}, K={k}; "
        f"{smi}); max abs err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                library_ms=library_ms)


def stat_labelings(torch, sk, case: Case) -> dict:
    """Kernel B's three label sets on a case's rows, as (labels, sub):
    uniform over the 2K keys, every point in key 0, and the labels and
    sides of one kernel A call on the same rows (ll_precision "default")."""
    n, dev, k = case.x.shape[0], case.x.device, case.k
    gen = torch.Generator(device=dev).manual_seed(3)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    fit = sk.fused_assign(*case.args(), False, **case.kw(),
                          ll_precision="default")
    return {
        "uniform": (torch.randint(0, k, (n,), generator=gen, device=dev,
                                  dtype=torch.int32),
                    torch.randint(0, 2, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)),
        "one key": (zeros, zeros),
        "fit": (fit[0], fit[1]),
    }


def key_profile(torch, labels, sub, valid, k: int) -> str:
    """How many keys hold points, and the largest key's share."""
    keep = valid & (labels >= 0) & (labels < k) & (sub >= 0) & (sub < 2)
    counts = torch.bincount((sub.long() * k + labels.long())[keep],
                            minlength=2 * k)
    return (f"{int((counts > 0).sum())} of {2 * k} keys hold points, the "
            f"largest {float(counts.max()) / max(1, int(keep.sum())):.1%}")


# Kernel B's fixed input for its digest, at the 10M x 64-d fit's shape
# ("gaussian": D=64, K=256) and the flagship's ("precomputed": the features
# of D=32 points, F=561, K=128)
DIGEST_CASES = (("gaussian", 64, 256), ("precomputed", 32, 128))
# sha256 of kernel B's statistics on digest_inputs, as the kernel before the
# key sort (csrc/stats_from_labels.cu at d1582c7) gave them on an NVIDIA
# H100 80GB HBM3 (``python3 chip_smoke.py --kernel-b`` from a checkout of
# that commit): the redesign adds in the same order, so the same bits
B_DIGESTS = {
    "gaussian":
        "ed426abc5d1813bc3d337d3ecc2ae08798b70f3c0e322817f35df86846db7f34",
    "precomputed":
        "5c4401a7c30fb80b92994243aa39b71ede6ad41f6bf85c3b083f10a93bdfaab7",
}


def digest_inputs(torch, dev, family: str, d: int, k: int):
    """N_CHECK standard-normal points seeded 7 (their Gaussian features for
    "precomputed"), uniform labels and sides with every 997th label out of
    range, every 1009th side 2 and the last 1000 points invalid."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN

    rng = np.random.default_rng(7)
    x = rng.standard_normal((N_CHECK, d), dtype=np.float32)
    labels = rng.integers(0, k, N_CHECK).astype(np.int32)
    sub = rng.integers(0, 2, N_CHECK).astype(np.int32)
    labels[::997] = k
    sub[::1009] = 2
    valid = np.ones(N_CHECK, bool)
    valid[-1000:] = False
    x, labels, sub, valid = (torch.as_tensor(a).to(dev)
                             for a in (x, labels, sub, valid))
    if family == "precomputed":
        x = GAUSSIAN.features(x)
    return x, labels, sub, valid


def b_digests(torch, sk, dev) -> dict:
    """sha256 of kernel B's output bytes on each digest input."""
    out = {}
    for family, d, k in DIGEST_CASES:
        x, labels, sub, valid = digest_inputs(torch, dev, family, d, k)
        st = sk.stats_from_labels(x, labels, sub, valid, k, family)
        out[family] = hashlib.sha256(st.cpu().numpy().tobytes()).hexdigest()
        del x, st
    return out


def kernel_b_cases(torch, dev):
    """Kernel B's four variants at the main paths' shapes (check_kernels'
    rows), as (variant, Case)."""
    from dpmmsubclusters_tpu_torch.utils.generators import generate_mnmm_data

    x, _ = separated_data(N_CHECK, D_FLAG, K_TRUE_FLAG)
    x = (x - x.mean(0)) / x.std(0)
    yield "precomputed", Case(torch, dev, x, "gaussian", K_MAX_FLAG,
                              cache="float32")
    yield "bfloat16", Case(torch, dev, x, "gaussian", K_MAX_FLAG,
                           cache="bfloat16")
    x, _ = separated_data(N_CHECK, 64, 100)
    x = (x - x.mean(0)) / x.std(0)
    yield "gaussian", Case(torch, dev, x, "gaussian", 256)
    x, _, _ = generate_mnmm_data(N_CHECK, 100, 20, 120, seed=1)
    yield "multinomial", Case(torch, dev, x, "multinomial", 64)


def device_ms_by_kernel(torch, fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` by kernel (torch.profiler, ``reps``
    calls after a warm-up), keyed by the kernel's name up to its template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+_kernel)", ev.name)
            name = found.group(1) if found else ev.name[:40]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / (
                1e3 * reps)
    return {k: round(v, 4) for k, v in out.items()}


def device_ms(torch, fn, reps: int = 10) -> float:
    """Device ms a call of ``fn``: the sum of its kernels' times in
    torch.profiler (:func:`device_ms_by_kernel` over ``reps`` calls)."""
    return round(sum(device_ms_by_kernel(torch, fn, reps).values()), 4)


def host_us(torch, fn, reps: int = 1000) -> float:
    """Host microseconds a call of ``fn`` takes to return (its launches
    enqueued, the card not waited for), the mean over ``reps`` calls (few
    enough that the launch queue does not fill)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def kernel_b_main() -> int:
    """``--kernel-b``: kernel B's digests and its times in each variant
    under the three label sets, one JSON line each, with whichever
    dpmmsubclusters_tpu_torch this directory holds (the A/B of two trees:
    copy this file into each)."""
    import torch

    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    print(json.dumps({"digests": b_digests(torch, sk, dev), "card": smi}),
          flush=True)
    for variant, case in kernel_b_cases(torch, dev):
        for what, (labels, sub) in stat_labelings(torch, sk, case).items():
            ms = time_ms(torch, lambda: sk.stats_from_labels(
                case.x, labels, sub, case.valid, case.k, case.family))
            parts = device_ms_by_kernel(torch, lambda: sk.stats_from_labels(
                case.x, labels, sub, case.valid, case.k, case.family))
            print(json.dumps({
                "variant": variant, "labels": what, "ms": ms,
                "device_ms_by_kernel": parts,
                "keys": key_profile(torch, labels, sub, case.valid, case.k),
                "card": smi}), flush=True)
        del case
        free(torch)
    return 0


# Kernel A's exact route on fixed inputs for its digest: N_DIGEST points
# (ragged: no multiple of any block), the last 1000 invalid, hash tile 512
# at tile_off 3; phi of the family's form with whole column 3 and the delta
# column of label 5 NaN, one inactive slot.  The f32 cache at F=561 (D=32)
# at K = 15, 32, 63, 128 (the earlier kernel's four one-pass widths, odd K
# taking 4-byte phi copies), 129 and 256 (passes); rows built at D=64
# (F=2145) at K = 128 and 256; multinomial at D=100, K=64; the bf16 cache
# at F=561, K=128; hybrid at D=64, K=256.
N_DIGEST = 300_007
A_DIGEST_CASES = tuple(
    [("precomputed", 32, k) for k in (15, 32, 63, 128, 129, 256)]
    + [("gaussian", 64, 128), ("gaussian", 64, 256),
       ("multinomial", 100, 64), ("bfloat16", 32, 128), ("hybrid", 64, 256)])
# sha256 of kernel A's labels and sub-labels under ll_precision "highest",
# hard then soft, on a_digest_inputs, as the earlier exact kernel
# (csrc/fused_assign.cu + row_products.cuh at 8ddad29) gave them on an
# NVIDIA H100 80GB HBM3 (``python3 chip_smoke.py --kernel-a`` from a
# checkout of that commit): the redesign keeps every sum's order, so the
# same bits
A_DIGESTS = {
    "precomputed K=15":
        "c4b1835bfabe704c04944624c894c9cb774fb75d0d50d563a1c141736c6e538b",
    "precomputed K=32":
        "066ebe2d39e8ea6baf8a18bc2962e6a04690298b2542cbdf69cd33a5c7052386",
    "precomputed K=63":
        "f71e1456451d5bc246277a877e245f0c0e1edb79993e2cee0672359afcc49de4",
    "precomputed K=128":
        "b7a66d49460634b42c57585215902c3a147e133a83815ab9cf603282c63a39d4",
    "precomputed K=129":
        "7a08678b0e20e3e3925e1269a0446794a8c45633ed7122b46ca29080df4b6060",
    "precomputed K=256":
        "37d3e3f274071d4c0c0edb50bbb3d06f003b2c637e70c2f8ee43849d5088e920",
    "gaussian K=128":
        "0bf411d8b3eb421148487e50a274dbb2a2ebac045476eb0fe5eac963b05361f6",
    "gaussian K=256":
        "f2f7100518211c290433c90ff87c88e80c11538aed9762379fd3ea27dbe63640",
    "multinomial K=64":
        "d06d014d93922349273fb5e9f2c36d4dc19465836b5b9858beb4d94546ada49b",
    "bfloat16 K=128":
        "17cdac25dad1292e0f726dfb28185272c28f28870a012f3692db560613912f3e",
    "hybrid K=256":
        "566b24a46d47f37f3ee5a0d86fef62937a02f80c3d68544d46de055d03356c43",
}


# Kernel A under "default" at a table width of 256 whose slots past a live
# set are inactive (log_w -inf), on a_digest_inputs at D=64: the ring's
# three-pass split on rows built from the points ("gaussian") and the
# tensor-map kernel's one bf16 pass over the hybrid cache ("hybrid"); live:
# the first 100 slots, then those and slot 200.  sha256 of the labels and
# sub-labels, hard then soft, as the kernels that ran every pass of the
# width (c4a519b, ``python3 chip_smoke.py --tc-digests`` from a checkout of
# that commit on an NVIDIA H100 80GB HBM3) gave them: the passes past the
# highest live column change no bit
TC_LIVE = {"prefix 100": list(range(100)),
           "prefix 100 and 200": list(range(100)) + [200]}
TC_DIGESTS = {
    "gaussian K=256 live prefix 100":
        "5a904b9d900bdc60bda3dfbe7ec6e603f7995f02931a66537599474d3cfac48c",
    "gaussian K=256 live prefix 100 and 200":
        "7a9207eb5db5aae0497af9dd04f646bb3307d216265b045910e7295dbc982d27",
    "hybrid K=256 live prefix 100":
        "f0d9f9ae416a8e752cb6a768282413934110b5cdd00a22e562bc49f8e1d4717c",
    "hybrid K=256 live prefix 100 and 200":
        "957f74d838c00939cd3911fcba97313c2b19e71f34c3e9ed046562745b9b2f40",
}


# Kernel A under "default" at the narrow pass widths that the resident
# kernel takes (csrc/fused_assign_tc_resident.cuh, sk.resident_bufs), on
# a_digest_inputs: the multinomial counts at K=64 (F=101, two slices), all
# slots live and with the slots past the first 20 inactive (the 20M counts
# cell's width and live K), and the f32 cache at D=2 (F=6) at K=8 and 32.
# (Rows at F=561, the flagship's, never take it: nine slices.)  sha256 of
# the labels and sub-labels, hard then soft, as fused_assign_tc.cuh's
# 64-point blocks (91a32d1, ``python3 chip_smoke.py --narrow-digests`` from
# a checkout of that commit on an NVIDIA H100 80GB HBM3) gave them: the
# same products in the same order, so the same bits
NARROW_CASES = {"multinomial K=64 live 20": ("multinomial", 100, 64, 20),
                "multinomial K=64": ("multinomial", 100, 64, None),
                "precomputed D=2 K=8": ("precomputed", 2, 8, None),
                "precomputed D=2 K=32": ("precomputed", 2, 32, None)}
NARROW_DIGESTS = {
    "multinomial K=64 live 20":
        "ae2eeead173e94d776028ff94fb6b7ec336cf2df3abbb6a4a0bf3874da4d1682",
    "multinomial K=64":
        "134f2a9f1cc3f93a14cb51942d1ebeeddd2c0b19dad47b6ac5926e0d95fc1c27",
    "precomputed D=2 K=8":
        "35387a6a3d0c2ca0eaedd3d7a53d599d2f0a5e20db49c77f08a80783a02e413c",
    "precomputed D=2 K=32":
        "eda4b1d5982f34107a1b933d8d907b09a0708fcc2bf9b1526e3419babae34eac",
}


def a_digest_inputs(torch, dev, family: str, d: int, k: int):
    """(args, kwargs) of kernel A on its digest input (numpy-seeded; see
    A_DIGEST_CASES)."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN
    from dpmmsubclusters_tpu_torch.sampler.driver import bf16_features

    rng = np.random.default_rng(11)
    n = N_DIGEST
    z = rng.integers(0, k, n)
    if family == "multinomial":
        p = rng.dirichlet(np.ones(d), size=k)
        x = rng.multinomial(60, p[z]).astype(np.float32)
        lp_l = np.log(p * rng.uniform(0.9, 1.1, p.shape))
        lp_r = np.log(p * rng.uniform(0.9, 1.1, p.shape))
        whole = np.concatenate([np.zeros((1, k)), np.log(p).T])
        delta = np.concatenate([rng.normal(0, 0.1, (1, k)), (lp_r - lp_l).T])
    else:
        mu = rng.standard_normal((k, d)) * 0.35
        x = (mu[z] + rng.standard_normal((n, d))).astype(np.float32)

        def natural(m, lam):
            """phi of N(m, lam^-1) on the rows [1, x, triu(x x^T)]."""
            iu = np.triu_indices(d)
            quad = np.where(iu[0] == iu[1], -0.5, -1.0) * lam[iu]
            lin = lam @ m
            const = (-0.5 * m @ lin + 0.5 * np.linalg.slogdet(lam)[1]
                     - 0.5 * d * np.log(2 * np.pi))
            return np.concatenate([[const], lin, quad])

        whole, delta = [], []
        for j in range(k):
            a = rng.normal(0, 0.02, (d, d))
            lam = np.eye(d) + (a + a.T) / 2
            eps = rng.normal(0, 0.05, d)
            whole.append(natural(mu[j], lam))
            delta.append(natural(mu[j] + eps, lam) - natural(mu[j] - eps, lam)
                         + rng.normal(0, 0.1))
        whole, delta = np.stack(whole, 1), np.stack(delta, 1)
    phi = np.ascontiguousarray(np.concatenate([whole, delta], 1),
                               dtype=np.float32)
    phi[:, 3] = np.nan
    phi[:, k + 5] = np.nan
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    log_w[k - 1] = -np.inf
    valid = np.ones(n, bool)
    valid[-1000:] = False
    x, phi, log_w, valid = (torch.as_tensor(a).to(dev)
                            for a in (x, phi, log_w, valid))
    kw = dict(tile=HASH_TILE, ll_precision="highest", family_name=family)
    if family == "precomputed":
        x = GAUSSIAN.features(x)
    elif family in ("bfloat16", "hybrid"):
        if family == "hybrid":
            kw["x_raw"] = x
        x = bf16_features(GAUSSIAN, x, SEED)
    return (x, valid, phi, log_w, SEED, 3), kw


def a_digests(torch, sk, dev) -> dict:
    """sha256 of kernel A's labels and sub-labels (hard, then soft) on each
    digest input."""
    out = {}
    for family, d, k in A_DIGEST_CASES:
        args, kw = a_digest_inputs(torch, dev, family, d, k)
        h = hashlib.sha256()
        for hard in (True, False):
            labels, sub, _ = sk.fused_assign(*args, hard, **kw)
            h.update(labels.cpu().numpy().tobytes())
            h.update(sub.cpu().numpy().tobytes())
        out[f"{family} K={k}"] = h.hexdigest()
        del args, kw
    return out


def tc_digests(torch, sk, dev) -> dict:
    """sha256 of kernel A's labels and sub-labels (hard, then soft) under
    "default" on each :data:`TC_LIVE` case of the width-256 digest inputs
    (:data:`TC_DIGESTS`)."""
    out = {}
    for family in ("gaussian", "hybrid"):
        args, kw = a_digest_inputs(torch, dev, family, 64, 256)
        x, valid, phi, log_w, seed, tile_off = args
        kw["ll_precision"] = "default"
        for name, live in TC_LIVE.items():
            w = torch.full_like(log_w, float("-inf"))
            w[live] = log_w[live]
            h = hashlib.sha256()
            for hard in (True, False):
                labels, sub, _ = sk.fused_assign(x, valid, phi, w, seed,
                                                 tile_off, hard, **kw)
                h.update(labels.cpu().numpy().tobytes())
                h.update(sub.cpu().numpy().tobytes())
            out[f"{family} K=256 live {name}"] = h.hexdigest()
        del args, kw, x
    return out


def narrow_digests(torch, sk, dev) -> dict:
    """sha256 of kernel A's labels and sub-labels (hard, then soft) under
    "default" on each :data:`NARROW_CASES` input (:data:`NARROW_DIGESTS`)."""
    out = {}
    for name, (family, d, k, live) in NARROW_CASES.items():
        args, kw = a_digest_inputs(torch, dev, family, d, k)
        x, valid, phi, log_w, seed, tile_off = args
        kw["ll_precision"] = "default"
        if live is not None:
            log_w = log_w.clone()
            log_w[live:] = float("-inf")
        h = hashlib.sha256()
        for hard in (True, False):
            labels, sub, _ = sk.fused_assign(x, valid, phi, log_w, seed,
                                             tile_off, hard, **kw)
            h.update(labels.cpu().numpy().tobytes())
            h.update(sub.cpu().numpy().tobytes())
        out[name] = h.hexdigest()
        del args, kw, x
    return out


def narrow_digests_main() -> int:
    """``--narrow-digests``: :func:`narrow_digests` with whichever
    dpmmsubclusters_tpu_torch this directory holds, one JSON line."""
    import torch

    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(json.dumps({"narrow_digests": narrow_digests(torch, sk, dev),
                      "card": profiling.card(dev)}), flush=True)
    return 0


def tc_digests_main() -> int:
    """``--tc-digests``: :func:`tc_digests` with whichever
    dpmmsubclusters_tpu_torch this directory holds, one JSON line."""
    import torch

    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(json.dumps({"tc_digests": tc_digests(torch, sk, dev),
                      "card": profiling.card(dev)}), flush=True)
    return 0


def kernel_a_main() -> int:
    """``--kernel-a``: kernel A's digests, then its times under each
    ll_precision ("highest", "default", "bf16", "high"), with the share of
    the bound and the device time of each of its kernels, in each variant
    at the kernel checks' shapes (and the f32 cache at K=16 and 32, the
    narrow passes; every other one-bf16-pass shape of the bf16 caches,
    K=16, 32, 64 and 256 of the flagship's and K=64 and 128 of the 10M
    rows', under "default" alone: one bf16 pass there; and the exact route
    over the flagship's bf16 cache unpadded, beside its padded rows), of
    the tile study's full mode at each block size and of kernel D's stage sets, one JSON
    line each, with whichever dpmmsubclusters_tpu_torch this directory
    holds (the A/B of two trees: copy this file into each)."""
    import torch

    from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as kab
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as kts
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling
    from dpmmsubclusters_tpu_torch.utils.generators import generate_mnmm_data

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    print(json.dumps({"digests": a_digests(torch, sk, dev), "card": smi}),
          flush=True)

    def emit(**row):
        print(json.dumps(dict(row, card=smi)), flush=True)

    x, _ = separated_data(N_CHECK, D_FLAG, K_TRUE_FLAG)
    x = (x - x.mean(0)) / x.std(0)
    x64, _ = separated_data(N_CHECK, 64, 100)
    x64 = (x64 - x64.mean(0)) / x64.std(0)
    xm, _, _ = generate_mnmm_data(N_CHECK, 100, 20, 120, seed=1)
    every = ("highest", "default", "bf16", "high")
    shapes = [(name, make, every) for name, make in (
            ("precomputed K=16", lambda: Case(torch, dev, x, "gaussian", 16,
                                              cache="float32")),
            ("precomputed K=32", lambda: Case(torch, dev, x, "gaussian", 32,
                                              cache="float32")),
            ("precomputed", lambda: Case(torch, dev, x, "gaussian",
                                         K_MAX_FLAG, cache="float32")),
            ("precomputed K=256", lambda: Case(torch, dev, x, "gaussian", 256,
                                               cache="float32")),
            ("bfloat16", lambda: Case(torch, dev, x, "gaussian", K_MAX_FLAG,
                                      cache="bfloat16")),
            ("gaussian", lambda: Case(torch, dev, x64, "gaussian", 256)),
            ("hybrid", lambda: Case(torch, dev, x64, "gaussian", 256,
                                    cache="bfloat16").as_hybrid()),
            ("multinomial", lambda: Case(torch, dev, xm, "multinomial", 64)))]
    for k in (16, 32, 64, 256):
        shapes.append((f"bfloat16 K={k}", lambda k=k: Case(
            torch, dev, x, "gaussian", k, cache="bfloat16"), ("default",)))
    for k in (64, 128):
        shapes.append((f"hybrid K={k}", lambda k=k: Case(
            torch, dev, x64, "gaussian", k, cache="bfloat16").as_hybrid(),
            ("default",)))
    for name, make, precisions in shapes:
        case = make()
        for prec in precisions:
            route = sk.ll_route(case.family, prec)

            def call():
                return sk.fused_assign(*case.args(), False, **case.kw(),
                                       ll_precision=prec)
            ms = time_ms(torch, call)
            b = assign_bound(case, route)
            emit(variant=name, ll_precision=prec, ms=ms, **b,
                 share=b["bound_ms"] / ms,
                 kernels=device_ms_by_kernel(torch, call))
        if name == "bfloat16":
            # the exact route over the same values unpadded: what the
            # port's row pitch costs it
            case.x = case.x.contiguous()

            def call():
                return sk.fused_assign(*case.args(), False, **case.kw(),
                                       ll_precision="highest")
            emit(variant="bfloat16 unpadded", ll_precision="highest",
                 ms=time_ms(torch, call),
                 kernels=device_ms_by_kernel(torch, call))
        del case
        free(torch)
    xs, valid, phi, log_w = kts.inputs(N_CHECK, D_FLAG, K_MAX_FLAG, dev)
    for cta in sk.CTA_POINTS:
        emit(study="tile_study_full", cta_points=cta, ms=time_ms(
            torch, lambda: kts.variant(SEED, xs, valid, phi, log_w, tile=512,
                                       cta_points=cta)))
    del xs, valid, phi, log_w
    free(torch)
    f = 1 + D_FLAG + D_FLAG * (D_FLAG + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2)
    args = (torch.randn((N_CHECK, f), generator=gen, device=dev),
            torch.ones(N_CHECK, dtype=torch.bool, device=dev),
            torch.randn((f, 3 * K_MAX_FLAG), generator=gen, device=dev),
            torch.log(torch.full((K_MAX_FLAG,), 1.0 / K_MAX_FLAG,
                                 device=dev)),
            torch.log(torch.full((2, K_MAX_FLAG), 0.5, device=dev)))
    for name, stages in kab.VARIANTS:
        emit(study="kernel_ablate", set=name, ms=time_ms(
            torch, lambda: kab.variant(SEED, *args, tile=kab.TILE,
                                       stages=stages)))
    return 0


def chain_quality_main() -> int:
    """``--chain-quality``: 1M x 64-d, K_true=100, k_max=256, no cache,
    seeds 1-5, under ll_precision "default" beside "highest": per fit K,
    NMI, the first sweep at K=100 and ms/sweep, one JSON line each."""
    import torch

    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = profiling.card("cuda")
    k_true = 100
    x, gt = separated_data(1_000_000, 64, k_true)
    cfg = dict(k_max=256, chunk_size=16384, burnout=5, alpha=10.0,
               track_posterior=False, merge_candidates=1024, iters=200,
               precompute_features=False)
    for seed in range(1, 6):
        for prec in ("default", "highest"):
            t0 = time.perf_counter()
            res = dpmm.fit(x, device="cuda", verbose=False, gt=gt, seed=seed,
                           ll_precision=prec, **cfg)
            secs = time.perf_counter() - t0
            ks = res.history.k
            first = next((i + 1 for i, kk in enumerate(ks) if kk == k_true),
                         None)
            print(json.dumps({
                "seed": seed, "ll_precision": prec, "k": res.k,
                "nmi": dpmm.nmi(gt, res.labels), "first_sweep_at_k": first,
                "sweeps": len(ks),
                "ms_per_sweep": float(np.median(res.history.times[-40:]))
                * 1e3, "fit_s": secs, "card": smi}), flush=True)
            del res
            free(torch)
    return 0


def twin_gate(torch, sk, case: Case) -> None:
    """The "gaussian" variants on x against the "precomputed" ones on
    GaussianFamily.features(x): labels, sub-labels and statistics equal bit
    for bit under both precisions (the rows are built as the cache's
    rounded products, so they feed the same FMA chains and round to the
    same bf16 values)."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN

    feat = GAUSSIAN.features(case.x)
    for prec in ("highest", "default"):
        for hard in (True, False):
            built = sk.fused_assign(*case.args(), hard, **case.kw(),
                                    ll_precision=prec)
            cache = sk.fused_assign(feat, *case.args()[1:], hard,
                                    tile=HASH_TILE, ll_precision=prec)
            for what, b, c in zip(("labels", "sub-labels", "stats"), built,
                                  cache):
                assert torch.equal(b, c), (f"kernel A twins differ under "
                                           f"{prec}: {what}")
    labels, sub = built[0], built[1]
    assert torch.equal(
        sk.stats_from_labels(case.x, labels, sub, case.valid, case.k,
                             "gaussian"),
        sk.stats_from_labels(feat, labels, sub, case.valid, case.k)), \
        "kernel B twins differ"
    log(f"twin gate: gaussian == precomputed bit for bit for A (hard, soft; "
        f"highest, default) and B (N={case.x.shape[0]}, "
        f"D={case.x.shape[1]}, K={case.k})")


def bf16_twin_gate(torch, sk, case: Case) -> None:
    """The "bfloat16" variants on a bf16 cache against the "precomputed"
    ones on cache.float(): labels, sub-labels and statistics equal bit for
    bit under "highest", and under "default" against "precomputed" under
    "bf16", the route a bf16 cache takes (the upcast is exact and feeds the
    same FMA chains; a bf16 value rounds to itself), where both take the
    same kernel (K <= 64).  Above K = 64 a bf16 cache takes
    fused_assign_tc_tma.cuh's kernel, whose float32 sums run in another
    order than the float32 rows' kernel: there the labels must be equal
    but at near ties and the sub-labels equal wherever the labels are but
    at near ties of their draw (:func:`tie_flips_only`), and the
    statistics are kernel B's at the kernel's labels.  The "hybrid" labels
    and sub-labels equal the "bfloat16" ones, and its statistics equal
    kernel B "gaussian" on the raw points at those labels."""
    hyb = case.as_hybrid()
    twin_x = case.x.float()
    flips = []
    for prec, hard in ((p, h) for p in ("highest", "default")
                       for h in (True, False)):
        # a bf16 cache takes "default" as one bf16 pass of whole and delta
        # columns: the twin on cache.float() is "bf16"
        route = sk.ll_route("bfloat16", prec)
        twin = sk.fused_assign(twin_x, *case.args()[1:], hard, tile=HASH_TILE,
                               ll_precision=route)
        got = sk.fused_assign(*case.args(), hard, **case.kw(),
                              ll_precision=prec)
        if route == "bf16" and case.k > 64:
            flips.append(tie_flips_only(torch, sk, case, got, twin, hard))
            assert torch.equal(got[2], sk.stats_from_labels(
                case.x, got[0], got[1], case.valid, case.k, "bfloat16")), \
                "kernel A bfloat16 statistics differ from kernel B's"
        else:
            for what, a, b in zip(("labels", "sub-labels", "stats"), got,
                                  twin):
                assert torch.equal(a, b), (f"kernel A bfloat16 twins differ "
                                           f"under {prec}: {what}")
        hy = sk.fused_assign(*hyb.args(), hard, **hyb.kw(), ll_precision=prec)
        assert torch.equal(hy[0], got[0]) and torch.equal(hy[1], got[1]), \
            f"kernel A hybrid labels differ from bfloat16's under {prec}"
        assert torch.equal(hy[2], sk.stats_from_labels(
            case.raw, hy[0], hy[1], case.valid, case.k, "gaussian")), \
            "kernel A hybrid statistics differ from kernel B gaussian"
    assert torch.equal(
        sk.stats_from_labels(case.x, got[0], got[1], case.valid, case.k,
                             "bfloat16"),
        sk.stats_from_labels(twin_x, got[0], got[1], case.valid, case.k)), \
        "kernel B bfloat16 twins differ"
    log(f"bf16 twin gate: bfloat16 == precomputed on cache.float() bit for "
        f"bit for A (hard, soft; highest" + (
            f"; default but {flips} (hard, soft) near-tie label and "
            f"sub-label flips, the kernels' float32 sums in other orders"
            if flips else ", default") + f") and B; hybrid labels equal "
        f"bfloat16's, its statistics == B gaussian (N={case.x.shape[0]}, "
        f"F={case.x.shape[1]}, K={case.k})")


def tie_flips_only(torch, sk, case: Case, got, want, hard: bool) -> tuple:
    """Kernel A's labels and sub-labels ``got`` against ``want`` from
    another kernel of the same product ("bf16", its float32 sums in another
    order): a label may differ only where the top two logits (with the
    label noise, soft) of the plain product tie to within 1e-4 of the
    larger; a sub-label, where the labels are equal, only at a near tie of
    its draw (:func:`sub_ties_only`).  Returns the two counts."""
    flips = label_ties_only(torch, sk, case, got[0], want[0], "bf16", hard)
    same = got[0] == want[0]
    return flips, sub_ties_only(torch, sk, case, got[0], got[1], want[1],
                                same, "bf16")


def check_bf16(torch, sk, out: dict, x, k: int, smi: str, main: bool):
    """Kernel A "bfloat16" and "hybrid" and kernel B "bfloat16" on the bf16
    cache of ``x``: the twin gate, then each against its plain version.
    ``main`` names the shapes the report keeps for a variant."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    case = Case(torch, x.device, x, "gaussian", k, cache="bfloat16")
    torch.cuda.synchronize()
    f = GAUSSIAN.feature_dim(x.shape[1])
    log(f"bf16 cache of {x.shape[0]} x {x.shape[1]}-d (F={f}) built in "
        f"{time.perf_counter() - t0:.3f} s")
    tag = f" F={f} K={k}"
    bf16_twin_gate(torch, sk, case)
    check_assign_both(torch, sk, out,
                      "fused_assign[bfloat16]" + ("" if main else tag),
                      "kernel A bfloat16" + tag, case, smi)
    out["stats_from_labels[bfloat16]" + ("" if main else tag)] = check_stats(
        torch, sk, "kernel B bfloat16" + tag, case, smi)
    check_assign_both(torch, sk, out,
                      "fused_assign[hybrid]" + ("" if not main else tag),
                      "kernel A hybrid" + tag, case.as_hybrid(), smi)
    del case
    torch.cuda.empty_cache()
    # the narrower passes (K <= 64, the fits' early tiers) keep
    # fused_assign_tc.cuh's kernel: the variant the report keeps at K=64
    variant = "bfloat16" if main else "hybrid"
    narrow = Case(torch, x.device, x, "gaussian", 64, cache="bfloat16")
    if not main:
        narrow = narrow.as_hybrid()
    out[f"fused_assign[{variant}] K=64"] = check_assign(
        torch, sk, f"kernel A {variant} F={f} K=64", narrow, smi, "default")
    del narrow
    torch.cuda.empty_cache()


# Kernel E: the TPU test's kernel adds a float lane iota to an (8, 128)
# tile, which Mosaic refuses; in CUDA that is legal, so the gate builds and
# runs it, and refuses the same kernel with an undeclared name
GATE_KERNEL = """#include <cuda_runtime.h>
__global__ void lane_iota(const float* x, float* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + static_cast<float>(i % 128);
}
extern "C" int gate_lane_iota(const float* x, float* o, int n, void* st) {
  lane_iota<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(st)>>>(
      x, o, n);
  return static_cast<int>(cudaGetLastError());
}
"""
GATE_ILL_FORMED = GATE_KERNEL.replace("static_cast<float>(i % 128)",
                                      "undeclared_iota")


def build_gate(torch, _build, smi: str) -> dict:
    """Kernel E, the port of the Mosaic verifier gate
    (tests/test_mosaic_compile.py:88): ``_build.build`` compiles the lane
    iota kernel, which then runs once and matches its plain version, and
    must raise with nvcc's own message on its ill-formed twin."""
    import ctypes

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        good, bad = pathlib.Path(tmp, "good"), pathlib.Path(tmp, "bad")
        good.mkdir()
        bad.mkdir()
        (good / "lane_iota.cu").write_text(GATE_KERNEL)
        (bad / "lane_iota.cu").write_text(GATE_ILL_FORMED)
        lib = ctypes.CDLL(str(_build.build(src_dir=good)))
        t0 = time.perf_counter()
        try:
            _build.build(src_dir=bad)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise AssertionError("build gate: an ill-formed .cu built")
        refused_s = time.perf_counter() - t0
    assert "nvcc failed" in msg and "undeclared_iota" in msg, msg
    line = next(ln for ln in msg.splitlines() if "undeclared_iota" in ln)
    log(f"build gate: the ill-formed lane_iota.cu was refused in "
        f"{refused_s:.2f} s: {line.strip()[-60:]}")

    fn = lib.gate_lane_iota
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    launches = 0
    x = torch.randn((8, 128), device="cuda")   # the TPU kernel's tile
    o = torch.empty_like(x)
    lane = torch.arange(128, dtype=torch.float32, device="cuda")

    def run():
        nonlocal launches
        rc = fn(x.data_ptr(), o.data_ptr(), x.numel(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"lane_iota launch: CUDA error {rc}"
        launches += 1
        return o

    def plain():        # also the one PyTorch call that computes it
        return x + lane

    run()
    torch.cuda.synchronize()
    n_path = launches          # the gate's own run; the checks come after
    err = float((run() - plain()).abs().max())
    assert err == 0.0, f"lane_iota differs from x + iota by {err}"
    ms, plain_ms = time_ms(torch, run), time_ms(torch, plain)
    dev_ms, plain_dev = device_ms(torch, run), device_ms(torch, plain)
    # the host's part of a call: the time each takes to return
    run_us, plain_us = host_us(torch, run), host_us(torch, plain)
    b = least_time(2 * x.numel() * 4, x.numel())
    log(f"build gate: lane_iota built and ran, {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms, host {run_us:.1f} us a call), plain {plain_ms:.4f} "
        f"ms (device {plain_dev:.4f} ms, host {plain_us:.1f} us), bound "
        f"{b['bound_ms']:.2e} ms ({b['bound_by']}) on an (8, 128) tile "
        f"({smi}); max abs err {err}")
    return dict(launches=n_path, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **b, library_ms=plain_ms, device_ms=dev_ms,
                library_device_ms=plain_dev, host_us=run_us,
                library_host_us=plain_us)


def check_kernels(torch, dev, smi: str) -> dict:
    """Every kernel variant against its plain version at the main paths'
    shapes (hash tile 512)."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils.generators import generate_mnmm_data

    out = {}
    # the flagship's rows: 1M x 32-d standardized as fit does, F=561
    x, _ = separated_data(N_CHECK, D_FLAG, K_TRUE_FLAG)
    x = (x - x.mean(0)) / x.std(0)
    case = Case(torch, dev, x, "gaussian", K_MAX_FLAG)
    twin_gate(torch, sk, case)
    del case
    cache = Case(torch, dev, x, "gaussian", K_MAX_FLAG, cache="float32")
    check_assign_both(torch, sk, out, "fused_assign[precomputed]",
                      "kernel A precomputed", cache, smi, high=True,
                      bf16=True)
    out["stats_from_labels[precomputed]"] = check_stats(
        torch, sk, "kernel B precomputed", cache, smi)
    del cache
    for k in (192, 256):      # above one pass of 128 whole columns: any K
        wide = Case(torch, dev, x, "gaussian", k, cache="float32")
        check_assign_both(torch, sk, out, f"fused_assign[precomputed] K={k}",
                          f"kernel A precomputed K={k}", wide, smi,
                          bf16=True)
        del wide
    # "default" on float32 rows at the narrowest pass, the widest pass of
    # fused_assign_tc.cuh's kernel (K <= 64: the fits' early tiers) and one
    # past 128
    for k in (15, 64, 129):
        other = Case(torch, dev, x, "gaussian", k, cache="float32")
        out[f"fused_assign[precomputed] K={k}"] = check_assign(
            torch, sk, f"kernel A precomputed K={k}", other, smi, "default")
        del other
    torch.cuda.empty_cache()
    # the flagship's bf16 caches (bfloat16's main path)
    check_bf16(torch, sk, out, torch.as_tensor(x).to(dev), K_MAX_FLAG, smi,
               main=True)

    # the 10M x 64-d fit's rows, built in the kernels: D=64, F=2145, K=256
    x, _ = separated_data(N_CHECK, 64, 100)
    x = (x - x.mean(0)) / x.std(0)
    case = Case(torch, dev, x, "gaussian", 256)
    check_assign_both(torch, sk, out, "fused_assign[gaussian]",
                      "kernel A gaussian", case, smi, high=True, bf16=True)
    out["stats_from_labels[gaussian]"] = check_stats(
        torch, sk, "kernel B gaussian", case, smi)
    # ... and its 42.9 GB hybrid cache's rows (hybrid's main path): the
    # wide kernel over bf16 rows
    check_bf16(torch, sk, out, case.raw, 256, smi, main=False)
    del case
    torch.cuda.empty_cache()
    for k in (64, 128):       # fused_assign_tc.cuh's kernel, then the ring
        case = Case(torch, dev, x, "gaussian", k)
        out[f"fused_assign[gaussian] K={k}"] = check_assign(
            torch, sk, f"kernel A gaussian K={k}", case, smi, "default")
        del case
    torch.cuda.empty_cache()

    # the multinomial fits' counts: D=100, F=101, K=64
    x, _, _ = generate_mnmm_data(N_CHECK, 100, 20, 120, seed=1)
    case = Case(torch, dev, x, "multinomial", 64)
    check_assign_both(torch, sk, out, "fused_assign[multinomial]",
                      "kernel A multinomial", case, smi, bf16=True)
    out["stats_from_labels[multinomial]"] = check_stats(
        torch, sk, "kernel B multinomial", case, smi)
    del case
    torch.cuda.empty_cache()
    return out


def close_sums(torch, got, want, abs_sum, rtol: float = 1e-5) -> float:
    """Max |got - want| for float32 sums taken in two orders; raises unless
    |got - want| <= rtol * (the sum of the terms' magnitudes) + 1e-6."""
    err = (got - want).abs()
    bad = err > rtol * abs_sum + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} sums outside rtol={rtol} of "
                             f"their terms' magnitudes; max abs err "
                             f"{float(err.max())}")
    return float(err.max())


def check_column_sum(torch, stk, x, smi: str) -> dict:
    """Kernel C (the tile study's dma_only mode) against its plain version
    and torch.sum on the study's x [1M, 640]: the whole call (CUDA events)
    and the device time (torch.profiler, the call's kernels) of each."""
    two = torch.empty((2, x.shape[1]), device=x.device)
    got = stk.column_sum(x, two.clone())
    err = close_sums(torch, got, stk.column_sum_reference(x, two),
                     x.abs().sum(0))
    assert torch.equal(got[:1], stk.column_sum(x)), \
        "column_sum is not deterministic"
    ms = time_ms(torch, lambda: stk.column_sum(x))
    plain_ms = time_ms(torch, lambda: stk.column_sum_reference(x))
    library_ms = time_ms(torch, lambda: torch.sum(x, 0))
    dev = device_ms(torch, lambda: stk.column_sum(x))
    library_dev = device_ms(torch, lambda: torch.sum(x, 0))
    run_us = host_us(torch, lambda: stk.column_sum(x), reps=20)
    library_us = host_us(torch, lambda: torch.sum(x, 0), reps=20)
    n, f = x.shape
    b = least_time(4 * n * f + 4 * f, n * f)
    log(f"kernel C column_sum: {ms:.3f} ms (device {dev:.3f}, host "
        f"{run_us:.1f} us), plain {plain_ms:.3f} ms, torch.sum "
        f"{library_ms:.3f} ms (device {library_dev:.3f}, host "
        f"{library_us:.1f} us), bound {b['bound_ms']:.3f} ms ({b['bound_by']}; "
        f"device share {b['bound_ms'] / dev:.1%}) (N={n}, F={f}; {smi}); "
        f"max abs err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
                library_ms=library_ms, device_ms=dev,
                library_device_ms=library_dev, host_us=run_us,
                library_host_us=library_us)


def check_tile_study(torch, sk, kts, x, valid, phi, log_w, smi: str,
                     out: dict) -> None:
    """The tile study's full mode (kernel A "precomputed" at each hash tile
    and block size): at every tile the 64-, 128- and 256-point blocks give
    the same labels, sub-labels and statistics (the hash does not depend on
    the block); at tile 512 each block size against the plain version."""
    def run(tile, cta):
        return kts.variant(SEED, x, valid, phi, log_w, tile=tile,
                           cta_points=cta)

    for tile in kts.TILES:
        runs = [run(tile, c) for c in sk.CTA_POINTS]
        for cta, other in zip(sk.CTA_POINTS[1:], runs[1:]):
            for what, a, b in zip(("labels", "sub-labels", "stats"),
                                  runs[0], other):
                assert torch.equal(a, b), (f"tile study: {what} at "
                                           f"{cta} points a block differ "
                                           f"from {sk.CTA_POINTS[0]} (tile "
                                           f"{tile})")
    log(f"tile study: labels, sub-labels and statistics equal across "
        f"blocks of {sk.CTA_POINTS} points at hash tiles {kts.TILES}")
    n, f = x.shape
    k = log_w.shape[0]
    lp, sp, _ = sk.fused_assign_reference(x, valid, phi, log_w, SEED, 0,
                                          False, tile=512)
    plain_ms = time_ms(torch, lambda: sk.fused_assign_reference(
        x, valid, phi, log_w, SEED, 0, False, tile=512))
    n_valid = int(valid.sum())
    b = least_time(4 * n * f + n + 4 * (f * 2 * k + k) + 8 * n
                   + 4 * 2 * k * f, 2.0 * n * f * (k + 1) + n_valid * f)
    for cta in sk.CTA_POINTS:
        lk, sk_, stk_ = run(512, cta)
        agree_l = float((lk == lp).float().mean())
        agree_s = float((sk_ == sp).float().mean())
        assert agree_l >= 0.999 and agree_s >= 0.999, (cta, agree_l, agree_s)
        err = close(torch, stk_, sk.stats_from_labels_reference(
            x, lk, sk_, valid, k), 1e-4, 1e-3)
        ms = time_ms(torch, lambda: run(512, cta))
        log(f"tile study full, {cta} points a block: {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}); labels agree {agree_l:.6f}, sub-labels "
            f"{agree_s:.6f} (N={n}, F={f}, K={k}, tile 512; {smi}); max abs "
            f"err {err:.3g}")
        out[f"tile_study_full[cta={cta}]"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **b, library_ms=None)


def check_ablate(torch, sk, stk, kab, dev, smi: str, out: dict,
                 keys=None) -> None:
    """Kernel D, each stage set of the ablation at its full size (1M x
    F=561, K=128, tile 512) against its plain version.  The product is the
    exact float32 one (the ablation of kernel A under ll_precision
    "highest", which the calls of kernel A here take).  The statistics of a
    set are held against the plain statistics at the kernel's own labels:
    kernel A's hard labels ("+stats"; the same FMA chain on the same whole
    columns gives the same bits), its soft labels ("+gumbel"; the same
    noise), and the full set's labels and sides (which also equal kernel
    A's soft labels: a twin gate).  Each set's whole call (CUDA events) and
    device time (torch.profiler), and its library call's where one PyTorch
    call computes the set; with ``keys``, only those sets."""
    n, k, tile = N_CHECK, K_MAX_FLAG, kab.TILE
    f = 1 + D_FLAG + D_FLAG * (D_FLAG + 1) // 2
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n, f), generator=gen, device=dev)
    phi = torch.randn((f, 3 * k), generator=gen, device=dev)
    log_w = torch.log(torch.full((k,), 1.0 / k, device=dev))
    loglrw = torch.log(torch.full((2, k), 0.5, device=dev))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-1000:] = False
    args = (x, valid, phi, log_w, loglrw, SEED)   # kernel_ablate's order

    phi_a = torch.cat([phi[:, :k], phi[:, 2 * k:] - phi[:, k:2 * k]], 1)
    hard = sk.fused_assign(x, valid, phi_a, log_w, SEED, 0, True)[0]
    soft = sk.fused_assign(x, valid, phi_a, log_w, SEED, 0, False)[0]
    full = stk.kernel_ablate(*args, tile=tile, stages=kab.VARIANTS[-1][1])
    assert torch.equal(full[0], soft), "kernel D's labels differ from A's"
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    keeps = {"stats": (hard, zeros), "stats+gumbel": (soft, zeros),
             "stats+gumbel+sub": full[:2],
             "stats+gumbel+sub+write": full[:2]}
    xabs = x.abs().sum(0)
    for name, stages in kab.VARIANTS:
        key = stk.stage_key(stages)
        if keys is not None and key not in keys:
            continue

        def run(stages=stages):       # the study's entry, seed first
            return kab.variant(SEED, *args[:-1], tile=tile, stages=stages)

        def plain(stages=stages):
            return stk.kernel_ablate_reference(*args, tile=tile,
                                               stages=stages)

        (lk, sk_, stk_), (lp, sp, stp) = run(), plain()
        if "write" in stages:
            agree_l = float((lk == lp).float().mean())
            agree_s = float((sk_ == sp).float().mean())
            assert agree_l >= 0.999 and agree_s >= 0.999, (name, agree_l,
                                                           agree_s)
        else:
            assert not lk.any() and not sk_.any(), f"{name}: labels written"
        library = None       # one PyTorch call of the same function
        if key in keeps:
            lab, side = keeps[key]
            err = close(torch, stk_, sk.stats_from_labels_reference(
                x, lab, side, valid, k), 1e-4, 1e-3)
        elif key == "dot_only":
            ll_abs = torch.zeros(3 * k, device=dev)
            for p0 in range(0, n, 1 << 16):
                ll_abs += (x[p0:p0 + (1 << 16)] @ phi).abs().sum(0)
            err = close_sums(torch, stk_[0, :3 * k], stp[0, :3 * k], ll_abs)
            assert not stk_[1:].any() and not stk_[0, 3 * k:].any()

            def library():
                return torch.einsum("nf,fk->k", x, phi)

            close_sums(torch, library(), stp[0, :3 * k], ll_abs, rtol=1e-4)
        elif key in ("dma_only", "stats_raw"):
            rows = 1 if key == "dma_only" else 2 * k
            err = close_sums(torch, stk_[:rows], stp[:rows], xabs)
            assert not stk_[rows:].any()
            if key == "dma_only":
                def library():
                    return torch.sum(x, 0)
        else:                  # "none": every output zero
            assert not stk_.any() and not stp.any()
            err = 0.0
        ms = time_ms(torch, run)
        plain_ms = time_ms(torch, plain)
        library_ms = None if library is None else time_ms(torch, library)
        dev_ms = device_ms(torch, run)
        library_dev = None if library is None else device_ms(torch, library)
        run_us = host_us(torch, run, reps=20)
        library_us = (None if library is None
                      else host_us(torch, library, reps=20))
        # the bound counts what the set's outputs need: x read once, every
        # output (labels, sides, statistics) written once, one add a sum;
        # the product's columns (2 flop a term) only where the labels or
        # the statistics depend on them.  dot_only's sums are colsum(x) @
        # phi, and that is what it computes; "none" and "stats_raw" need no
        # product, though the sink keeps the kernel's product and argmax
        # live (``live``)
        nbytes = 4 * n * f + 8 * n + 4 * 2 * k * f
        flop = 0.0 if key == "none" else float(n * f)
        live = 2.0 * n * f * k
        if key == "dot_only":
            nbytes += 4 * f * 3 * k
            flop += 2.0 * f * 3 * k
            live = flop
        elif "stats" in stages:
            nbytes += n + 4 * (f * k + k)           # valid, whole phi, log_w
            flop = 2.0 * n * f * k + int(valid.sum()) * f
            if "sub" in stages:
                nbytes += 4 * (f * 2 * k + 2 * k)   # left/right phi, loglrw
                flop += 2.0 * n * f * 2
            live = flop
        elif key == "dma_only":
            live = flop
        b = least_time(nbytes, flop)
        live_ms = least_time(nbytes, live)["bound_ms"]
        log(f"kernel D {name} ({key}): {ms:.3f} ms (device {dev_ms:.3f}, "
            f"host {run_us:.1f} us), plain {plain_ms:.3f} ms, library "
            f"{library_ms} ms (device {library_dev}, host {library_us} us), "
            f"bound {b['bound_ms']:.3f} ms "
            f"({b['bound_by']}), bound of the work the kernel keeps live "
            f"{live_ms:.3f} ms (N={n}, F={f}, K={k}, tile {tile}; {smi}); "
            f"max abs err {err:.3g}")
        out[f"kernel_ablate[{key}]"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=plain_ms, **b,
                                            library_ms=library_ms,
                                            device_ms=dev_ms,
                                            library_device_ms=library_dev,
                                            host_us=run_us,
                                            library_host_us=library_us)
        if key == "dot_only":
            # its target is within 15% of the one PyTorch call; the gate
            # only refuses a return to the product over the points (16.7x)
            log(f"kernel D dot_only takes {ms / library_ms:.3f} times "
                f"torch.einsum's time")
            assert ms <= 1.5 * library_ms, (ms, library_ms)
    log("kernel D: the full set's labels equal kernel A's soft labels bit "
        "for bit")


def check_study_kernels(torch, dev, smi: str) -> dict:
    """Kernels C and D and the tile study's kernel A blocks against their
    plain versions at the studies' full sizes."""
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as kab
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as kts
    from dpmmsubclusters_tpu_torch.ops import study_kernels as stk
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    out = {}
    x, valid, phi, log_w = kts.inputs(N_CHECK, D_FLAG, K_MAX_FLAG, dev)
    valid[-1000:] = False
    out["column_sum[dma_only]"] = check_column_sum(torch, stk, x, smi)
    check_tile_study(torch, sk, kts, x, valid, phi, log_w, smi, out)
    del x, valid, phi, log_w
    check_ablate(torch, sk, stk, kab, dev, smi, out)
    torch.cuda.empty_cache()
    return out


def studies_main() -> int:
    """``--studies``: kernel C at 1M x 640 and kernel D's sets that are its
    column sums (dma_only, dot_only, stats_raw) at 1M x 561, K=128, each
    against its plain version, and kernel E; one JSON line each with the
    whole call and the device time beside its library call's, with
    whichever dpmmsubclusters_tpu_torch sits beside this file (an A/B of
    two trees: copy this file into each)."""
    import torch

    from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as kab
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as kts
    from dpmmsubclusters_tpu_torch.ops import _build
    from dpmmsubclusters_tpu_torch.ops import study_kernels as stk
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    out = {}
    x = kts.inputs(N_CHECK, D_FLAG, K_MAX_FLAG, dev)[0]
    out["column_sum[dma_only]"] = check_column_sum(torch, stk, x, smi)
    del x
    free(torch)
    check_ablate(torch, sk, stk, kab, dev, smi, out,
                 keys=("dma_only", "dot_only", "stats_raw"))
    out["build_gate"] = build_gate(torch, _build, smi)
    for name, row in out.items():
        print(json.dumps(dict(row, kernel=name, card=smi)), flush=True)
    return 0


def run_studies(torch) -> dict:
    """The kernel studies' entry points at their full sizes, the tile study
    and the ablation, each with every launch count set to 0 just before it
    and read just after.  Returns the launch counts by path."""
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as kab
    from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as kts
    from dpmmsubclusters_tpu_torch.ops import study_kernels as stk
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    def reset():
        sk.reset_launches()
        stk.reset_launches()

    out = {}
    reset()
    t0 = time.perf_counter()
    kts.main([])
    out["tile_study"] = dict(column_sum=stk.column_sum.launches,
                             fused_assign=dict(sk.fused_assign.launches))
    log(f"tile study ran in {time.perf_counter() - t0:.1f} s, launches "
        f"{out['tile_study']}")
    free(torch)
    reset()
    t0 = time.perf_counter()
    kab.main([])
    out["ablate"] = dict(stk.kernel_ablate.launches)
    log(f"ablation ran in {time.perf_counter() - t0:.1f} s, launches "
        f"{out['ablate']}")
    free(torch)
    return out


def run_fit(torch, name: str, x, gt, variant, **kw) -> dict:
    """One ``fit`` on the card, ground truth given (block-boundary NMI in
    the history), with every launch count set to 0 just before; asserts
    that each kernel ran in its variant (``variant``: one for both, or a
    dict by kernel) and in no other.  Returns the result, NMI, the launch
    counts by kernel and variant, ms/sweep and the cache build's seconds."""
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine

    kernels = (sk.fused_assign, sk.stats_from_labels)
    if isinstance(variant, str):
        variant = dict.fromkeys((fn.__name__ for fn in kernels), variant)
    featurize, feat_s = DPMMEngine.featurize, []

    def timed_featurize(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = featurize(self, *a, **k)
        torch.cuda.synchronize()
        feat_s.append(time.perf_counter() - t0)
        return out

    sk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    DPMMEngine.featurize = timed_featurize
    try:
        t0 = time.perf_counter()
        res = dpmm.fit(x, device="cuda", verbose=False, gt=gt, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        DPMMEngine.featurize = featurize
    counts = {fn.__name__: dict(fn.launches) for fn in kernels}
    for fn, by_variant in counts.items():
        ran = {v for v, c in by_variant.items() if c}
        assert ran == {variant[fn]}, (name, fn, by_variant)
    # kernel A's launches took the tensor cores, but under "highest" the
    # exact kernel
    tc = dict(sk.fused_assign.tensor_core_launches)
    a_variant = variant["fused_assign"]
    exact_f32 = res.model.cfg.ll_precision == "highest"
    assert tc[a_variant] == (0 if exact_f32 else
                             counts["fused_assign"][a_variant]), (name, tc,
                                                                  counts)
    assert sum(tc.values()) == tc[a_variant], (name, tc)
    counts["tensor_core"] = tc
    # ... and above K = 64 over a bf16 cache, the kernel of
    # fused_assign_tc_tma.cuh; under the three-pass split, that of
    # fused_assign_tc_ring.cuh
    counts["tma"] = dict(sk.fused_assign.tma_launches)
    counts["ring"] = dict(sk.fused_assign.ring_launches)
    # at a pass width <= 128 over at most two slices, the resident kernel
    # of fused_assign_tc_resident.cuh
    counts["resident"] = dict(sk.fused_assign.resident_launches)
    # the smart pass's exact per-slot sums on kernel B (sampler/smart.py)
    counts["slot_sums"] = sk.slot_sums.launches
    nmi = dpmm.nmi(gt, res.labels)
    ms_sweep = float(np.median(res.history.times[-40:])) * 1e3
    cache = (f", cache ({res.model.cfg.feature_dtype}) built in "
             f"{feat_s[0]:.3f} s" if feat_s else "")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{name} [ll_precision={res.model.cfg.ll_precision}]: K={res.k} "
        f"NMI={nmi:.6f} in {secs:.1f} s{cache}, median "
        f"{ms_sweep:.2f} ms/sweep over the last 40 sweeps, peak device "
        f"memory {peak:.2f} GB, launches {counts}")
    return dict(res=res, nmi=nmi, launches=counts, ms=ms_sweep,
                featurize_s=feat_s[0] if feat_s else None)


def profile_sweeps(torch, res, x, name: str, smi: str, sweeps: int = 8):
    """Device time by kernel of ``sweeps`` steady sweeps of a fitted model
    (its table, labels and config; the points placed and, with a cache,
    featurized again, timed) under torch.profiler, in ms/sweep."""
    from torch.profiler import ProfilerActivity, profile

    from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine, DPMMState

    m = res.model
    dev = m.table["active"].device
    engine = DPMMEngine(m.family, m.cfg, dev)
    points, valid, n_total = engine.shard_points((x - m.shift) * m._scale)
    feat_s = None
    if m.cfg.precompute_features:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        points = engine.featurize(points, seed=m.cfg.seed)
        torch.cuda.synchronize()
        feat_s = time.perf_counter() - t0
    state = DPMMState(m.table, torch.as_tensor(m.labels_raw).to(dev),
                      torch.as_tensor(m.sublabels).to(dev),
                      torch.Generator(device=dev).manual_seed(0), m.step)
    off = [False]
    state, _ = engine.step_block(state, points, valid, n_total, off, off)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, met = engine.step_block(state, points, valid, n_total,
                                       off * sweeps, off * sweeps)
        met["k"].tolist()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / sweeps
    parts = {"assign pass": 0.0, "key sort": 0.0, "statistics pass": 0.0,
             "chunk reduction": 0.0, "table math": 0.0}
    launches = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        part = ("assign pass" if ("assign" in ev.name
                                 or "stage_phi" in ev.name) else
                "key sort" if "stats_sort" in ev.name else
                "statistics pass" if "stats_partial" in ev.name else
                "chunk reduction" if "stats_reduce" in ev.name else
                "table math")
        parts[part] += us / 1e3 / sweeps
        launches += 1
    busy = sum(parts.values())
    if not launches:
        log(f"profile {name}: torch.profiler traced no device events")
    out = {k: round(v, 3) for k, v in parts.items()}
    log(f"profile {name}, {sweeps} sweeps at width "
        f"{m.table['active'].shape[0]}, K={int(met['k'][-1])}: device "
        f"ms/sweep {out}, {launches / sweeps:.0f} kernel launches a sweep, "
        f"busy {busy:.2f} of {wall:.2f} ms wall (profiled; idle "
        f"{max(0.0, 1 - busy / wall):.1%})"
        + (f", cache rebuilt in {feat_s:.3f} s" if feat_s else "")
        + f" ({smi})")
    del points, state
    return dict(parts=out, wall_ms=wall, featurize_s=feat_s)


class SaveTimer:
    """Times every ``DPMMModel.save`` (a checkpoint written) and every
    ``load_checkpoint`` a resume makes, with the file's size, while
    installed."""

    def __init__(self, torch):
        import dpmmsubclusters_tpu_torch.api as api

        self.torch, self.api, self.events = torch, api, []
        self.save, self.load = api.DPMMModel.save, api.load_checkpoint

    def __enter__(self):
        def save(model, path):
            t0 = time.perf_counter()
            self.save(model, path)
            self.events.append(("write", path, time.perf_counter() - t0))

        def load(path):
            t0 = time.perf_counter()
            out = self.load(path)
            self.events.append(("read", path, time.perf_counter() - t0))
            return out

        self.api.DPMMModel.save, self.api.load_checkpoint = save, load
        return self

    def __exit__(self, *exc):
        self.api.DPMMModel.save, self.api.load_checkpoint = (self.save,
                                                             self.load)

    def report(self, smi: str) -> str:
        import os

        parts = []
        for what in ("write", "read"):
            secs = [t for w, _, t in self.events if w == what]
            sizes = {os.path.getsize(p) for w, p, _ in self.events
                     if w == what}
            parts.append(f"{len(secs)} {what}s of {min(sizes) / 1e6:.2f}-"
                         f"{max(sizes) / 1e6:.2f} MB: median "
                         f"{np.median(secs):.4f} s, max {max(secs):.4f} s")
        return "; ".join(parts) + f" ({smi})"


def run_persistence(torch, x, gt, flag: dict, fused_ms: float,
                    smi: str) -> dict:
    """The persistence path at the flagship's full width, on the card:

    * ``fit(enable_saving=True)`` of the flagship (f32 cache, "default"),
      saving every 20 sweeps (the per-sweep path); ``run_from_checkpoint``
      of sweep 60 to 120: K=64, NMI >= 0.999, ``predict == labels`` on
      every point, 64 cluster parameters, finite ``cluster_statistics``
      with mean responsibility >= 0.99, kernel A launched during the
      resume; and twice of sweep 20 to 120, while the chain still splits:
      K=64, kernels A and B launched during each (counts set to 0 just
      before it; from sweep 60 the chain has converged, nothing splits, and
      kernel B runs only inside kernel A's launches, counted under A), the
      two resumes' labels equal bit for bit;
    * continuation: with ``smart_splits=False``, 40 sweeps saving at 20,
      and a resume of sweep 20 to 40 equal to them bit for bit;
    * the CLI: ``python3 -m dpmmsubclusters_tpu_torch.run params.json`` on
      the flagship's ``.npy`` files, and ``--resume`` of sweep 60 to 120,
      each printing ``K = 64``.

    Logs each checkpoint's write and read seconds and size, and ms/sweep
    of the saving fit beside ``fused_ms``, the fused-block fit's."""
    import json as json_mod
    import subprocess

    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    out = {}
    cache = dict(precompute_features=True, feature_dtype="float32")
    with tempfile.TemporaryDirectory() as tmp, SaveTimer(torch) as timer:
        saving = dict(enable_saving=True, model_save_interval=20,
                      save_path=f"{tmp}/", save_file_prefix="checkpoint_")
        t0 = time.perf_counter()
        res = dpmm.fit(x, device="cuda", verbose=False, **cache, **flag,
                       **saving)
        secs = time.perf_counter() - t0
        saving_ms = float(np.median(res.history.times[-40:])) * 1e3
        assert res.k == K_TRUE_FLAG, res.k
        log(f"persistence: saving fit K={res.k} NMI="
            f"{dpmm.nmi(gt, res.labels):.6f} in {secs:.1f} s, median "
            f"{saving_ms:.2f} ms/sweep over the last 40 sweeps (one sweep at "
            f"a time, saving every 20) against {fused_ms:.2f} fused ({smi})")
        ck60 = f"{tmp}/checkpoint_60.npz"
        labels = []
        for step in (60, 20, 20):
            sk.reset_launches()
            t0 = time.perf_counter()
            r = dpmm.run_from_checkpoint(f"{tmp}/checkpoint_{step}.npz", x,
                                         iters=120, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {fn.__name__: dict(fn.launches) for fn in
                      (sk.fused_assign, sk.stats_from_labels)}
            assert counts["fused_assign"]["precomputed"] > 0, counts
            if step == 20:
                assert counts["stats_from_labels"]["precomputed"] > 0, counts
                labels.append(r.model.labels_raw)
            else:
                r60 = r
            nmi = dpmm.nmi(gt, r.labels)
            assert r.k == K_TRUE_FLAG and nmi >= 0.999, (r.k, nmi)
            assert len(r.history.k) == 120 - step and r.model.step == 120
            log(f"persistence: resume of sweep {step} to 120: K={r.k} "
                f"NMI={nmi:.6f} in {secs:.1f} s, median "
                f"{np.median(r.history.times[-40:]) * 1e3:.2f} ms/sweep, "
                f"launches during the resume {counts} ({smi})")
        assert np.array_equal(labels[0], labels[1]), "resumes differ"
        r = r60
        t0 = time.perf_counter()
        pred, _ = r.model.predict(x, return_probs=False)
        pred_s = time.perf_counter() - t0
        assert np.array_equal(pred, r.labels), "predict != labels"
        params = r.model.cluster_params()
        assert len(params) == K_TRUE_FLAG, len(params)
        t0 = time.perf_counter()
        avg_ll, avg_prob = r.model.cluster_statistics(x, r.labels)
        stats_s = time.perf_counter() - t0
        assert np.isfinite(avg_ll).all() and np.isfinite(avg_prob).all()
        assert avg_prob.mean() >= 0.99, avg_prob.mean()
        log(f"persistence: predict == labels on {len(x)} points "
            f"({pred_s:.2f} s), {len(params)} cluster parameters, "
            f"cluster_statistics in {stats_s:.2f} s (mean responsibility "
            f"{avg_prob.mean():.6f}), the two resumes' labels equal ({smi})")
        del r, r60, res

        # continuation without smart splits: the file carries the chain
        cont = dict(flag, iters=40, smart_splits=False)
        saving20 = dict(saving, save_file_prefix="cont_")
        whole = dpmm.fit(x, device="cuda", verbose=False, **cache, **cont,
                         **saving20)
        part = dpmm.run_from_checkpoint(f"{tmp}/cont_20.npz", x, iters=40,
                                        device="cuda")
        assert np.array_equal(part.model.labels_raw, whole.model.labels_raw)
        assert np.array_equal(part.model.sublabels, whole.model.sublabels)
        assert part.history.k == whole.history.k[20:]
        log(f"persistence: smart_splits=False, 40 sweeps saving at 20, and "
            f"the resume of sweep 20 to 40 equal bit for bit (K="
            f"{whole.k}) ({smi})")
        del whole, part
        out["files"] = timer.report(smi)
        log(f"persistence: checkpoints: {out['files']}")

        # the CLI, a subprocess on the card (its default device)
        np.save(f"{tmp}/x.npy", x)
        np.save(f"{tmp}/gt.npy", gt)
        with open(f"{tmp}/params.json", "w") as f:
            json_mod.dump(dict(flag, data_path=f"{tmp}/x.npy",
                               gt_path=f"{tmp}/gt.npy", verbose=False,
                               **cache), f)
        root = pathlib.Path(__file__).resolve().parent
        for args in ([], ["--resume", ck60, "--iters", "120"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "dpmmsubclusters_tpu_torch.run",
                 *args, f"{tmp}/params.json"],
                cwd=root, capture_output=True, text=True, timeout=600)
            lines = proc.stdout.strip().splitlines()
            log(f"persistence: CLI {' '.join(args) or 'fit'}: rc "
                f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: "
                f"{' | '.join(lines[-3:])} ({smi})")
            if proc.returncode != 0 or f"K = {K_TRUE_FLAG}" not in lines:
                log(proc.stderr[-4000:])
                raise AssertionError(f"CLI {args}: rc {proc.returncode}")
    free(torch)
    out.update(saving_ms=saving_ms, fused_ms=fused_ms)
    return out


def run_huge(torch, smi: str, statistics: bool = True):
    """The 10M x 64-d fit (benchmarks/suite.py:128-186, huge_conv, through
    fit), full size, nothing cut: first with the rows built in the kernels
    (the cache resolves off: its f32 layout would be 86 GB), then with the
    hybrid cache (42.9 GB of bf16 rows beside the 2.56 GB of points); each
    must reach K=100 at NMI >= 0.999, and each is profiled over 8 steady
    sweeps; with ``statistics`` also ``cluster_statistics`` over the points.
    Returns each fit's launches and its ms/sweep with its profile, by
    variant."""
    hybrid = {"fused_assign": "hybrid", "stats_from_labels": "gaussian"}
    x, gt = separated_data(10_000_000, 64, 100)
    huge = dict(k_max=256, chunk_size=16384, burnout=5, alpha=10.0,
                track_posterior=False, merge_candidates=1024, seed=1,
                iters=160)
    launches, timed = {}, {}
    r = run_fit(torch, "10M x 64-d (no cache)", x, gt, "gaussian", **huge)
    assert r["res"].model.cfg.precompute_features is False
    assert r["res"].k == 100 and r["nmi"] >= 0.999, (r["res"].k, r["nmi"])
    launches["gaussian"] = r["launches"]
    timed["gaussian"] = dict(ms=r["ms"], **profile_sweeps(
        torch, r["res"], x, "10M x 64-d (no cache)", smi))
    if statistics:
        huge_statistics(torch, r["res"], x, smi)
    del r
    free(torch)
    r = run_fit(torch, "10M x 64-d (hybrid cache)", x, gt, hybrid,
                precompute_features=True, feature_dtype="hybrid", **huge)
    assert r["res"].k == 100 and r["nmi"] >= 0.999, (r["res"].k, r["nmi"])
    launches["hybrid"] = r["launches"]
    log(f"10M x 64-d hybrid: {r['ms']:.2f} ms/sweep, cache built in "
        f"{r['featurize_s']:.3f} s ({smi})")
    free(torch)
    timed["hybrid"] = dict(ms=r["ms"], **profile_sweeps(
        torch, r["res"], x, "10M x 64-d (hybrid cache)", smi))
    del x, gt, r
    free(torch)
    return launches, timed


def huge_main() -> int:
    """``--huge``: the two 10M x 64-d fits alone (:func:`run_huge`), one
    JSON line of their ms/sweep and device ms/sweep by part, with whichever
    dpmmsubclusters_tpu_torch this directory holds (the A/B of two trees:
    copy this file into each)."""
    import torch

    from dpmmsubclusters_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = profiling.card("cuda")
    print(json.dumps(dict(huge=run_huge(torch, smi, statistics=False)[1],
                          card=smi)), flush=True)
    return 0


def huge_statistics(torch, res, x, smi: str) -> None:
    """``cluster_statistics`` over all of a 10M-point fit's points, with
    its seconds and the peak device memory during the call."""
    free(torch)
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    avg_ll, avg_prob = res.model.cluster_statistics(x, res.labels)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert np.isfinite(avg_ll).all() and np.isfinite(avg_prob).all()
    assert len(avg_ll) == res.k
    log(f"cluster_statistics over {len(x)} x {x.shape[1]} points, K={res.k}:"
        f" {secs:.2f} s, peak device memory {peak:.2f} GB ({base:.2f} GB "
        f"resident before), mean responsibility {avg_prob.mean():.6f} "
        f"({smi})")


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(argvs, timeout: float) -> list:
    """Run ``python3 <argv>`` once per argument list, side by side, from
    the repo's root; returns ``(rc, stdout, stderr)`` of each.  Every
    process is killed if any outlives ``timeout`` seconds, and on any
    error."""
    import subprocess

    root = pathlib.Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, *argv], cwd=root, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def dist_rank_main(spec_path: str, rank: int) -> int:
    """One gloo rank of the distributed phase on the card (``python3
    chip_smoke.py --dist-rank SPEC RANK``): ``fit_distributed`` of its
    contiguous rows of the spec's ``.npy`` points, with kernel A's and B's
    launches counted from 0 and every sum over ranks of a card's tensor
    timed by the host clock between two synchronizations; writes its
    labels and a JSON of its K, NMI, ``history.k``, ms/sweep, launches,
    the sums' count, seconds and bytes, and every rank's table digest."""
    import torch
    import torch.distributed as tdist

    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.parallel import distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    counts = spec["counts"]
    dist.initialize(spec["init"], len(counts), rank, "gloo")
    try:
        lo, hi = sum(counts[:rank]), sum(counts[:rank + 1])
        x = np.ascontiguousarray(np.load(spec["x"], mmap_mode="r")[lo:hi])
        sums = []
        reduce = dist.all_reduce_sum

        def timed(t):
            if not t.is_cuda:               # the host moments at set-up
                return reduce(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = reduce(t)
            torch.cuda.synchronize()
            sums.append((time.perf_counter() - t0,
                         t.numel() * t.element_size()))
            return out

        dist.all_reduce_sum = timed
        sk.reset_launches()
        t0 = time.perf_counter()
        res = dpmm.fit_distributed(x, device="cuda", **spec["kwargs"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: sum(fn.launches.values())
                    for fn in (sk.fused_assign, sk.stats_from_labels)}
        digests = [None] * len(counts)
        tdist.all_gather_object(digests, dist.table_digest(res.model.table))
        out = dict(rank=rank, rows=len(x), k=res.k, hist_k=res.history.k,
                   secs=secs, launches=launches, digests=digests,
                   ms_sweep=float(np.median(res.history.times[-40:])) * 1e3,
                   sweeps=len(res.history.k), sums=len(sums),
                   sum_s=sum(t for t, _ in sums),
                   sum_bytes=sum(b for _, b in sums))
        if spec.get("gt"):
            gt = np.load(spec["gt"], mmap_mode="r")[lo:hi]
            out["nmi"] = dpmm.nmi(gt, res.labels)
        np.save(f"{spec['out']}.rank{rank}.npy", res.model.labels_raw)
        with open(f"{spec['out']}.rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.shutdown()
    return 0


def run_ranks(tmp: str, name: str, x, counts, kwargs: dict, gt=None,
              timeout: float = 600) -> list:
    """``fit_distributed`` of ``x`` split by ``counts`` over gloo ranks in
    subprocesses sharing the card (:func:`dist_rank_main`); fails unless
    every rank exits 0.  Returns each rank's JSON, with its labels under
    ``labels_raw``."""
    np.save(f"{tmp}/{name}_x.npy", x)
    spec = dict(init=f"tcp://localhost:{free_port()}", x=f"{tmp}/{name}_x.npy",
                counts=[int(c) for c in counts], out=f"{tmp}/{name}",
                kwargs=kwargs)
    if gt is not None:
        np.save(f"{tmp}/{name}_gt.npy", gt)
        spec["gt"] = f"{tmp}/{name}_gt.npy"
    with open(f"{tmp}/{name}_spec.json", "w") as f:
        json.dump(spec, f)
    procs = spawn_ranks([[__file__, "--dist-rank", f"{tmp}/{name}_spec.json",
                          str(i)] for i in range(len(counts))], timeout)
    outs = []
    for i, (rc, out, err) in enumerate(procs):
        if rc != 0:
            log(f"rank {i} of {name}: rc {rc}\n{out[-2000:]}\n{err[-4000:]}")
            raise AssertionError(f"{name}: rank {i} exited {rc}")
        with open(f"{tmp}/{name}.rank{i}.json") as f:
            outs.append(json.load(f))
        outs[-1]["labels_raw"] = np.load(f"{tmp}/{name}.rank{i}.npy")
    return outs


def run_distributed(torch, ref: dict, smi: str) -> dict:
    """The distributed phase (``fit_distributed``, :mod:`dpmmsubclusters_
    tpu_torch.parallel.distributed`) on the one card:

    (a) one rank under NCCL in this process (a world of one) at the
        flagship's data, config and seed: labels, sub-labels, table and
        ``history.k`` equal to ``ref``, the flagship's ``fit`` (f32 cache)
        of this run, bit for bit; kernels A and B launched; one NCCL
        all_reduce of the flagship's [K_MAX, 2, F] sums timed;
    (b) two gloo ranks in subprocesses on the flagship (rank 0 a whole
        number of 512-row tiles, the shards unequal): K=64 and NMI >=
        0.999 on each rank's rows, equal table digests, kernels A and B
        launched on each rank; per-rank ms/sweep and the sums over ranks'
        ms and bytes a sweep;
    (c) the integer 4 corners at 2^20 points, under ``"default"`` and
        ``"highest"``: one process's ``fit`` and two ranks give the same
        labels and ``history.k``;
    (d) the CLI, ``--distributed --backend gloo``, on the 4 corners of the
        golden gate: a saving fit to sweep 40 on two ranks, ``--resume``
        to 80 on two ranks, then a re-shard ``--resume`` to 120 on one,
        each printing ``K = 4`` on every rank."""
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.parallel import distributed as dist

    t_phase = time.perf_counter()
    out = {}
    x, gt = separated_data(N_FLAG, D_FLAG, K_TRUE_FLAG)
    kw = dict(ref["kwargs"], precompute_features=True,
              feature_dtype="float32")
    want = ref["res"]

    # (a) a world of one under NCCL
    dist.initialize(f"tcp://localhost:{free_port()}", 1, 0, "nccl")
    try:
        sk.reset_launches()
        t0 = time.perf_counter()
        res = dpmm.fit_distributed(x, device="cuda", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {fn.__name__: dict(fn.launches)
                    for fn in (sk.fused_assign, sk.stats_from_labels)}
        assert launches["fused_assign"]["precomputed"] > 0, launches
        assert launches["stats_from_labels"]["precomputed"] > 0, launches
        assert np.array_equal(res.model.labels_raw, want.model.labels_raw)
        assert np.array_equal(res.model.sublabels, want.model.sublabels)
        assert dist.table_digest(res.model.table) == dist.table_digest(
            want.model.table), "world of one: tables differ from fit's"
        assert res.history.k == want.history.k
        f = 1 + D_FLAG + D_FLAG * (D_FLAG + 1) // 2
        sums = torch.ones((K_MAX_FLAG, 2, f), device="cuda")
        nccl_ms = time_ms(torch, lambda: torch.distributed.all_reduce(sums),
                          reps=50)
    finally:
        dist.shutdown()
    ms_a = float(np.median(res.history.times[-40:])) * 1e3
    out["a"] = dict(ms=ms_a, fit_ms=ref["ms"], nccl_ms=nccl_ms,
                    bytes=sums.numel() * 4)
    log(f"distributed (a) one NCCL rank, flagship: K={res.k} NMI="
        f"{dpmm.nmi(gt, res.labels):.6f} in {secs:.1f} s, {ms_a:.2f} "
        f"ms/sweep against fit's {ref['ms']:.2f}; labels, sub-labels, "
        f"table and history.k equal to fit's bit for bit; launches "
        f"{launches}; one NCCL all_reduce of the [{K_MAX_FLAG}, 2, {f}] "
        f"f32 sums ({sums.numel() * 4} bytes) {nccl_ms:.4f} ms ({smi})")
    del res, sums

    with tempfile.TemporaryDirectory() as tmp:
        # (b) two gloo ranks on the flagship, unequal, rank 0 whole tiles
        counts = (HASH_TILE * 900, N_FLAG - HASH_TILE * 900)
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, "flagship", x, counts, kw, gt=gt)
        secs = time.perf_counter() - t0
        for r in ranks:
            assert r["k"] == K_TRUE_FLAG and r["nmi"] >= 0.999, r
            assert len(set(r["digests"])) == 1, r["digests"]
            assert min(r["launches"].values()) > 0, r["launches"]
            log(f"distributed (b) gloo rank {r['rank']} of 2 on the card, "
                f"{r['rows']} rows: K={r['k']} NMI={r['nmi']:.6f} in "
                f"{r['secs']:.1f} s, {r['ms_sweep']:.2f} ms/sweep; "
                f"launches {r['launches']}; {r['sums']} sums over ranks, "
                f"{r['sum_s'] / r['sweeps'] * 1e3:.3f} ms and "
                f"{r['sum_bytes'] / r['sweeps'] / 1e3:.1f} KB a sweep "
                f"(staged through host memory) ({smi})")
        out["b"] = [{k: r[k] for k in ("rows", "ms_sweep", "sums", "sum_s",
                                        "sum_bytes", "sweeps")}
                    for r in ranks]
        log(f"distributed (b): table digests equal on both ranks; "
            f"{secs:.1f} s with the processes' start ({smi})")
        del x, gt

        # (c) rank-count invariance: integer 4 corners at 2^20 points
        n = 1 << 20
        xc = np.zeros((n, 2), np.float32)
        for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
            xc[i * (n // 4):(i + 1) * (n // 4)] = c
        corners = dict(alpha=100.0, iters=100, seed=SEED, burnout=5,
                       verbose=False)
        counts = (HASH_TILE * 700, n - HASH_TILE * 700)
        # both precisions must reach K=4: under "default" float32 rows take
        # the three-pass split (ROADMAP Queue 3, P8: one bf16 pass left this
        # chain at K=1)
        for prec in ("default", "highest"):
            kw_c = dict(corners, ll_precision=prec)
            one = dpmm.fit(xc, device="cuda", **kw_c)
            assert one.k == 4, ("(c) K", prec, one.history.k[::10])
            ranks = run_ranks(tmp, f"corners_{prec}", xc, counts, kw_c)
            labels = np.concatenate([r["labels_raw"] for r in ranks])
            assert np.array_equal(labels, one.model.labels_raw), (
                "(c) labels", prec)
            for r in ranks:
                assert r["hist_k"] == one.history.k, ("(c) history.k", prec)
            log(f"distributed (c) 4 corners at 2^20 points, ll_precision="
                f"{prec}: one process's fit (K={one.k}, history.k "
                f"{one.history.k[::10]} every 10 sweeps) and two gloo ranks "
                f"({counts[0]} + {counts[1]} rows) give the same labels "
                f"and history.k ({smi})")
        del one, xc

        # (d) the CLI on the golden gate's 4 corners
        xg = np.zeros((1000, 2), np.float32)
        for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
            xg[i * 250:(i + 1) * 250] = c
        np.save(f"{tmp}/golden.npy", xg)
        with open(f"{tmp}/params.json", "w") as f:
            json.dump(dict(corners, data_path=f"{tmp}/golden.npy", iters=40,
                           enable_saving=True, model_save_interval=40,
                           save_path=f"{tmp}/", save_file_prefix="cli_"), f)
        for ranks, extra in ((2, []),
                             (2, ["--resume", f"{tmp}/cli_40.npz",
                                  "--iters", "80"]),
                             (1, ["--resume", f"{tmp}/cli_80.npz",
                                  "--iters", "120"])):
            port = free_port()
            t0 = time.perf_counter()
            procs = spawn_ranks([
                ["-m", "dpmmsubclusters_tpu_torch.run", "--distributed",
                 "--coordinator", f"localhost:{port}", "--num-processes",
                 str(ranks), "--process-id", str(i), "--backend", "gloo",
                 *extra, f"{tmp}/params.json"] for i in range(ranks)], 300)
            what = " ".join(extra) or "fit"
            for i, (rc, so, se) in enumerate(procs):
                lines = so.strip().splitlines()
                if rc != 0 or "K = 4" not in lines:
                    log(f"CLI {what} rank {i}: rc {rc}\n{so[-2000:]}\n"
                        f"{se[-4000:]}")
                    raise AssertionError(f"(d) CLI {what}: rank {i}")
            log(f"distributed (d) CLI --distributed --backend gloo, {ranks} "
                f"rank(s), {what}: K = 4 on every rank in "
                f"{time.perf_counter() - t0:.1f} s ({smi})")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"distributed phase done in {out['seconds']:.1f} s ({smi})")
    free(torch)
    return out


# the gpu-marked tests of tests/test_torch_card_*.py (kernels A-E on the card)
CARD_TESTS = 303


def run_card_tests(smi: str) -> int:
    """The card-only tests in a subprocess, with no conftest (they import
    torch, numpy, pytest and the port only).  Fails unless every one of the
    CARD_TESTS runs and passes; returns the count."""
    import subprocess

    root = pathlib.Path(__file__).resolve().parent
    files = sorted(str(p.relative_to(root))
                   for p in root.glob("tests/test_torch_card_*.py"))
    assert files, "no tests/test_torch_card_*.py"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "gpu", *files],
        cwd=root, capture_output=True, text=True, timeout=600)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    summary = lines[-1] if lines else ""
    found = re.search(r"(\d+) passed", summary)
    passed = int(found.group(1)) if found else 0
    log(f"card tests ({len(files)} files): {summary} in "
        f"{time.perf_counter() - t0:.1f} s, rc {proc.returncode} ({smi})")
    if (proc.returncode != 0 or passed != CARD_TESTS
            or any(w in summary for w in ("failed", "error", "skipped"))):
        log("\n".join(lines[-60:]))
        raise AssertionError(f"card tests: {passed} of {CARD_TESTS} passed "
                             f"(rc {proc.returncode})")
    return passed


def free(torch) -> None:
    """Return the card's cached blocks after a large fit."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import _build
    from dpmmsubclusters_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = profiling.card(dev)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    kernels = check_kernels(torch, dev, smi)
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    digests = b_digests(torch, sk, dev)
    assert digests == B_DIGESTS, ("kernel B's output differs from the "
                                  "earlier kernel's", digests)
    log(f"kernel B's digests equal the earlier kernel's: {digests}")
    digests = a_digests(torch, sk, dev)
    assert digests == A_DIGESTS, ("kernel A's exact route differs from the "
                                  "earlier kernel's", digests)
    log(f"kernel A's exact digests equal the earlier kernel's: {digests}")
    digests = tc_digests(torch, sk, dev)
    assert digests == TC_DIGESTS, ("kernel A at width 256 differs from the "
                                   "kernels that ran every pass", digests)
    log(f"kernel A's width-256 digests equal those of every pass: {digests}")
    digests = narrow_digests(torch, sk, dev)
    assert digests == NARROW_DIGESTS, ("kernel A's narrow passes differ from "
                                       "the 64-point blocks'", digests)
    log(f"kernel A's narrow digests equal the 64-point blocks': {digests}")
    kernels["build_gate"] = build_gate(torch, _build, smi)
    kernels.update(check_study_kernels(torch, dev, smi))
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")
    run_card_tests(smi)
    log(f"card tests done at {time.perf_counter() - t_start:.1f} s")
    studies = run_studies(torch)
    log(f"studies done at {time.perf_counter() - t_start:.1f} s")
    launches = {}      # the main path of each variant: launch counts
    exact = {}         # the same under ll_precision="highest"
    split = {}         # ... and under "high" (the three-pass split)

    # 4-corner golden gate (tests/test_fit_e2e.py::TestFourCorners), with
    # the f32 cache and with the bf16 one
    x = np.zeros((1000, 2), np.float32)
    gt = np.zeros(1000, np.int64)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 250:(i + 1) * 250] = c
        gt[i * 250:(i + 1) * 250] = i
    corners = dict(alpha=100.0, iters=100, seed=12345, burnout=5)
    for layout, variant, prec in (("float32", "precomputed", "default"),
                                  ("float32", "precomputed", "high"),
                                  ("bfloat16", "bfloat16", "default"),
                                  ("bfloat16", "bfloat16", "highest")):
        r = run_fit(torch, f"4 corners ({layout} cache)", x, gt, variant,
                    feature_dtype=layout, ll_precision=prec, **corners)
        pred, _ = r["res"].predict(x)
        assert r["res"].k == 4 and r["nmi"] == 1.0, (r["res"].k, r["nmi"])
        assert np.array_equal(pred, r["res"].labels), "predict != labels"
        if prec == "highest":
            exact["bfloat16"] = r["launches"]
        elif prec == "high":
            split["precomputed"] = r["launches"]

    # 200k x 32-d recovery (benchmarks/stats_precision_ab.py quality data),
    # with the f32 cache and with the hybrid one
    rng = np.random.default_rng(0)
    means = rng.standard_normal((20, 32)).astype(np.float32) * 8.0
    gt = rng.integers(0, 20, size=200_000)
    x = means[gt] + rng.standard_normal((200_000, 32)).astype(np.float32)
    hybrid = {"fused_assign": "hybrid", "stats_from_labels": "gaussian"}
    for layout, variant, cached, prec in (
            ("float32", "precomputed", True, "default"),
            ("hybrid", hybrid, True, "default"),
            ("hybrid", hybrid, True, "highest"),
            ("float32", "gaussian", False, "highest"),
            ("float32", "gaussian", False, "high")):
        what = f"{layout} cache" if cached else "no cache"
        r = run_fit(torch, f"200k x 32-d ({what})", x, gt, variant,
                    alpha=10.0, iters=200, seed=1, k_max=64,
                    precompute_features=cached, feature_dtype=layout,
                    ll_precision=prec)
        assert r["res"].k == 20 and r["nmi"] == 1.0, (r["res"].k, r["nmi"])
        if prec == "highest":
            exact[variant if isinstance(variant, str)
                  else "hybrid"] = r["launches"]
        elif prec == "high":
            split["gaussian"] = r["launches"]

    # 1M x 32-d flagship: bench.py's data and config, through fit, with the
    # f32 feature cache (at the default precision and, side by side, under
    # "highest"), with the rows built in the kernels and with the two bf16
    # caches
    x, gt = separated_data(N_FLAG, D_FLAG, K_TRUE_FLAG)
    flag = dict(alpha=10.0, iters=120, seed=0, k_max=K_MAX_FLAG,
                chunk_size=16384, burnout=5, track_posterior=False,
                merge_candidates=K_MAX_FLAG)
    ms = {}
    for layout, variant, cached, prec in (
            ("float32", "precomputed", True, "default"),
            ("float32", "precomputed", True, "highest"),
            ("float32", "gaussian", False, "default"),
            ("hybrid", hybrid, True, "default"),
            ("bfloat16", "bfloat16", True, "default")):
        what = f"{layout} cache" if cached else "no cache"
        if prec == "highest":
            what += ", highest"
        r = run_fit(torch, f"flagship 1M x 32-d ({what})", x, gt, variant,
                    precompute_features=cached, feature_dtype=layout,
                    ll_precision=prec, **flag)
        ms[what] = r["ms"]
        if prec == "highest":
            exact["precomputed"] = r["launches"]
        if variant == "precomputed":
            profile_sweeps(torch, r["res"], x, f"flagship 1M x 32-d ({what})",
                           smi)
        if layout == "bfloat16":
            # reported, not gated: the JAX package documents that this
            # layout's bf16 statistics make the chain under-split
            # (config.feature_dtype)
            launches["bfloat16"] = r["launches"]
            continue
        if variant == "precomputed" and prec == "default":
            launches["precomputed"] = r["launches"]
            flag_ref = dict(r, kwargs=flag)      # for the distributed phase
        assert r["res"].k == K_TRUE_FLAG and r["nmi"] >= 0.999, (
            what, r["res"].k, r["nmi"])
    log("flagship ms/sweep: " + ", ".join(
        f"{w} {v:.2f} ({N_FLAG / v * 1e3:.4g} point-sweeps/s)"
        for w, v in ms.items()) + f" ({smi})")
    del r
    free(torch)
    t0 = time.perf_counter()
    run_persistence(torch, x, gt, flag, ms["float32 cache"], smi)
    log(f"persistence phase done in {time.perf_counter() - t0:.1f} s")

    # multinomial (benchmarks/suite.py:69-76, and its 1M-document shape)
    mnm = dict(family="multinomial", alpha=1.0, seed=1, burnout=10)
    x, gt, _ = dpmm.generate_mnmm_data(50_000, 100, 10, 120, seed=0)
    for prec in ("default", "highest"):
        r = run_fit(torch, "multinomial 50k x 100-d", x, gt, "multinomial",
                    iters=100, k_max=32, ll_precision=prec, **mnm)
        assert r["res"].k == 10 and r["nmi"] >= 0.999, (r["res"].k, r["nmi"])
    exact["multinomial"] = r["launches"]
    x, gt, _ = dpmm.generate_mnmm_data(1_000_000, 100, 20, 120, seed=0)
    r = run_fit(torch, "multinomial 1M x 100-d", x, gt, "multinomial",
                iters=150, k_max=64, **mnm)
    launches["multinomial"] = r["launches"]
    assert r["res"].k == 20 and r["nmi"] >= 0.999, (r["res"].k, r["nmi"])
    del x, gt, r
    free(torch)

    launches.update(run_huge(torch, smi)[0])
    run_distributed(torch, flag_ref, smi)
    del flag_ref

    report = build_report(sk, kernels, launches, exact, split, studies)
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def build_report(sk, kernels: dict, launches: dict, exact: dict,
                 split: dict, studies: dict) -> dict:
    """The line before the last: every kernel's row, with its launches on
    its own path (``launches``: the fits at the default precision, by
    variant, :func:`run_fit`'s counts; ``exact`` under "highest", ``split``
    under "high"; ``studies``: :func:`run_studies`'s) and its check's
    numbers (``kernels``).  Raises if a kernel of a path did not run."""
    report = {"kernels": []}
    for name, variants in (("fused_assign", ("precomputed", "gaussian",
                                             "multinomial", "bfloat16",
                                             "hybrid")),
                           ("stats_from_labels", ("precomputed", "gaussian",
                                                  "multinomial",
                                                  "bfloat16"))):
        for variant in variants:
            n_launch = launches[variant][name][variant]
            assert n_launch > 0, (name, variant, "not launched on its path")
            what = f"{variant} variant"
            source = SOURCES[name]
            if name == "fused_assign":
                # the fits' kernel A: the tensor-core assign pass
                assert launches[variant]["tensor_core"][variant] == n_launch
                if sk.ll_route(variant, "default") == "bf16":
                    # over a bf16 cache: K > 64 in fused_assign_tc_tma.cuh,
                    # the early tiers (K <= 64) in fused_assign_tc.cuh
                    n_tma = launches[variant]["tma"][variant]
                    assert n_tma > 0, (variant, "the new kernel did not run",
                                       launches[variant])
                    if n_launch > n_tma:
                        report["kernels"].append({
                            "name": f"{name}[{variant}] K<=64",
                            "route": "cuda",
                            "source": SOURCES["fused_assign_tc"],
                            "replaces": f"{REPLACES[name]} ({what}, "
                                        f"ll_precision default: one bf16 "
                                        f"pass, pass width <= 128)",
                            "launches": n_launch - n_tma,
                            **kernels[f"{name}[{variant}] K=64"]})
                    what += (", ll_precision default: one bf16 pass, pass "
                             "width 256")
                    source = SOURCES["fused_assign_tc_tma"]
                    n_launch = n_tma
                else:
                    # the fits' widest tiers take the ring
                    assert (variant == "multinomial"
                            or launches[variant]["ring"][variant] > 0), (
                        variant, "the ring did not run", launches[variant])
                    split_rows(report, kernels, variant, launches[variant],
                               f"{what}, ll_precision default: the "
                               f"three-pass bf16 split", "")
                    n_launch = 0
            if n_launch:
                report["kernels"].append({
                    "name": f"{name}[{variant}]", "route": "cuda",
                    "source": source,
                    "replaces": f"{REPLACES[name]} ({what})",
                    "launches": n_launch,
                    **kernels[f"{name}[{variant}]"]})
            if name != "fused_assign":
                continue
            # ... and the exact float32 kernel A, on its "highest" fit
            n_launch = exact[variant][name][variant]
            assert n_launch > 0 and not exact[variant]["tensor_core"][
                variant], (name, variant, "highest", exact[variant])
            report["kernels"].append({
                "name": f"{name}[{variant}] highest", "route": "cuda",
                "source": SOURCES[name],
                "replaces": f"{REPLACES[name]} ({variant} variant, "
                            f"ll_precision highest: exact float32)",
                "launches": n_launch,
                **kernels[f"{name}[{variant}] highest"]})
            if variant not in split:
                continue
            # ... and the three-pass split, on its "high" fit
            assert split[variant]["tensor_core"][variant] > 0, (
                name, variant, "high", split[variant])
            split_rows(report, kernels, variant, split[variant],
                       f"{variant} variant, ll_precision high: three bf16 "
                       f"passes", " high")
    # kernel E's path is the build gate itself
    report["kernels"].append({
        "name": "build_gate[lane_iota]", "route": "cuda",
        "source": SOURCES["build_gate"], "replaces": REPLACES["build_gate"],
        **kernels["build_gate"]})
    # kernels C and D, and kernel A's study blocks: launches on their
    # study's path
    tile = studies["tile_study"]
    study_rows = [("column_sum[dma_only]", "column_sum",
                   "dma_only mode", tile["column_sum"])]
    for cta in sk.CTA_POINTS:
        variant = "precomputed" + ("" if cta == sk.FIT_CTA_POINTS
                                   else f" cta={cta}")
        study_rows.append((f"tile_study_full[cta={cta}]", "tile_study_full",
                           f"full modes; kernel A precomputed, {cta} "
                           f"points a block", tile["fused_assign"][variant]))
    for key, n_launch in studies["ablate"].items():
        study_rows.append((f"kernel_ablate[{key}]", "kernel_ablate",
                           f"stage set {key}", n_launch))
    for name, kernel, what, n_launch in study_rows:
        assert n_launch > 0, (name, "not launched on its study's path")
        report["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[kernel],
            "replaces": f"{REPLACES[kernel]} ({what})", "launches": n_launch,
            **kernels[name]})
    return report


# kernel A's three-pass split at a pass width <= 128 (K <= 64) is
# fused_assign_tc.cuh's kernel: the check that times it, by variant
NARROW_SPLIT = {"precomputed": "fused_assign[precomputed] K=64",
                "gaussian": "fused_assign[gaussian] K=64",
                "multinomial": "fused_assign[multinomial]"}


def split_rows(report: dict, kernels: dict, variant: str, counts: dict,
               what: str, suffix: str) -> None:
    """The report's rows of kernel A's three-pass split on one fit
    (``counts``, :func:`run_fit`'s): the ring's launches (K > 64,
    fused_assign_tc_ring.cuh) and the rest (K <= 64, fused_assign_tc.cuh's
    kernel, built by fused_assign_tc3.cu, or where F is two slices or
    fewer the resident kernel), each with the check of its own kernel."""
    name = f"fused_assign[{variant}]{suffix}"
    n_split = counts["tensor_core"][variant]
    n_ring = counts["ring"][variant]
    if n_ring:
        report["kernels"].append({
            "name": name, "route": "cuda",
            "source": SOURCES["fused_assign_tc_ring"],
            "replaces": f"{REPLACES['fused_assign']} ({what}, pass width "
                        f"256: K > 64)",
            "launches": n_ring, **kernels[name]})
    if n_split > n_ring:
        # where the rule gave them the resident kernel (F of two slices)
        resident = counts.get("resident", {}).get(variant, 0) > 0
        report["kernels"].append({
            "name": name + (" K<=64" if n_ring else ""), "route": "cuda",
            "source": SOURCES["fused_assign_tc_resident" if resident
                              else "fused_assign_tc3"],
            "replaces": f"{REPLACES['fused_assign']} ({what}, pass width "
                        f"<= 128: K <= 64)",
            "launches": n_split - n_ring, **kernels[NARROW_SPLIT[variant]]})


MODES = {"--kernel-a": kernel_a_main, "--tc-digests": tc_digests_main,
         "--narrow-digests": narrow_digests_main,
         "--kernel-b": kernel_b_main,
         "--chain-quality": chain_quality_main, "--huge": huge_main,
         "--studies": studies_main}

if __name__ == "__main__":
    argv = sys.argv[1:]
    if len(argv) == 3 and argv[0] == "--dist-rank":    # run_ranks' ranks
        sys.exit(dist_rank_main(argv[1], int(argv[2])))
    if len(argv) > 1 or (argv and argv[0] not in MODES):
        sys.exit(f"usage: python3 chip_smoke.py [{' | '.join(MODES)}]")
    sys.exit(MODES[argv[0]]() if argv else main())
