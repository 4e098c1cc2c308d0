"""Smoke test of the PyTorch/CUDA port (dpmmsubclusters_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels from csrc/, checks each kernel
and variant against its plain PyTorch version at the shapes the fits give it
(and the raw-point variants against the cache variant bit for bit), then
drives ``fit`` through every path of the port:

* Gaussian with the f32 feature cache: the 4-corner gate, the 200k x 32-d
  recovery gate and the 1M x 32-d flagship;
* Gaussian with the rows built in the kernels: the flagship without its
  cache, and the 10M x 64-d fit whose cache (86 GB) would not fit the card;
* multinomial: 50k x 100-d and 1M x 100-d.

    python3 chip_smoke.py

Any failed check raises (non-zero exit).  On success the line before the
last is a JSON object describing each kernel variant (launches in the fit
that drives it, error against the plain version, kernel and plain times),
preceded by the card's name and power limit from nvidia-smi; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
CUDA is unavailable.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_CHECK = 1_048_576
N_FLAG, D_FLAG, K_TRUE_FLAG, K_MAX_FLAG = 1_000_000, 32, 64, 128
HASH_TILE = 512
SEED = 12345
REPLACES = {
    "fused_assign": "dpmmsubclusters_tpu/ops/pallas_sweep.py:518",
    "stats_from_labels": "dpmmsubclusters_tpu/ops/pallas_sweep.py:439",
}
SOURCES = {
    "fused_assign": "dpmmsubclusters_tpu_torch/csrc/fused_assign.cu",
    "stats_from_labels": "dpmmsubclusters_tpu_torch/csrc/stats_from_labels.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def separated_data(n: int, d: int, k_true: int, seed: int = 0):
    """bench.py's flagship mixture (benchmarks/suite.py's too): separated
    means (x8), unit covariances."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k_true, d)).astype(np.float32) * 8.0
    labels = rng.integers(0, k_true, size=n)
    x = means[labels] + rng.standard_normal((n, d)).astype(np.float32)
    return x, labels


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
    (the raw points, or with ``cache`` the Gaussian feature cache), a
    [F, 2K] phi_mat drawn by the family at random posteriors, uniform
    log-weights and ``valid`` (the last 1000 rows invalid)."""

    def __init__(self, torch, dev, x_np, family: str, k: int,
                 cache: bool = False):
        from dpmmsubclusters_tpu_torch.priors import GAUSSIAN, MULTINOMIAL
        from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi

        self.family, self.k = family, k
        self.x = torch.as_tensor(x_np).to(dev)
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
        if cache:
            self.x, self.family = GAUSSIAN.features(self.x), "precomputed"

    def args(self):
        return (self.x, self.valid, self.phi_mat, self.log_w, SEED, 0)

    def kw(self):
        return dict(tile=HASH_TILE, family_name=self.family)


def check_assign(torch, sk, name: str, case: Case, smi: str) -> dict:
    """Kernel A against its plain version: hard labels identical except
    near ties, soft labels and sub-labels agreeing >= 0.999, statistics at
    rtol 1e-4 / atol 1e-3, two launches equal."""
    x, valid, k = case.x, case.valid, case.k

    def run(hard):
        return sk.fused_assign(*case.args(), hard, **case.kw())

    def plain(hard):
        return sk.fused_assign_reference(*case.args(), hard, **case.kw())

    lk, _, _ = run(True)
    lp, _, _ = plain(True)
    torch.cuda.synchronize()
    diff = torch.nonzero(lk != lp)[:, 0]
    if diff.numel():
        # a flip is only allowed where the plain logits tie to within the
        # float32 rounding of an F-term dot product in another order
        rows = sk.feature_rows(x[diff], case.family)
        ll = rows @ case.phi_mat[:, :k] + case.log_w
        top2 = torch.topk(ll, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).abs()
        bound = 1e-4 * top2[:, 0].abs().clamp(min=1.0)
        if bool((gap > bound).any()):
            raise AssertionError(f"{name} hard labels differ beyond ties: "
                                 f"{int((gap > bound).sum())} rows")
    n = x.shape[0]
    log(f"{name} hard: {n - diff.numel()}/{n} labels identical "
        f"({diff.numel()} near-tie flips)")
    lk, sk_, stk = run(False)
    lp, sp, _ = plain(False)
    agree_l = float((lk == lp).float().mean())
    agree_s = float((sk_ == sp).float().mean())
    log(f"{name} soft: labels agree {agree_l:.6f}, sub-labels {agree_s:.6f}")
    assert agree_l >= 0.999 and agree_s >= 0.999, (name, agree_l, agree_s)
    st_plain = sk.stats_from_labels_reference(x, lk, sk_, valid, k,
                                              case.family)
    err = close(torch, stk, st_plain, 1e-4, 1e-3)
    l2, s2, st2 = run(False)
    assert torch.equal(l2, lk) and torch.equal(s2, sk_) and torch.equal(
        st2, stk), f"{name} is not deterministic"
    ms = time_ms(torch, lambda: run(False))
    plain_ms = time_ms(torch, lambda: plain(False))
    f = case.phi_mat.shape[0]
    log(f"{name}: {ms:.3f} ms, plain {plain_ms:.3f} ms (N={n}, F={f}, "
        f"K={k}; {smi}); max abs err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_stats(torch, sk, name: str, case: Case, smi: str) -> dict:
    """Kernel B against its plain version on random labels: rtol 1e-4 /
    atol 1e-3, two launches equal."""
    x, valid, k = case.x, case.valid, case.k
    n = x.shape[0]
    labels = torch.randint(0, k, (n,), generator=case.gen, device=x.device,
                           dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), generator=case.gen, device=x.device,
                        dtype=torch.int32)

    def run():
        return sk.stats_from_labels(x, labels, sub, valid, k, case.family)

    def plain():
        return sk.stats_from_labels_reference(x, labels, sub, valid, k,
                                              case.family)

    stb = run()
    err = close(torch, stb, plain(), 1e-4, 1e-3)
    assert torch.equal(stb, run()), f"{name} is not deterministic"
    ms = time_ms(torch, run)
    plain_ms = time_ms(torch, plain)
    log(f"{name}: {ms:.3f} ms, plain {plain_ms:.3f} ms (N={n}, "
        f"F={stb.shape[1]}, K={k}; {smi}); max abs err {err:.3g}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def twin_gate(torch, sk, case: Case) -> None:
    """The "gaussian" variants on x against the "precomputed" ones on
    GaussianFamily.features(x): labels, sub-labels and statistics equal bit
    for bit (the rows are built as the cache's rounded products and feed
    the same FMA chains)."""
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN

    feat = GAUSSIAN.features(case.x)
    for hard in (True, False):
        built = sk.fused_assign(*case.args(), hard, **case.kw())
        cache = sk.fused_assign(feat, *case.args()[1:], hard, tile=HASH_TILE)
        for what, b, c in zip(("labels", "sub-labels", "stats"), built,
                              cache):
            assert torch.equal(b, c), f"kernel A twins differ: {what}"
    labels, sub = built[0], built[1]
    assert torch.equal(
        sk.stats_from_labels(case.x, labels, sub, case.valid, case.k,
                             "gaussian"),
        sk.stats_from_labels(feat, labels, sub, case.valid, case.k)), \
        "kernel B twins differ"
    log(f"twin gate: gaussian == precomputed bit for bit for A (hard, soft) "
        f"and B (N={case.x.shape[0]}, D={case.x.shape[1]}, K={case.k})")


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
    cache = Case(torch, dev, x, "gaussian", K_MAX_FLAG, cache=True)
    out["fused_assign[precomputed]"] = check_assign(
        torch, sk, "kernel A precomputed", cache, smi)
    out["stats_from_labels[precomputed]"] = check_stats(
        torch, sk, "kernel B precomputed", cache, smi)
    del cache
    for k in (192, 256):      # above one pass: any K (the K <= 128 repair)
        wide = Case(torch, dev, x, "gaussian", k, cache=True)
        out[f"fused_assign[precomputed] K={k}"] = check_assign(
            torch, sk, f"kernel A precomputed K={k}", wide, smi)
        del wide
    torch.cuda.empty_cache()

    # the 10M x 64-d fit's rows, built in the kernels: D=64, F=2145, K=256
    x, _ = separated_data(N_CHECK, 64, 100)
    x = (x - x.mean(0)) / x.std(0)
    case = Case(torch, dev, x, "gaussian", 256)
    out["fused_assign[gaussian]"] = check_assign(
        torch, sk, "kernel A gaussian", case, smi)
    out["stats_from_labels[gaussian]"] = check_stats(
        torch, sk, "kernel B gaussian", case, smi)
    del case
    torch.cuda.empty_cache()

    # the multinomial fits' counts: D=100, F=101, K=64
    x, _, _ = generate_mnmm_data(N_CHECK, 100, 20, 120, seed=1)
    case = Case(torch, dev, x, "multinomial", 64)
    out["fused_assign[multinomial]"] = check_assign(
        torch, sk, "kernel A multinomial", case, smi)
    out["stats_from_labels[multinomial]"] = check_stats(
        torch, sk, "kernel B multinomial", case, smi)
    del case
    torch.cuda.empty_cache()
    return out


def run_fit(torch, name: str, x, gt, variant: str, **kw):
    """One ``fit`` on the card, ground truth given (block-boundary NMI in
    the history), with every launch count set to 0 just before; asserts
    that both kernels ran in ``variant`` and in no other.  Returns (result,
    nmi, launch counts of the variant, ms/sweep)."""
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    sk.reset_launches()
    t0 = time.perf_counter()
    res = dpmm.fit(x, device="cuda", verbose=False, gt=gt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {fn.__name__: dict(fn.launches)
              for fn in (sk.fused_assign, sk.stats_from_labels)}
    for fn, by_variant in counts.items():
        ran = {v for v, c in by_variant.items() if c}
        assert ran == {variant}, (name, fn, by_variant)
    nmi = dpmm.nmi(gt, res.labels)
    ms_sweep = float(np.median(res.history.times[-40:])) * 1e3
    log(f"{name}: K={res.k} NMI={nmi:.6f} in {secs:.1f} s, median "
        f"{ms_sweep:.2f} ms/sweep over the last 40 sweeps, launches "
        f"{counts}")
    return res, nmi, {fn: c[variant] for fn, c in counts.items()}, ms_sweep


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    kernels = check_kernels(torch, dev, smi)
    launches = {}

    # 4-corner golden gate (tests/test_fit_e2e.py::TestFourCorners)
    x = np.zeros((1000, 2), np.float32)
    gt = np.zeros(1000, np.int64)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 250:(i + 1) * 250] = c
        gt[i * 250:(i + 1) * 250] = i
    res, nmi, _, _ = run_fit(torch, "4 corners", x, gt, "precomputed",
                             alpha=100.0, iters=100, seed=12345, burnout=5)
    pred, _ = res.predict(x)
    assert res.k == 4 and nmi == 1.0, (res.k, nmi)
    assert np.array_equal(pred, res.labels), "predict != labels"

    # 200k x 32-d recovery (benchmarks/stats_precision_ab.py quality data)
    rng = np.random.default_rng(0)
    means = rng.standard_normal((20, 32)).astype(np.float32) * 8.0
    gt = rng.integers(0, 20, size=200_000)
    x = means[gt] + rng.standard_normal((200_000, 32)).astype(np.float32)
    res, nmi, _, _ = run_fit(torch, "200k x 32-d", x, gt, "precomputed",
                             alpha=10.0, iters=200, seed=1, k_max=64)
    assert res.k == 20 and nmi == 1.0, (res.k, nmi)

    # 1M x 32-d flagship: bench.py's data and config, through fit, with the
    # f32 feature cache and then with the rows built in the kernels
    x, gt = separated_data(N_FLAG, D_FLAG, K_TRUE_FLAG)
    flag = dict(alpha=10.0, iters=120, seed=0, k_max=K_MAX_FLAG,
                chunk_size=16384, burnout=5, track_posterior=False,
                merge_candidates=K_MAX_FLAG)
    res, nmi, launches["precomputed"], ms_cache = run_fit(
        torch, "flagship 1M x 32-d", x, gt, "precomputed",
        precompute_features=True, **flag)
    assert res.k == K_TRUE_FLAG and nmi >= 0.999, (res.k, nmi)
    res, nmi, _, ms_built = run_fit(
        torch, "flagship 1M x 32-d without the cache", x, gt, "gaussian",
        precompute_features=False, **flag)
    assert res.k == K_TRUE_FLAG and nmi >= 0.999, (res.k, nmi)
    log(f"flagship: {ms_cache:.2f} ms/sweep with the cache, {ms_built:.2f} "
        f"without = {N_FLAG / ms_cache * 1e3:.4g} and "
        f"{N_FLAG / ms_built * 1e3:.4g} point-sweeps/s ({smi})")

    # multinomial (benchmarks/suite.py:69-76, and its 1M-document shape)
    mnm = dict(family="multinomial", alpha=1.0, seed=1, burnout=10)
    x, gt, _ = dpmm.generate_mnmm_data(50_000, 100, 10, 120, seed=0)
    res, nmi, _, _ = run_fit(torch, "multinomial 50k x 100-d", x, gt,
                             "multinomial", iters=100, k_max=32, **mnm)
    assert res.k == 10 and nmi >= 0.999, (res.k, nmi)
    x, gt, _ = dpmm.generate_mnmm_data(1_000_000, 100, 20, 120, seed=0)
    res, nmi, launches["multinomial"], _ = run_fit(
        torch, "multinomial 1M x 100-d", x, gt, "multinomial", iters=150,
        k_max=64, **mnm)
    assert res.k == 20 and nmi >= 0.999, (res.k, nmi)
    del x, gt, res

    # 10M x 64-d (benchmarks/suite.py:128-186, huge_conv, through fit): its
    # cache would be 10M x 2145 x 4 B = 86 GB, so the rows are built in the
    # kernels; full size, nothing cut
    x, gt = separated_data(10_000_000, 64, 100)
    res, nmi, launches["gaussian"], _ = run_fit(
        torch, "10M x 64-d", x, gt, "gaussian", k_max=256, chunk_size=16384,
        burnout=5, alpha=10.0, track_posterior=False, merge_candidates=1024,
        seed=1, iters=160)
    assert res.model.cfg.precompute_features is False
    assert res.k == 100 and nmi >= 0.999, (res.k, nmi)
    del x, gt, res

    report = {"kernels": []}
    for name in ("fused_assign", "stats_from_labels"):
        for variant in ("precomputed", "gaussian", "multinomial"):
            report["kernels"].append({
                "name": f"{name}[{variant}]", "route": "cuda",
                "source": SOURCES[name],
                "replaces": f"{REPLACES[name]} ({variant} variant)",
                "launches": launches[variant][name],
                **kernels[f"{name}[{variant}]"]})
    log(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
