"""Smoke test of the PyTorch/CUDA port (dpmmsubclusters_tpu_torch) on one
NVIDIA GPU: builds the hand-written kernels from csrc/, checks each against
its plain PyTorch version at the flagship shapes, then drives ``fit`` through
the 4-corner gate, the 200k x 32-d recovery gate and the 1M x 32-d flagship.

    python3 chip_smoke.py

Any failed check raises (non-zero exit).  On success the line before the
last is a JSON object describing each kernel (launches in the flagship fit,
error against the plain version, kernel and plain times), preceded by the
card's name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
CUDA is unavailable.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_FLAG, D_FLAG, K_TRUE_FLAG, K_MAX_FLAG = 1_048_576, 32, 64, 128
HASH_TILE = 512


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


def flagship_data(n: int, d: int, k_true: int, seed: int = 0):
    """bench.py's flagship mixture: separated means (x8), unit covariances."""
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


def check_kernels(torch, dev, smi: str) -> dict:
    """Kernels A and B against their plain versions at the flagship shapes
    (N=1,048,576, F=561, K=128, hash tile 512)."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk
    from dpmmsubclusters_tpu_torch.priors import GAUSSIAN
    from dpmmsubclusters_tpu_torch.sampler.assign import _delta_phi

    x, _ = flagship_data(N_FLAG, D_FLAG, K_TRUE_FLAG)
    x = (x - x.mean(0)) / x.std(0)           # fit's centering + scaling
    feat = GAUSSIAN.features(torch.as_tensor(x).to(dev))
    n, f = feat.shape
    k = K_MAX_FLAG
    gen = torch.Generator(device=dev).manual_seed(1)
    post = {
        "kappa": torch.full((k, 3), 5.0, device=dev),
        "m": torch.randn((k, 3, D_FLAG), generator=gen, device=dev),
        "nu": torch.full((k, 3), D_FLAG + 5.0, device=dev),
        "psi": torch.eye(D_FLAG, device=dev).expand(k, 3, D_FLAG, D_FLAG),
    }
    phi = GAUSSIAN.sample_params(gen, post,
                                 torch.ones(k, 3, dtype=torch.bool,
                                            device=dev))["phi"]
    phi_mat = _delta_phi(phi, torch.log(torch.full((k, 2), 0.5, device=dev)))
    log_w = torch.log(torch.full((k,), 1.0 / k, device=dev))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-1000:] = False
    seed = 12345
    out = {}

    # --- kernel A
    def run_a(hard):
        return sk.fused_assign(feat, valid, phi_mat, log_w, seed, 0, hard,
                               tile=HASH_TILE)

    def plain_a(hard):
        return sk.fused_assign_reference(feat, valid, phi_mat, log_w, seed, 0,
                                         hard, tile=HASH_TILE)

    lk, sk_, stk = run_a(True)
    lp, sp, _ = plain_a(True)
    torch.cuda.synchronize()
    diff = torch.nonzero(lk != lp)[:, 0]
    if diff.numel():
        # a flip is only allowed where the plain logits tie to within the
        # float32 rounding of a 561-term dot product in another order
        ll = feat[diff] @ phi_mat[:, :k] + log_w
        top2 = torch.topk(ll, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).abs()
        bound = 1e-4 * top2[:, 0].abs().clamp(min=1.0)
        if bool((gap > bound).any()):
            raise AssertionError(f"kernel A hard labels differ beyond ties: "
                                 f"{int((gap > bound).sum())} rows")
    log(f"kernel A hard: {n - diff.numel()}/{n} labels identical "
        f"({diff.numel()} near-tie flips)")
    lk, sk_, stk = run_a(False)
    lp, sp, _ = plain_a(False)
    agree_l = float((lk == lp).float().mean())
    agree_s = float((sk_ == sp).float().mean())
    log(f"kernel A soft: labels agree {agree_l:.6f}, sub-labels {agree_s:.6f}")
    assert agree_l >= 0.999 and agree_s >= 0.999, (agree_l, agree_s)
    st_plain = sk.stats_from_labels_reference(feat, lk, sk_, valid, k)
    err_a = close(torch, stk, st_plain, 1e-4, 1e-3)
    l2, s2, st2 = run_a(False)
    assert torch.equal(l2, lk) and torch.equal(s2, sk_) and torch.equal(
        st2, stk), "kernel A is not deterministic"
    assert sk.fused_assign.launches > 0, "kernel A never launched"
    ms_a = time_ms(torch, lambda: run_a(False))
    plain_ms_a = time_ms(torch, lambda: plain_a(False))
    log(f"kernel A: {ms_a:.3f} ms, plain {plain_ms_a:.3f} ms "
        f"(N={n}, F={f}, K={k}; {smi})")
    out["fused_assign"] = dict(max_abs_err=err_a, ms=ms_a,
                               plain_ms=plain_ms_a)

    # --- kernel B
    labels = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    stb = sk.stats_from_labels(feat, labels, sub, valid, k)
    err_b = close(torch, stb,
                  sk.stats_from_labels_reference(feat, labels, sub, valid, k),
                  1e-4, 1e-3)
    assert torch.equal(stb, sk.stats_from_labels(feat, labels, sub, valid, k)), \
        "kernel B is not deterministic"
    assert sk.stats_from_labels.launches > 0, "kernel B never launched"
    ms_b = time_ms(torch, lambda: sk.stats_from_labels(feat, labels, sub,
                                                       valid, k))
    plain_ms_b = time_ms(torch, lambda: sk.stats_from_labels_reference(
        feat, labels, sub, valid, k))
    log(f"kernel B: {ms_b:.3f} ms, plain {plain_ms_b:.3f} ms "
        f"(N={n}, F={f}, K={k}; {smi}); max abs err {err_b:.3g}")
    out["stats_from_labels"] = dict(max_abs_err=err_b, ms=ms_b,
                                    plain_ms=plain_ms_b)
    del feat
    torch.cuda.empty_cache()
    return out


def run_fit(torch, name: str, x, gt, **kw):
    """One ``fit`` on the card, ground truth given (block-boundary NMI in
    the history), with the kernels' launch counts reset just before;
    asserts both kernels ran.  Returns (result, nmi, counts)."""
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    sk.fused_assign.launches = 0
    sk.stats_from_labels.launches = 0
    t0 = time.perf_counter()
    res = dpmm.fit(x, device="cuda", verbose=False, gt=gt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {"fused_assign": sk.fused_assign.launches,
              "stats_from_labels": sk.stats_from_labels.launches}
    assert all(c > 0 for c in counts.values()), (name, counts)
    nmi = dpmm.nmi(gt, res.labels)
    log(f"{name}: K={res.k} NMI={nmi:.6f} in {secs:.1f} s, launches {counts}")
    return res, nmi, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.ops import _build

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

    # 4-corner golden gate (tests/test_fit_e2e.py::TestFourCorners)
    x = np.zeros((1000, 2), np.float32)
    gt = np.zeros(1000, np.int64)
    for i, c in enumerate([[10, 10], [-10, 10], [10, -10], [-10, -10]]):
        x[i * 250:(i + 1) * 250] = c
        gt[i * 250:(i + 1) * 250] = i
    res, nmi, _ = run_fit(torch, "4 corners", x, gt, alpha=100.0, iters=100,
                          seed=12345, burnout=5)
    pred, _ = res.predict(x)
    assert res.k == 4 and nmi == 1.0, (res.k, nmi)
    assert np.array_equal(pred, res.labels), "predict != labels"

    # 200k x 32-d recovery (benchmarks/stats_precision_ab.py quality data)
    rng = np.random.default_rng(0)
    means = rng.standard_normal((20, 32)).astype(np.float32) * 8.0
    gt = rng.integers(0, 20, size=200_000)
    x = means[gt] + rng.standard_normal((200_000, 32)).astype(np.float32)
    res, nmi, _ = run_fit(torch, "200k x 32-d", x, gt, alpha=10.0, iters=200,
                          seed=1, k_max=64)
    assert res.k == 20 and nmi == 1.0, (res.k, nmi)

    # 1M x 32-d flagship: bench.py's data and config, through fit
    x, gt = flagship_data(1_000_000, D_FLAG, K_TRUE_FLAG)
    res, nmi, counts = run_fit(
        torch, "flagship 1M x 32-d", x, gt, alpha=10.0, iters=120, seed=0,
        k_max=K_MAX_FLAG, chunk_size=16384, burnout=5, track_posterior=False,
        merge_candidates=K_MAX_FLAG, precompute_features=True)
    ms_sweep = float(np.median(res.history.times[-40:])) * 1e3
    log(f"flagship: K={res.k} NMI={nmi:.6f} median {ms_sweep:.2f} ms/sweep "
        f"over the last 40 sweeps = "
        f"{1_000_000 / ms_sweep * 1e3:.4g} point-sweeps/s ({smi})")
    assert res.k == K_TRUE_FLAG and nmi >= 0.999, (res.k, nmi)

    replaces = {
        "fused_assign": "dpmmsubclusters_tpu/ops/pallas_sweep.py:518",
        "stats_from_labels": "dpmmsubclusters_tpu/ops/pallas_sweep.py:439",
    }
    report = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dpmmsubclusters_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": counts[name],
         **kernels[name]}
        for name in ("fused_assign", "stats_from_labels")
    ]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
