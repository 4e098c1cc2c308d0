"""The benchmark's multinomial/Dirichlet configuration on the CPU: its plain
reference (``dpmmbench/reference/multinomial.py``) against the port's
plain kernels and posterior, its count generator, a tiny copy of its cell
run end to end through the harness, the roofline counts of its work, and
the port's family spans under both families.  The benchmark is imported
by path, as ``dpmmbench/tests/tinybench.py`` does."""
import torch_threads  # noqa: F401

import importlib.util
import math
import pathlib
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dpmmbench import check, counts, harness  # noqa: E402
from dpmmbench.reference import multinomial as ref  # noqa: E402
from dpmmsubclusters_tpu_torch import priors  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.ops.linalg import sample_dirichlet  # noqa: E402,E501
from dpmmsubclusters_tpu_torch.sampler import assign  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine  # noqa: E402
from dpmmsubclusters_tpu_torch.utils import profiling  # noqa: E402

CONFIG = "mnm-20Mx100d-k20"
CELL = CONFIG + ".counts-steady"
N, D, TRIALS = 4096, 100, 120
MNM = priors.MULTINOMIAL


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tinybench():
    return _load(ROOT / "dpmmbench" / "tests" / "tinybench.py",
                 "dpmmbench_tinybench")


def _reader(name):
    return _load(ROOT / "dpmmbench" / "metrics" / f"{name}.py",
                 "dpmmbench_reader_" + name).read


def _drawn_call(k, seed):
    """Counts of ``k`` clusters, a table's drawn parameters (the port's
    Dirichlet draws from the posteriors of the generator's labels and
    random sub-labels), and the port's plain kernel A on them."""
    x, gt, _ = counts.mnmm_data(N, D, k, TRIALS, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    sub = torch.randint(0, 2, (N,), generator=gen, dtype=torch.int32)
    labels = gt.to(torch.int32)
    valid = torch.ones(N, dtype=torch.bool)
    stats_lr = assign.stats_only(x, valid, labels, sub, k, family=MNM,
                                 x_is_features=False)
    flat3 = assign.lr_to_full(stats_lr)
    stats = MNM.stats_from_flat(flat3, D)
    prior = MNM.tile_prior(MNM.default_prior(D), (k, 3))
    post = MNM.calc_posterior(prior, stats)
    params = MNM.sample_params(gen, post, torch.ones((k, 3), dtype=bool))
    log_w = torch.log(sample_dirichlet(gen, torch.full((k,), 2.0)))
    lr_w = sample_dirichlet(gen, torch.ones(k, 2))
    kseed = 12345 + k
    out = assign.assign_and_stats(
        x, valid, params["phi"], log_w, torch.log(lr_w), kseed, False,
        family=MNM, x_is_features=False, ll_precision="default")
    call = check.AssignCall(ref, params, log_w, lr_w, kseed, False,
                            assign.HASH_TILE, 0, *out)
    return x, labels, sub, valid, stats, post, call


@pytest.mark.parametrize("k", [4, 16])
def test_the_reference_holds_the_ports_plain_kernels_and_posterior(k):
    x, labels, sub, valid, stats, post, call = _drawn_call(k, 7 + k)
    # kernel A's labels lie within the float32 split's rounding of the
    # reference's best; its statistics, and kernel B's, are exact
    b = sk.stats_from_labels(x, labels, sub, valid, k, "multinomial")
    want = ref.sums_by_key(ref.features(x), sub.long() * k + labels.long(),
                           2 * k)
    assert torch.equal(b.to(torch.float64), want)
    b_k2f = torch.stack([b[:k], b[k:]], 1)
    got = check.judge_sweep(ref, x, call, [(labels, sub, b_k2f)],
                            check.TIE_EPS["float32"])
    assert got["label_flips"] == 0 and got["stats_err"] == 0.0, got
    # the Dirichlet posterior of the same statistics, exact in float32
    prior = {"alpha": torch.ones((k, 3, D), dtype=torch.float64)}
    assert torch.equal(post["alpha"].to(torch.float64),
                       ref.posterior(prior, stats)["alpha"])
    # the bf16 control's logits leave that rounding on some row
    feats = ref.features(x)
    exact = feats @ call.coeff_w
    ctl = (ref.quantize(feats, "bfloat16")
           @ ref.quantize(call.coeff_w, "bfloat16")).to(torch.float64)
    size = feats.abs() @ call.coeff_w.abs()
    assert bool(((ctl - exact).abs()
                 > check.TIE_EPS["float32"] * size).any())


def test_the_reference_keeps_the_prior_of_empty_slots():
    prior = {"alpha": torch.full((2, D), 0.5, dtype=torch.float64)}
    stats = {"n": torch.tensor([0.0, 3.0]),
             "sum_x": torch.arange(2 * D, dtype=torch.float32).view(2, D)}
    got = ref.posterior(prior, stats)["alpha"]
    assert torch.equal(got[0], prior["alpha"][0])
    assert torch.equal(got[1], 0.5 + stats["sum_x"][1].double())
    assert ref.feature_dim(D) == D + 1
    assert ref.default_prior(D, "cpu")["alpha"].tolist() == [1.0] * D


def test_the_count_generator_follows_the_source_rule():
    n, k = 8192, 4
    x, labels, probs = counts.mnmm_data(n, D, k, TRIALS, 2**31 + 5, "cpu")
    again = counts.mnmm_data(n, D, k, TRIALS, 2**31 + 5, "cpu")
    assert torch.equal(x, again[0]) and torch.equal(labels, again[1])
    assert x.dtype == torch.float32 and x.shape == (n, D)
    assert torch.equal(x, x.round()) and bool((x >= 0).all())
    assert torch.equal(x.sum(1), torch.full((n,), float(TRIALS)))
    assert torch.allclose(probs.sum(1), torch.ones(k, dtype=torch.float64))
    for c in range(k):
        rows = x[labels == c].double()
        p = probs[c]
        se = torch.sqrt(TRIALS * p * (1 - p) / rows.shape[0])
        assert bool(((rows.mean(0) - TRIALS * p).abs() <= 5 * se).all()), c
    other = counts.mnmm_data(n, D, k, TRIALS, 2**31 + 6, "cpu")[0]
    assert not torch.equal(x, other)


@pytest.fixture
def tiny(tmp_path):
    bench = _tinybench().make_tiny(tmp_path, sizes={CONFIG: {
        "data": {"n": N, "d": D, "k_true": 4},
        "sampler": {"k_max": 16, "merge_candidates": None}}})
    return harness.Spec(bench, tmp_path / "dpmmbench")


def test_a_tiny_copy_of_the_cell_runs_end_to_end(tiny):
    def run(seed, **kw):
        return harness.run(tiny, CELL, seed, 0.2, kw.get("trace", False),
                           "cpu", time.perf_counter(),
                           control=kw.get("control", False))

    sound = run(2**31 + 21)
    assert sound["correct"] and sound["failed"] == 0, sound["checked"]
    assert set(sound["metrics"]) == {"sweep_ms", "peak_mem_gb", "setup_s"}
    assert sound["attempted"] % 16 == 0 and sound["attempted"] > 0
    assert sound["checked"]["stats_err"]["value"] == 0.0
    assert sound["checked"]["post_err"]["value"] == 0.0
    control = run(2**31 + 22, control=True)
    assert not control["correct"], control["checked"]
    traced = run(2**31 + 23, trace=True)
    assert traced["correct"], traced["checked"]
    family = traced["metrics"]["family_ms"]["value"]
    assert math.isfinite(family) and family > 0.0


def test_the_cells_work_feeds_the_roofline_readers(tiny):
    """The tiny cell's own ``work`` and traced sweeps read by the kernel
    readers; the CPU's trace holds no kernels, so the test gives kernel
    A's and kernel B's device seconds."""
    p = harness.plan(tiny, CELL)
    out = tiny.runner(p.traffic["kind"])(p, 2**31 + 24, 0.1, True, "cpu",
                                         time.perf_counter,
                                         time.perf_counter())
    ctx = out["ctx"]
    assert ctx.work == dict(n=N, d=D, f=D + 1, k_live=4, rows="raw",
                            passes=3, peak="bf16")
    ctx.peaks = tiny.data("peaks.json")
    ctx.trace["group_s"] = {"assign": 1e-3, "stats": 1e-4, "other": 0.0}
    for name in ("assign_roofline", "stats_roofline"):
        value = _reader(name)(ctx)
        assert math.isfinite(value) and value > 0.0, name


def test_the_roofline_counts_of_the_cell_are_the_hand_count():
    """20M x 100-d counts at live K=20: rows of 4 d bytes read once, F = D
    + 1, no built quadratic features, three bf16 passes."""
    p = harness.plan(harness.Spec(ROOT / "BENCHMARK.json"), CELL)
    w = harness.work(p, 20)
    n, d, f, k = 20_000_000, 100, 101, 20
    assert w == dict(n=n, d=d, f=f, k_live=k, rows="raw", passes=3,
                     peak="bf16")
    peaks = harness.Spec(ROOT / "BENCHMARK.json").data("peaks.json")
    hbm, bf16, fp32 = (peaks["hbm_bytes_per_s"], peaks["bf16_flop_per_s"],
                       peaks["fp32_flop_per_s"])
    product = 3 * 2.0 * n * f * (k + 1) / bf16
    assign_bytes = n * (4 * d + 9) + 4 * (2 * f * k + k)
    stats_bytes = n * (4 * d + 9) + 4 * 2 * k * f
    sweep_bytes = n * (4 * d + 9) + 4 * (2 * f * k + k) + 4 * 2 * k * f
    want = {"assign_roofline": max(assign_bytes / hbm, product),
            "stats_roofline": max(stats_bytes / hbm, n * f / fp32),
            "sweep_mfu": max(sweep_bytes / hbm, product + n * f / fp32)}
    for name, least in want.items():
        mod = _load(ROOT / "dpmmbench" / "metrics" / f"{name}.py",
                    "dpmmbench_count_" + name)
        assert mod.least_s(w, peaks) == pytest.approx(least, rel=1e-12)
    # bound by bytes: 8.18 GB at 3.35 TB/s
    assert 2.44e-3 < want["assign_roofline"] < 2.45e-3


@pytest.fixture
def fresh_record():
    profiling.enable(False)
    profiling.reset()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def _block(family, x, sweeps=3):
    engine = DPMMEngine(family, DPMMConfig(verbose=False, k_max=16,
                                           burnout=2), "cpu")
    valid = torch.ones(x.shape[0], dtype=torch.bool)
    gen = torch.Generator().manual_seed(3)
    state = engine.init_state(gen, x, valid,
                              family.default_prior(x.shape[1]))
    flags = np.zeros(sweeps, bool)
    engine.step_block(state, x, valid, float(x.shape[0]), flags, flags)


@pytest.mark.parametrize("family", ["gaussian", "multinomial"])
def test_family_spans_record_under_tracing_for_both_families(family,
                                                             fresh_record):
    if family == "gaussian":
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.concatenate(
            [rng.normal(c, 1.0, (200, 2)) for c in (-10, 10)]),
            dtype=torch.float32)
    else:
        x = counts.mnmm_data(400, 20, 2, TRIALS, 5, "cpu")[0]
    fam = getattr(priors, family.upper())
    read = _reader("family_ms")
    _block(fam, x)
    names = {s.name for s in profiling.spans()}
    assert not any(n.startswith("table_math.family.") for n in names)
    assert read(None) is None
    profiling.reset()
    profiling.enable()
    _block(fam, x)
    profiling.enable(False)
    got = profiling.spans()
    by_id = {s.id: s for s in got}
    family_spans = [s for s in got if s.name.startswith("table_math.family.")]
    assert {s.name for s in family_spans} == {
        "table_math.family.draw", "table_math.family.posterior",
        "table_math.family.marginal"}
    assert all(s.detail for s in family_spans)
    draws = [s for s in family_spans if s.name == "table_math.family.draw"]
    # the init's draw and one a sweep, each under the sweep's step A
    assert len(draws) == 4
    assert sum(by_id[s.parent].name == "table_math.sample_params"
               for s in draws if s.parent in by_id) == 3
    assert not any(by_id[s.parent].name.startswith("table_math.family.")
                   for s in family_spans if s.parent in by_id)
    value = read(None)
    assert isinstance(value, float) and value > 0.0
