"""The port's spans and counters (``utils/profiling.py``) on the CPU: spans
nest and close with their lengths, per-sweep spans, counters and named
host reads record only while tracing is on, tracing leaves the chain bit
for bit as it was, a torch profiler's trace holds the port's span names,
a fit's ``history.phases``, and the benchmark's readers of the record
(``dpmmbench/metrics/``)."""
import torch_threads  # noqa: F401

import functools
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu_torch as dpmm  # noqa: E402
from dpmmsubclusters_tpu_torch import priors  # noqa: E402
from dpmmsubclusters_tpu_torch.config import DPMMConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler.driver import DPMMEngine  # noqa: E402
from dpmmsubclusters_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PER_SWEEP = ("table_math.sample_params", "kernel_a.assign_and_stats",
             "table_math.moves")
ALWAYS = ("entry.fit", "entry.standardize", "entry.transfer",
          "cache_build.featurize", "entry.init_state", "table_math.smart",
          "host_loop.step_block", "host_loop.tier_step")
READERS = ("init_s", "cache_build_s", "init_s.fit", "standardize_s.fit",
           "smart_s.fit", "host_syncs_per_sweep", "host_syncs_per_sweep.fit",
           "params_ms", "moves_ms", "assign_resident_pct")


@pytest.fixture(autouse=True)
def fresh_record():
    """Each test starts from an empty record with tracing off, and leaves
    tracing off."""
    profiling.enable(False)
    profiling.reset()
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


def _corners(n_each=200, seed=0):
    rng = np.random.default_rng(seed)
    centres = [(10, 10), (-10, 10), (10, -10), (-10, -10)]
    return np.concatenate([rng.normal(c, 1.0, (n_each, 2))
                           for c in centres]).astype(np.float32)


def _fit(x, **kw):
    return dpmm.fit(x, alpha=10.0, iters=20, seed=7, device="cpu",
                    verbose=False, **kw)


def _steady_block(x, sweeps=4):
    """One block of ``sweeps`` sweeps through ``DPMMEngine.step_block`` at
    a fixed width, as the benchmark's steady cells run them."""
    engine = DPMMEngine(priors.GAUSSIAN,
                        DPMMConfig(verbose=False, k_max=16), "cpu")
    pts = torch.as_tensor(x)
    valid = torch.ones(len(x), dtype=torch.bool)
    points = engine.featurize(pts) if engine.cfg.precompute_features else pts
    gen = torch.Generator().manual_seed(3)
    state = engine.init_state(gen, points, valid,
                              priors.GAUSSIAN.default_prior(x.shape[1]))
    flags = np.zeros(sweeps, bool)
    state, metrics = engine.step_block(state, points, valid, float(len(x)),
                                       flags, flags)
    return state, metrics["k"].tolist()


def test_spans_nest_with_their_parents_and_close_with_durations():
    with profiling.span("outer.a") as a:
        time.sleep(0.002)
        with profiling.span("inner.b") as b:
            time.sleep(0.01)
        with profiling.span("inner.c", detail=True) as c:
            pass
    with profiling.span("outer.d") as d:
        pass
    got = profiling.spans()
    assert [s.name for s in got] == ["inner.b", "outer.a", "outer.d"]
    assert c is None                        # off: the shared no-op
    assert a.parent is None and d.parent is None and b.parent == a.id
    assert len({a.id, b.id, d.id}) == 3
    assert b.seconds >= 0.01 and a.seconds >= b.seconds + 0.002
    assert a.start <= b.start and b.end <= a.end <= d.start
    assert all(not s.detail for s in got)


def test_the_record_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling._REC, "limit", 8)
    profiling.reset()
    for i in range(20):
        with profiling.span(f"s.{i}"):
            pass
    assert [s.name for s in profiling.spans()] == [f"s.{i}"
                                                   for i in range(12, 20)]
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_host_read_reads_as_the_sites_read():
    for on in (False, True):
        profiling.enable(on)
        three = profiling.host_read(torch.tensor(3), "a")
        assert three == 3 and isinstance(three, int)
        flag = profiling.host_read(torch.tensor([1.5]).sum() > 1, "b")
        assert flag is True
        assert profiling.host_read(torch.arange(3), "c") == [0, 1, 2]
        half = profiling.host_read(torch.tensor(0.5), "d")
        assert half == 0.5 and isinstance(half, float)
    assert profiling.counters() == {f"host_sync.{s}": 1 for s in "abcd"}
    assert [s.name for s in profiling.spans()] == [f"host_sync.{s}"
                                                   for s in "abcd"]


@pytest.mark.parametrize("switch", ["enable", "profiler"])
def test_per_sweep_spans_and_counters_record_only_while_tracing(switch):
    x = _corners()
    _steady_block(x)
    names = {s.name for s in profiling.spans()}
    assert names and not names & set(PER_SWEEP)
    assert not any(n.startswith("host_sync.") for n in names)
    assert profiling.counters() == {}
    assert not profiling.tracing()

    profiling.reset()
    if switch == "enable":
        profiling.enable()
        _steady_block(x)
        profiling.enable(False)
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.tracing()
            _steady_block(x)
    counts = profiling.counters()
    assert counts["sweeps"] == 4
    assert counts["host_sync.smart_needed"] == 1
    got = profiling.spans()
    for name in PER_SWEEP:
        assert sum(s.name == name for s in got) == 4
        assert all(s.detail for s in got if s.name == name)
    block = [s for s in got if s.name == "host_loop.step_block"]
    assert len(block) == 1 and not block[0].detail
    inside = [s for s in got if s.parent == block[0].id]
    assert {s.name for s in inside} >= set(PER_SWEEP) | {
        "host_sync.smart_needed"}


def test_tracing_leaves_the_chain_bit_identical():
    from torch.profiler import ProfilerActivity, profile

    x = _corners()
    off = _fit(x)
    profiling.enable()
    on = _fit(x)
    profiling.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _fit(x)
    for res in (on, traced):
        assert np.array_equal(res.model.labels_raw, off.model.labels_raw)
        assert np.array_equal(res.model.sublabels, off.model.sublabels)
        assert res.history.k == off.history.k
        assert res.history.log_posterior == off.history.log_posterior
        flat_a = dict(_leaves(off.model.table))
        flat_b = dict(_leaves(res.model.table))
        assert flat_a.keys() == flat_b.keys()
        for key, a in flat_a.items():
            assert torch.equal(a, flat_b[key]), key
        assert np.array_equal(res.model.gen_state, off.model.gen_state)
    assert profiling.counters()["sweeps"] == 40


def _leaves(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{key}.")
        else:
            yield prefix + key, v


def test_a_profiler_trace_holds_the_port_span_names(tmp_path):
    x = _corners()
    with profiling.trace(str(tmp_path / "tr")):
        _fit(x)
    (path,) = (tmp_path / "tr").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    named = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    want = set(ALWAYS) | set(PER_SWEEP) | {
        "host_sync.block_fence", "host_sync.log_posterior",
        "host_sync.smart_needed", "host_sync.smart_lloyd"}
    assert want <= named, want - named


def test_fit_history_phases_total_the_always_on_spans():
    x = _corners()
    res = _fit(x)
    ph = res.history.phases
    assert set(ph) == set(ALWAYS)
    assert all(v >= 0.0 for v in ph.values())
    parts = sum(v for k, v in ph.items() if k in (
        "entry.standardize", "entry.transfer", "cache_build.featurize",
        "entry.init_state", "host_loop.step_block", "host_loop.tier_step"))
    assert parts <= ph["entry.fit"]
    assert ph["host_loop.step_block"] <= sum(res.history.times)
    # per-sweep spans stay out of the phases while tracing is on
    profiling.enable()
    traced = _fit(x)
    assert set(traced.history.phases) == set(ALWAYS)
    # a resume has no entry.fit
    assert dpmm.api.IterStats.empty().phases == {}


def _reader(name):
    path = ROOT / "dpmmbench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_record_and_none_from_an_empty_one(name):
    read = _reader(name)
    assert read(None) is None
    x = _corners()
    profiling.enable()
    _fit(x)
    _steady_block(x)
    profiling.enable(False)
    value = read(None)
    assert isinstance(value, float) and value > 0.0, value


class _FakeEvent:
    """A CUDA event on a fake card whose clock is the host's and whose work
    finishes when the test says so."""

    done = False

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        _FakeEvent.done = True

    def elapsed_time(self, other):
        assert _FakeEvent.done
        return (other.t - self.t) * 1e3


def test_device_spans_resolve_at_fences_without_a_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling._REC, "origins", {})
    _FakeEvent.done = False
    with profiling.span("host_loop.step_block", phases=True) as a:
        time.sleep(0.005)
    profiling.resolve()                   # the card is still busy
    assert len(profiling._REC.pending) == 1 and not profiling._REC.closed
    with profiling.span("host_loop.step_block"):
        pass                              # opening polls: still busy
    assert len(profiling._REC.pending) == 2
    _FakeEvent.done = True                # a fence: the card caught up
    profiling.resolve()
    assert not profiling._REC.pending
    first, second = profiling._REC.closed
    assert first is a and a.seconds >= 0.005 and second.start >= a.end
    assert profiling.phases(a) == {"host_loop.step_block": a.seconds}


def _assign_case(k, live, family="gaussian", n=300, d=2):
    """Kernel A's inputs at table width ``k`` with the slots ``live`` active
    (log_w -inf elsewhere): Gaussian points, or their bf16 cache."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    gen = torch.Generator().manual_seed(k + len(live))
    x = torch.randn((n, d), generator=gen)
    f = priors.GAUSSIAN.feature_dim(d)
    if family == "bfloat16":
        x = sk.pad_bf16_rows(priors.GAUSSIAN.features(x).bfloat16())
    phi = torch.randn((f, 2 * k), generator=gen) * 0.1
    log_w = torch.full((k,), float("-inf"))
    if live:
        log_w[list(live)] = -float(np.log(len(live)))
    return x, torch.ones(n, dtype=torch.bool), phi, log_w


@pytest.mark.parametrize("family", ["gaussian", "bfloat16"])
@pytest.mark.parametrize("k,live,want", [
    (256, range(100), (1, 2)),
    (256, [*range(100), 200], (2, 2)),
    (256, [], (1, 2)),
    (200, [0, 150], (2, 2)),
    (128, range(100), None)])
def test_plain_kernel_a_counts_the_passes_of_its_live_columns(family, k,
                                                              live, want):
    """Under "default" (the ring's three-pass split on built rows, the
    tensor-map kernel's one bf16 pass on a bf16 cache) at a table width
    above 128, the plain version counts what the card's launch adds to its
    pass tally: the passes up to the highest live slot, of the width's two.
    A width of one pass counts nothing."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    x, valid, phi, log_w = _assign_case(k, live, family)
    profiling.enable()
    sk.fused_assign(x, valid, phi, log_w, 5, family_name=family,
                    ll_precision="default")
    profiling.enable(False)
    counts = profiling.counters()
    if want is None:
        assert not set(profiling.PASS_COUNTERS) & set(counts)
    else:
        assert tuple(counts[n] for n in profiling.PASS_COUNTERS) == want
    assert sk.live_passes(log_w) == (want[0] if want else 1)


def test_plain_kernel_a_counts_no_passes_off_the_two_wide_kernels():
    """The exact route and one bf16 pass over float32 rows take neither
    kernel at a pass width of 256: no pass is counted (the bf16 pass counts
    as a tensor-core launch only)."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    x, valid, phi, log_w = _assign_case(256, range(100))
    profiling.enable()
    for route in ("highest", "bf16"):
        sk.fused_assign(x, valid, phi, log_w, 5, family_name="gaussian",
                        ll_precision=route)
    profiling.enable(False)
    assert profiling.counters() == {"kernel_a.tc_launches": 1}


def test_pass_counts_need_tracing_and_reset_drops_them():
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    x, valid, phi, log_w = _assign_case(256, range(100))
    call = functools.partial(sk.fused_assign, x, valid, phi, log_w, 5,
                             family_name="gaussian", ll_precision="default")
    call()
    assert profiling.counters() == {}
    profiling.enable()
    call()
    call()
    assert profiling.counters() == {"kernel_a.passes_run": 2,
                                    "kernel_a.passes_width": 4,
                                    "kernel_a.tc_launches": 2}
    profiling.reset()
    assert profiling.counters() == {}


def test_assign_pass_pct_reads_the_pass_counts():
    """``dpmmbench/metrics/assign_pass_pct.py``: 100 x passes run / passes
    the width calls for, None where no such launch was counted."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    read = _reader("assign_pass_pct")
    assert read(None) is None
    profiling.enable()
    for live in (range(100), range(100), range(100), [*range(100), 200]):
        sk.fused_assign(*_assign_case(256, live), 5, family_name="gaussian",
                        ll_precision="default")
    profiling.enable(False)
    assert read(None) == pytest.approx(100.0 * 5 / 8)


@pytest.mark.parametrize("f,k,planes,pitch,bufs", [
    (101, 64, 2, 4 * 100, 3),      # the 20M counts: built rows [1, x]
    (101, 64, 1, 4 * 100, 6),      # the same under one bf16 pass
    (561, 16, 2, 4 * 32, 0),       # rows built at D=32: 9 slices
    (128, 16, 2, 4 * 127, 4),      # 2 slices
    (129, 16, 2, 4 * 128, 0),      # 3 slices
    (6, 4, 2, 4 * 6, 8),           # the 4 corners' f32 cache
    (2145, 256, 2, 4 * 64, 0),     # width 256: the ring
    (561, 128, 2, 4 * 32, 0),
    (561, 64, 2, 4 * 32, 0),       # phi_t 295 KB
    (2145, 16, 2, 4 * 64, 0),      # phi_t 278 KB
    (561, 16, 2, 4 * 561, 0),      # the f32 cache: a tile is 143.6 KB
    (561, 16, 1, 2 * 568, 0)])     # the bf16 cache: two tiles fit, not 3
def test_resident_rule_follows_the_shape(f, k, planes, pitch, bufs):
    """Kernel A's route rule (``resident_bufs``): the resident kernel takes
    a pass of width 128 or less, over at most two 64-feature slices, whose
    staged phi, its two pipelines' row tiles and at least three 64-row
    buffers fit in one SM, with as many buffers as fit up to 8; the family
    is never asked."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    assert sk.resident_bufs(f, k, planes, pitch) == bufs


def _route_case(family, d, k, n=200):
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    gen = torch.Generator().manual_seed(d + k)
    x = torch.rand((n, d), generator=gen) * 4
    if family == "multinomial":
        x = x.round()
    elif family == "precomputed":
        x = priors.GAUSSIAN.features(x)
    elif family == "bfloat16":
        x = sk.pad_bf16_rows(priors.GAUSSIAN.features(x).bfloat16())
    f = sk.feature_dim(family, x.shape[1])
    phi = torch.randn((f, 2 * k), generator=gen) * 0.01
    log_w = torch.full((k,), -float(np.log(k)))
    return x, torch.ones(n, dtype=torch.bool), phi, log_w


@pytest.mark.parametrize("family,d,k,route,want", [
    ("multinomial", 100, 64, "default", (1, 1)),
    ("multinomial", 100, 64, "bf16", (1, 1)),
    ("gaussian", 32, 16, "default", (0, 1)),
    ("gaussian", 32, 64, "default", (0, 1)),
    ("gaussian", 2, 256, "default", (0, 1)),
    ("precomputed", 32, 16, "default", (0, 1)),
    ("precomputed", 2, 16, "default", (1, 1)),
    ("bfloat16", 32, 16, "default", (0, 1)),
    ("bfloat16", 2, 16, "high", (1, 1)),
    ("multinomial", 100, 64, "highest", None)])
def test_plain_kernel_a_counts_its_route(family, d, k, route, want):
    """While tracing, the plain version counts what a card's launch counts
    on the host: each tensor-core launch in ``kernel_a.tc_launches``, those
    the rule hands the resident kernel in ``kernel_a.resident_launches``
    (from the shape, as the wrapper chooses); the exact route neither."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    args = _route_case(family, d, k)
    sk.fused_assign(*args, 5, family_name=family, ll_precision=route)
    assert profiling.counters() == {}
    profiling.enable()
    sk.fused_assign(*args, 5, family_name=family, ll_precision=route)
    profiling.enable(False)
    counts = profiling.counters()
    got = tuple(counts.get(n, 0) for n in profiling.ROUTE_COUNTERS)
    assert got == (want or (0, 0))


def test_assign_resident_pct_reads_the_route_counts():
    """``dpmmbench/metrics/assign_resident_pct.py``: 100 x resident
    launches / tensor-core launches, None where none was counted."""
    from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk

    read = _reader("assign_resident_pct")
    assert read(None) is None
    profiling.enable()
    sk.fused_assign(*_route_case("multinomial", 100, 64, n=50), 5,
                    family_name="multinomial", ll_precision="highest")
    assert read(None) is None
    for family, d, k in (("multinomial", 100, 64), ("gaussian", 2, 256),
                         ("gaussian", 2, 256), ("gaussian", 2, 256)):
        sk.fused_assign(*_route_case(family, d, k, n=50), 5,
                        family_name=family, ll_precision="default")
    profiling.enable(False)
    assert read(None) == pytest.approx(25.0)
