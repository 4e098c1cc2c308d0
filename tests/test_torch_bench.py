"""The port's bench slice on the CPU: kernels C (column sums) and D (the
stage ablation) and kernel A's tile-study mode, held against the JAX
package's study kernels run through the Pallas interpreter on identical
inputs; the profiling helpers; the bench entry point.  The CUDA kernels
run only on a card: tests/test_torch_card_bench.py, and ``python3
chip_smoke.py`` at the studies' full sizes."""
import functools
import importlib.util
import json
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from dpmmsubclusters_tpu.ops import pallas_sweep as ps  # noqa: E402
from dpmmsubclusters_tpu_torch.benchmarks import bench  # noqa: E402
from dpmmsubclusters_tpu_torch.benchmarks import kernel_ablate as tka  # noqa: E402,E501
from dpmmsubclusters_tpu_torch.benchmarks import kernel_tile_study as tts  # noqa: E402,E501
from dpmmsubclusters_tpu_torch.ops import study_kernels as stk  # noqa: E402
from dpmmsubclusters_tpu_torch.ops import sweep_kernels as sk  # noqa: E402
from dpmmsubclusters_tpu_torch.utils import profiling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the split2 statistics gate (tests/test_pallas.py): the TPU study kernels
# sum their statistics through two bf16 planes, an error relative to each
# term, so the bound scales with the sum of the terms' magnitudes
SPLIT2_RTOL, SPLIT2_ATOL = 3e-5, 1e-4
TIE_GAP = 1e-4          # labels and sides may differ only where the port's
N, D, K = 1024, 4, 4    # own decision values are closer than this
F = 1 + D + D * (D + 1) // 2  # 15 >= 3K


def _load(name):
    """A JAX benchmark file as a module (``benchmarks/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_studies():
    return _load("kernel_ablate"), _load("kernel_tile_study")


@pytest.fixture
def interpret(monkeypatch):
    """Run every pallas_call of the block in the Pallas interpreter."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _ablate_inputs(rng, n=N, f=F, k=K):
    x = rng.standard_normal((n, f)).astype(np.float32)
    phi = rng.standard_normal((f, 3 * k)).astype(np.float32)
    log_w = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    loglrw = np.log(rng.dirichlet([1.0, 1.0], size=k)).T.astype(np.float32)
    valid = np.arange(n) < n - 24
    return x, valid, phi, log_w, loglrw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_stats(got, want, abs_sum):
    bad = np.abs(got - want) > SPLIT2_RTOL * abs_sum + SPLIT2_ATOL
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _decisions(x, phi, log_w, loglrw, seed, tile, stages):
    """The port's labels and sides for a stage set, recomputed from its plain
    arithmetic, with their logit gaps and side margins for the near-tie
    rule."""
    xt, phit, lwt, lrt = _t(x, phi, log_w, loglrw)
    k = len(log_w)
    ll = xt @ phit
    logits = ll[:, :k] + lwt
    rows = torch.arange(len(x))
    s = sk.tile_seeds(seed, rows, tile)
    if "gumbel" in stages:
        logits = logits + sk.gumbel_noise(s, rows % tile, k)
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()
    j = torch.argmax(logits, -1)
    g2 = sk.gumbel_noise(s ^ 0xA5A5A5A5, rows % tile, 2)
    margin = ((ll[:, 2 * k:].gather(1, j[:, None])[:, 0] + lrt[1, j]
               + g2[:, 1])
              - (ll[:, k:2 * k].gather(1, j[:, None])[:, 0] + lrt[0, j]
                 + g2[:, 0])).numpy()
    side = (margin > 0) if "sub" in stages else np.zeros(len(x), bool)
    return gap, np.abs(margin), j.numpy(), side.astype(np.int64)


@pytest.mark.parametrize("name,stages", tka.VARIANTS,
                         ids=[v[0] for v in tka.VARIANTS])
def test_ablate_plain_matches_tpu_kernel(rng, jax_studies, interpret, name,
                                         stages):
    """Kernel D's plain version against the TPU study kernel
    (benchmarks/kernel_ablate.py variant) for each of the 8 stage sets."""
    jab, _ = jax_studies
    x, valid, phi, log_w, loglrw = _ablate_inputs(rng)
    seed, tile = 918273, 512
    lj, sj, stj = jab.variant(
        seed, jnp.asarray(x), jnp.asarray(valid.reshape(-1, 128)),
        jnp.asarray(phi), jnp.asarray(log_w), jnp.asarray(loglrw), k_slots=K,
        tile=tile, stages=stages, stats_prec="split2")
    lj, sj = np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)
    stj = np.asarray(stj)
    if "write" not in stages:
        # the TPU kernel zeroes only its first tile's label streams and
        # leaves the others unwritten (NaN in the interpreter); the port's
        # are zero throughout
        assert not np.nan_to_num(lj).any() and not np.nan_to_num(sj).any()
        assert np.isnan(lj[tile:]).all()
        lj, sj = np.zeros(N, np.int32), np.zeros(N, np.int32)
    lj, sj = lj.astype(np.int32), sj.astype(np.int32)
    lt, st_, stt = stk.kernel_ablate(*_t(x, valid, phi, log_w, loglrw), seed,
                                     tile=tile, stages=stages)
    assert lt.dtype == st_.dtype == torch.int32 and stt.shape == (2 * K, F)
    lt, st_, stt = lt.numpy(), st_.numpy(), stt.numpy()

    gap, margin, lab, side = _decisions(x, phi, log_w, loglrw, seed, tile,
                                        stages)
    diff = lt != lj
    assert (gap[diff] < TIE_GAP).all(), "labels differ beyond near-ties"
    sdiff = (st_ != sj) & ~diff
    assert (margin[sdiff] < TIE_GAP).all(), "sides differ beyond near-ties"
    if "write" not in stages:
        assert not lt.any() and not st_.any()
    else:
        assert len(np.unique(lt)) > 1 and 0 < st_.mean() < 1

    xa = np.abs(x).astype(np.float64)
    if stages == ("dma_only",):
        abs_sum = np.zeros_like(stj)
        abs_sum[0] = xa.sum(0)
    elif stages == ("dot_only",):
        abs_sum = np.zeros_like(stj)
        abs_sum[0, :3 * K] = np.abs(x.astype(np.float64) @ phi).sum(0)
    elif "stats" in stages:
        # the labels and sides the statistics are summed by
        key = (side * K + lab)[valid]
        abs_sum = np.zeros(stj.shape)
        np.add.at(abs_sum, key, xa[valid])
    elif stages == ("stats_raw",):
        abs_sum = np.broadcast_to(xa.sum(0), stj.shape)
    else:
        abs_sum = np.zeros_like(stj)
    _assert_stats(stt, stj, abs_sum)


def test_tile_study_dma_only_matches_tpu_kernel(rng, jax_studies, interpret):
    """Kernel C's plain version against the TPU tile study's dma_only
    kernel (benchmarks/kernel_tile_study.py variant)."""
    _, jts = jax_studies
    n, f, k, tile = 2048, 128, 8, 512
    x = rng.standard_normal((n, f)).astype(np.float32)
    phi = (rng.standard_normal((f, 2 * k)) * 0.01).astype(np.float32)
    log_w = np.zeros(k, np.float32)
    valid = np.ones(n, bool)
    lj, sj, stj = jts.variant(7, jnp.asarray(x),
                              jnp.asarray(valid.reshape(-1, 128)),
                              jnp.asarray(phi), jnp.asarray(log_w),
                              k_slots=k, tile=tile, vmem_mb=64,
                              stats_prec="split2", dma_only=True)
    lt, st_, stt = tts.variant(7, *_t(x, valid, phi, log_w), tile=tile,
                               mode="dma_only")
    assert not lt.any() and not st_.any()
    # the TPU kernel zeroes the first tile's label streams only
    for stream in (np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)):
        assert not np.nan_to_num(stream).any()
        assert np.isnan(stream[tile:]).all()
    abs_sum = np.zeros((2 * k, f))
    abs_sum[0] = np.abs(x).sum(0)
    _assert_stats(stt.numpy(), np.asarray(stj), abs_sum)
    np.testing.assert_allclose(
        stk.column_sum(torch.from_numpy(x), torch.empty((3, f))).numpy(),
        np.broadcast_to(stt[0].numpy(), (3, f)))


@pytest.mark.parametrize("tile", [512, 1024])
def test_tile_study_full_matches_pallas_fused_assign(rng, tile):
    """The study's full mode is kernel A "precomputed" at hash tile T: its
    plain version against the Pallas kernel at the same T (the TPU study's
    own full modes build pallas_sweep._kernel without ``direct_lr`` and
    raise)."""
    n, f, k = 2048, 128, 8
    x = rng.standard_normal((n, f)).astype(np.float32)
    phi = (rng.standard_normal((f, 2 * k)) * 0.01).astype(np.float32)
    log_w = np.zeros(k, np.float32)
    valid = np.arange(n) < n - 100
    seed = 31337
    lj, sj, stj = ps.fused_assign(
        seed, jnp.asarray(x), jnp.asarray(valid.reshape(-1, 128)),
        jnp.asarray(phi), jnp.asarray(log_w), 0, k_slots=k,
        family_name="precomputed", tile=tile, interpret=True,
        ll_precision="highest", stats_precision="highest")
    lt, st_, stt = tts.variant(seed, *_t(x, valid, phi, log_w), tile=tile,
                               mode="full")
    lj, sj = np.asarray(lj).reshape(-1), np.asarray(sj).reshape(-1)
    # soft labels of tiny logits: the noise decides, and it is bit-exact
    assert (lt.numpy() == lj).mean() >= 0.999
    assert (st_.numpy() == sj).mean() >= 0.999
    np.testing.assert_allclose(stt.numpy(), np.asarray(stj), rtol=1e-4,
                               atol=1e-3)
    # the hash tile is a parameter of the noise: at 3T the first T rows
    # keep their draws (same tile index and counters), the others change
    other = tts.variant(seed, *_t(x, valid, phi, log_w), tile=3 * tile,
                        mode="full")[0].numpy()
    lt = lt.numpy()
    assert (other[:tile] == lt[:tile]).all()
    assert (other[tile:] != lt[tile:]).mean() > 0.5


def test_stage_sets_follow_the_tpu_kernels_precedence():
    """Kernel D takes the ablation's 8 stage sets, in any order, on every
    device, and refuses any other set."""
    assert [stk.stage_key(s) for _, s in tka.VARIANTS] == [
        "dma_only", "dot_only", "none", "stats_raw", "stats", "stats+gumbel",
        "stats+gumbel+sub", "stats+gumbel+sub+write"]
    assert stk.stage_key(("sub", "stats", "gumbel")) == "stats+gumbel+sub"
    x, valid, phi, log_w, loglrw = _t(*_ablate_inputs(
        np.random.default_rng(0), n=256))
    for stages in (("write", "dma_only"), ("stats_raw", "stats"),
                   ("gumbel",), ("bogus",)):
        with pytest.raises(ValueError, match="built for the stage sets"):
            stk.kernel_ablate(x, valid, phi, log_w, loglrw, 1, stages=stages)


def test_study_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the CUDA kernel or raises."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="expected cuda"):
        stk.column_sum(meta(256, 15))
    args = (meta(256, 15), meta(256, dtype=torch.bool), meta(15, 12),
            meta(4), meta(2, 4), 1)
    with pytest.raises(ValueError, match="expected cuda"):
        stk.kernel_ablate(*args, stages=("stats",))
    with pytest.raises(ValueError, match="built for the stage sets"):
        stk.kernel_ablate(*args, stages=("gumbel",))
    with pytest.raises(ValueError, match="3K <= F"):
        stk.kernel_ablate(meta(256, 8), *args[1:], stages=("dot_only",))


def test_cta_points_is_a_cache_only_option(rng):
    """Kernel A's other block sizes are the f32 cache's at K <= 128; on the
    CPU the plain version ignores the block size."""
    x, valid, phi, log_w, _ = _ablate_inputs(rng, n=256, k=8)
    args = _t(x, valid, phi[:, :16], log_w)
    want = sk.fused_assign(*args, 5)
    for cta in (64, 256):
        for a, b in zip(sk.fused_assign(*args, 5, cta_points=cta), want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cta_points"):
        sk.fused_assign(*args, 5, cta_points=48)
    with pytest.raises(ValueError, match="cta_points"):
        sk.fused_assign(*args, 5, family_name="gaussian", cta_points=64)
    assert "precomputed cta=64" in sk.fused_assign.launches


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and prof is not None
    assert "aten::mm" in files[0].read_text()


def test_median_ms_and_card_on_the_cpu():
    calls = []
    ms = profiling.median_ms(lambda: calls.append(1), "cpu", reps=3)
    assert ms >= 0.0 and len(calls) == 4      # one warm-up
    assert profiling.card("cpu") == "cpu"


def test_bench_prints_its_json_line_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_SMALL", "1")
    run = bench.run      # the small config at a rehearsal's point count
    monkeypatch.setattr(bench, "run", lambda *a, **kw: run(*a, **kw, n=1500))
    out = bench.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "k",
                         "ms_per_sweep", "device"}
    assert line["metric"] == "gibbs_sweep_throughput_1Mx32d"
    assert line["unit"] == "points/s" and line["device"] == "cpu"
    assert line["value"] > 0 and 1 <= line["k"] <= 32


def test_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run("cuda", small=True, n=100)


def test_study_mains_rehearse_on_the_cpu(capsys):
    rows = tts.main(["4096", "2", "8", "--device", "cpu", "--reps", "1"])
    assert len(rows) == 4 * 4       # 4 tiles x (dma_only + 3 block sizes)
    assert {r["cta_points"] for r in rows} == {None, 64, 128, 256}
    rows = tka.main(["2048", "4", "4", "--device", "cpu", "--reps", "1"])
    assert len(rows) == 8 + 8
    assert [r["variant"] for r in rows[8:]] == [v[0] for v in tka.VARIANTS]
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 32 and all(json.loads(p)["ms"] >= 0
                                      for p in printed)
