"""Saving and resuming in the port on the CPU: ``fit(enable_saving=True)``,
``run_from_checkpoint`` continuing the same chain, the per-sweep path of
``run_loop`` that ``verbose`` or a callback selects (and the fused-block
path that runs otherwise), the resume's refusals, and mirrors of the JAX
package's checkpoint tests (tests/test_fit_e2e.py, tests/test_tiering.py,
tests/test_validation.py)."""
import torch_threads  # noqa: F401

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu_torch import DPMMConfig  # noqa: E402
from dpmmsubclusters_tpu_torch.io import checkpoint as tck  # noqa: E402
from dpmmsubclusters_tpu_torch.sampler import driver  # noqa: E402

CORNERS = dict(alpha=100.0, burnout=5, verbose=False, device="cpu")


def four_corners(n=1000):
    """1000 points at 4 exact corners (reference test/module_tests.jl:1-8)."""
    x = np.zeros((n, 2), np.float32)
    labels = np.zeros(n, np.int64)
    corners = np.array([[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0],
                        [-10.0, -10.0]])
    for i in range(4):
        x[i * (n // 4):(i + 1) * (n // 4)] = corners[i]
        labels[i * (n // 4):(i + 1) * (n // 4)] = i
    return x, labels


def saving(d, iters=40, every=20) -> dict:
    return dict(iters=iters, enable_saving=True, model_save_interval=every,
                save_path=f"{d}/", save_file_prefix="checkpoint_")


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_fit_e2e.py::test_checkpoint_roundtrip on the port: save
    mid-run, resume, finish (reference test/module_tests.jl:49-60).  Smart
    splits are on (the default), so the resume is held to gates: the
    per-sweep path refreshes newborn slots before each sweep after the
    first, and a resume starts at its first sweep without the refresh the
    uninterrupted run makes there."""
    x, gt = four_corners()
    tdpmm.fit(x, seed=11, **saving(tmp_path), **CORNERS)
    res2 = tdpmm.run_from_checkpoint(f"{tmp_path}/checkpoint_20.npz", x,
                                     iters=60, verbose=False, device="cpu")
    assert res2.k >= 2
    assert len(res2.history.k) == 40  # iters 20..60
    assert tdpmm.nmi(gt, res2.labels) > 0.9
    res3 = tdpmm.run_from_checkpoint(f"{tmp_path}/checkpoint_40.npz", x,
                                     iters=100, device="cpu",
                                     enable_saving=False)
    assert res3.k == 4 and tdpmm.nmi(gt, res3.labels) == 1.0
    np.testing.assert_array_equal(res3.predict(x)[0], res3.labels)


@pytest.mark.parametrize("feature_dtype", ["float32", "hybrid"])
def test_resume_continues_the_same_chain(tmp_path, feature_dtype):
    """With ``smart_splits=False`` (a real config, and one in which the
    per-sweep path has no refresh that a resume skips at its first sweep)
    ``fit(iters=40)`` saving at 20, then ``run_from_checkpoint`` of sweep 20
    to 40, gives the uninterrupted run's labels, sub-labels, table and
    ``hist.k`` for sweeps 20-40, bit for bit: the file carries the
    generator's state, and the bf16 cache is rebuilt from the same seed."""
    x, _, _, _ = tdpmm.generate_gaussian_data(1500, 3, 5, 60.0, seed=3)
    whole = tdpmm.fit(x, seed=7, smart_splits=False,
                      feature_dtype=feature_dtype, precompute_features=True,
                      **saving(tmp_path), **{**CORNERS, "alpha": 10.0})
    res = tdpmm.run_from_checkpoint(f"{tmp_path}/checkpoint_20.npz", x,
                                    iters=40, device="cpu")
    assert res.history.k == whole.history.k[20:]
    np.testing.assert_array_equal(res.model.labels_raw,
                                  whole.model.labels_raw)
    np.testing.assert_array_equal(res.model.sublabels,
                                  whole.model.sublabels)
    for name in ("log_weights", "active"):
        assert torch.equal(res.model.table[name], whole.model.table[name])
    assert torch.equal(res.model.table["params"]["phi"],
                       whole.model.table["params"]["phi"])
    np.testing.assert_array_equal(res.model.gen_state, whole.model.gen_state)
    # the resume wrote its own sweep-40 file, equal to the fit's
    a = tck.load_checkpoint(f"{tmp_path}/checkpoint_40.npz")
    np.testing.assert_array_equal(a["labels"], whole.model.labels_raw)


def test_file_without_generator_state_reseeds(tmp_path):
    """A file without the port's generator state (as the JAX package writes
    them) resumes from a generator seeded by the key and the step: two
    resumes give the same labels."""
    x, _ = four_corners(400)
    res = tdpmm.fit(x, seed=5, iters=20, **CORNERS)
    path = str(tmp_path / "m.npz")
    res.model.save(path)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if not k.startswith(
            "torch_generator_")}
    np.savez(path, **payload)
    ck = tck.load_checkpoint(path)
    assert ck["generator"] == {}
    gen = tck.restore_generator(ck, "cpu")
    assert gen.initial_seed() == tck.reseed(ck["key"], 20)
    runs = [tdpmm.run_from_checkpoint(path, x, iters=30, verbose=False,
                                      device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(runs[0].labels, runs[1].labels)
    assert runs[0].history.k == runs[1].history.k


def test_verbose_takes_the_per_sweep_path(capsys):
    """``verbose=True`` gives one ``hist`` entry and one printed line for
    each sweep."""
    x, _ = four_corners(400)
    res = tdpmm.fit(x, seed=1, iters=12, **{**CORNERS, "verbose": True})
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("iter ")]
    assert [ln.split(":")[0] for ln in lines] == [
        f"iter {i}" for i in range(1, 13)]
    assert all(f"K={k} " in ln for ln, k in zip(lines, res.history.k))
    h = res.history
    assert len(h.k) == len(h.times) == len(h.log_posterior) == 12


def engine_and_state(cfg: DPMMConfig, x):
    engine = driver.DPMMEngine(tdpmm.GAUSSIAN, cfg, "cpu")
    points, valid, n_total = engine.shard_points(x)
    points = engine.featurize(points)
    state = engine.init_state(torch.Generator().manual_seed(0), points,
                              valid, tdpmm.GAUSSIAN.default_prior(2))
    return engine, state, points, valid, n_total


def test_run_loop_paths(monkeypatch):
    """A callback selects the per-sweep path: it sees ``it = first_iter ..
    iters - 1`` after each sweep, and the smart refresh runs before each
    sweep with ``first_iter < it <= iters - split_stop``, as in the JAX
    package.  Without verbose or a callback the fused-block path runs
    (blocks of ``fused_block`` sweeps, no per-sweep refresh)."""
    x, _ = four_corners(400)
    x = (x - x.mean(0)) / x.std(0)
    cfg = DPMMConfig(k_max=16, burnout=5, verbose=False, split_stop=3,
                     fused_block=4, precompute_features=True)
    engine, state, points, valid, n_total = engine_and_state(cfg, x)
    refreshed, blocks = [], []
    refresh = engine.smart_refresh
    step_block = engine.step_block

    def spy_refresh(st, *a):
        refreshed.append(st.step)
        return refresh(st, *a)

    def spy_block(st, pts, v, n, finals, nms):
        blocks.append(len(finals))
        return step_block(st, pts, v, n, finals, nms)

    monkeypatch.setattr(engine, "smart_refresh", spy_refresh)
    monkeypatch.setattr(engine, "step_block", spy_block)
    seen = []
    state.step = 2
    out, hist = driver.run_loop(
        engine, state, points, valid, n_total, 12, first_iter=2,
        callback=lambda it, st, m: seen.append((it, st.step, int(m["k"]))))
    assert [s[0] for s in seen] == list(range(2, 12))
    assert [s[1] for s in seen] == list(range(3, 13))
    assert hist.k == [s[2] for s in seen]
    assert refreshed == list(range(3, 10))     # it = 3 .. 12 - 3
    assert blocks == []
    out, hist = driver.run_loop(engine, out, points, valid, n_total, 22,
                                first_iter=12)
    assert blocks == [4, 4, 2] and len(hist.k) == 10
    assert refreshed == list(range(3, 10))


def small_fit(tmp_path, **kw):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (500, 2)).astype(np.float32)
    r = tdpmm.fit(x, alpha=10.0, iters=10, seed=0, verbose=False, k_max=4,
                  burnout=3, device="cpu", **kw)
    path = str(tmp_path / "ck.npz")
    r.model.save(path)
    return x, r, path


def test_resume_wrong_size_data_rejected(tmp_path):
    """tests/test_validation.py::test_resume_wrong_size_data_rejected on the
    port: the checkpoint's label stream refers to specific rows."""
    x, _, path = small_fit(tmp_path)
    with pytest.raises(ValueError, match="trained on 500 points"):
        tdpmm.run_from_checkpoint(path, x[:400], iters=12, verbose=False,
                                  device="cpu")
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdpmm.run_from_checkpoint(path, x, iters=12)


def rewrite_meta(path, edit):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["meta"].tobytes()).decode())
    edit(meta["config"])
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


def test_checkpoint_tolerates_unknown_config_keys(tmp_path):
    """tests/test_validation.py::test_checkpoint_tolerates_unknown_config_keys
    on the port: a file written by a version with an extra config field
    loads with a warning, and the resumed run works."""
    x, _, path = small_fit(tmp_path)
    rewrite_meta(path, lambda c: c.update(some_future_knob=42))
    with pytest.warns(UserWarning, match="some_future_knob"):
        out = tck.load_checkpoint(path)
    assert isinstance(out["config"], DPMMConfig)
    assert out["version"] == tck.FORMAT_VERSION
    with pytest.warns(UserWarning, match="some_future_knob"):
        res2 = tdpmm.run_from_checkpoint(path, x, iters=14, device="cpu")
    assert res2.model.step == 14


def test_checkpoint_missing_key_defaults(tmp_path):
    """tests/test_validation.py::test_checkpoint_missing_key_defaults on the
    port: a file written before a config field existed loads with the
    current default, and a table without ``needs_smart`` gets it cleared."""
    _, _, path = small_fit(tmp_path)
    rewrite_meta(path, lambda c: c.pop("track_posterior"))
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if k != "table//needs_smart"}
    np.savez(path, **payload)
    out = tck.load_checkpoint(path)
    assert out["config"].track_posterior == DPMMConfig().track_posterior
    assert not out["table"]["needs_smart"].any()
    assert out["table"]["needs_smart"].shape == out["table"]["active"].shape


def test_resume_below_the_live_clusters_refused(tmp_path):
    """The JAX package's resume with ``max_clusters`` (or a fixed ``k_max``)
    below the checkpoint's live K shrinks the table under them and drops
    clusters (ROADMAP R1).  The port refuses it by name; at the live K it
    resumes and keeps every cluster."""
    x, gt, _, _ = tdpmm.generate_gaussian_data(2000, 2, 6, 200.0, seed=0)
    res = tdpmm.fit(x, alpha=10.0, iters=60, seed=2, verbose=False,
                    burnout=3, device="cpu", k_max=32)
    live = res.k
    assert live >= 4
    path = str(tmp_path / "ck.npz")
    res.model.save(path)
    kw = dict(iters=62, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="drop clusters.*max_clusters"):
        tdpmm.run_from_checkpoint(path, x, max_clusters=live - 1, **kw)
    with pytest.raises(ValueError, match="drop clusters.*k_max"):
        tdpmm.run_from_checkpoint(path, x, k_max=live - 1, auto_tier=False,
                                  **kw)
    with pytest.raises(ValueError, match="drop clusters.*tier ceiling"):
        tdpmm.run_from_checkpoint(path, x, k_max=live - 1, auto_tier=True,
                                  **kw)
    res2 = tdpmm.run_from_checkpoint(path, x, max_clusters=live, **kw)
    assert res2.k == live


def test_checkpoint_roundtrip_across_tiers(tmp_path):
    """tests/test_tiering.py::test_checkpoint_roundtrip_across_tiers on the
    port: a checkpoint saved at one capacity tier resumes at another."""
    rng = np.random.default_rng(1)
    means = rng.standard_normal((4, 3)).astype(np.float32) * 10
    lab = rng.integers(0, 4, 2000)
    x = means[lab] + rng.standard_normal((2000, 3)).astype(np.float32)
    res = tdpmm.fit(x, alpha=10.0, iters=30, seed=4, k_max=16,
                    auto_tier=True, verbose=False, burnout=5, device="cpu")
    p = str(tmp_path / "tier_ck.npz")
    res.model.save(p)
    assert res.model.table["active"].shape[0] == 16
    res2 = tdpmm.run_from_checkpoint(p, x, iters=40, k_max=32,
                                     auto_tier=False, verbose=False,
                                     device="cpu")
    assert res2.k >= 1
    assert res2.model.table["active"].shape[0] == 32
