"""Checkpoints across the two packages on the CPU: the port writes the JAX
package's file format (the same npz keys, dtypes and shapes, plus its own
generator state), each package's ``load_checkpoint`` reads the other's
files into equal tables, a JAX checkpoint resumes in the port and a port
checkpoint in the JAX package, and on one loaded table the port's
``predict``, ``cluster_params``, ``cluster_statistics`` and
``log_posterior`` agree with the JAX package's.

Tolerances: integer outputs (labels, steps, keys) exactly; deterministic
float32 math to ``rtol=1e-5, atol=1e-6``; sampled runs to the 4-corner
K / NMI gates."""
import torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from dpmmsubclusters_tpu.io import checkpoint as jck  # noqa: E402
from dpmmsubclusters_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from dpmmsubclusters_tpu.sampler.driver import DPMMEngine  # noqa: E402
from dpmmsubclusters_tpu_torch.interop import table_from_jax  # noqa: E402
from dpmmsubclusters_tpu_torch.io import checkpoint as tck  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CORNERS = dict(alpha=100.0, burnout=5, verbose=False, seed=11)
GEN_KEY = "torch_generator_cpu"


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


def saving(d) -> dict:
    return dict(iters=40, enable_saving=True, model_save_interval=20,
                save_path=f"{d}/", save_file_prefix="checkpoint_")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same 4-corner config fitted for 40 sweeps by each package, saving
    at 20 and 40: ``{"jax": path of sweep 20, "port": ...}``."""
    x, gt = four_corners()
    jd = tmp_path_factory.mktemp("jax")
    td = tmp_path_factory.mktemp("port")
    jdpmm.fit(x, **saving(jd), **CORNERS)
    tdpmm.fit(x, device="cpu", **saving(td), **CORNERS)
    return {"jax": f"{jd}/checkpoint_20.npz",
            "port": f"{td}/checkpoint_20.npz", "x": x, "gt": gt}


def npz_layout(path) -> dict:
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files
                if k != "meta"}


def test_port_file_has_the_jax_format(files):
    """Every array of a JAX checkpoint is in the port's, with its dtype and
    shape, and the port adds only its generator state; ``meta`` carries
    the same config keys, family and version."""
    want = npz_layout(files["jax"])
    got = npz_layout(files["port"])
    gen = got.pop(GEN_KEY)
    assert gen[0] == np.uint8 and gen[1] == (
        torch.Generator().get_state().numel(),)
    assert got == want
    j, t = jck.load_checkpoint(files["jax"]), tck.load_checkpoint(
        files["port"])
    assert (set(dataclasses.asdict(t["config"]))
            == set(dataclasses.asdict(j["config"])))
    assert (t["family"], t["version"]) == (j["family"], j["version"])
    assert j["step"] == t["step"] == 20
    assert t["generator"].keys() == {"cpu"} and j.get("generator") is None


def assert_same_tables(a, b):
    ta, tb = table_from_jax(a), table_from_jax(b)

    def walk(x, y, path=""):
        assert x.keys() == y.keys(), path
        for k in x:
            if isinstance(x[k], dict):
                walk(x[k], y[k], f"{path}/{k}")
            else:
                assert x[k].dtype == y[k].dtype, f"{path}/{k}"
                assert torch.equal(x[k], y[k]), f"{path}/{k}"

    walk(ta, tb)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_other_file(files, writer):
    """``load_checkpoint`` of both packages reads one file into equal
    tables, label streams, step, shift, scale, key and config."""
    j = jck.load_checkpoint(files[writer])
    t = tck.load_checkpoint(files[writer])
    assert_same_tables(j["table"], t["table"])
    for name in ("labels", "sublabels", "key", "shift", "scale"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    assert t["labels"].dtype == j["labels"].dtype == np.int32
    for name in ("step", "n_points", "family", "version"):
        assert t[name] == j[name], name
    assert dataclasses.asdict(t["config"]) == dataclasses.asdict(j["config"])


def test_port_key_is_a_jax_key():
    """The key the port writes is ``jax.random.PRNGKey(seed)`` at step 0,
    and :func:`seed_from_key` inverts it at every step."""
    for seed in (0, 11, 2**31 - 1):
        np.testing.assert_array_equal(
            tck.jax_key(seed, 0), np.asarray(jax.random.PRNGKey(seed)))
        for step in (0, 20, 1000):
            assert tck.seed_from_key(tck.jax_key(seed, step), step) == seed


def models_of(path):
    """The JAX and the port model of one checkpoint, before any resume."""
    j = jck.load_checkpoint(path)
    t = tck.load_checkpoint(path)
    jm = jdpmm.DPMMModel(
        family=jdpmm.GAUSSIAN, table=j["table"], shift=j["shift"],
        cfg=j["config"], n_points=j["n_points"], labels_raw=j["labels"],
        sublabels=j["sublabels"], key=j["key"], step=j["step"],
        scale=j["scale"])
    tm = tdpmm.DPMMModel(
        family=tdpmm.GAUSSIAN, table=table_from_jax(t["table"]),
        shift=t["shift"], cfg=t["config"], n_points=t["n_points"],
        labels_raw=t["labels"], sublabels=t["sublabels"], step=t["step"],
        scale=t["scale"])
    return jm, tm


def ll_reference(model, x, labels):
    """Each cluster's average log-likelihood of its points in float64 from
    the model's float32 phi, and the float32 rounding bound of the
    ``features @ phi.T`` product it averages: F * 2^-24 * sum |feature *
    phi| (the standard bound of an F-term dot product), averaged alike."""
    slots = torch.as_tensor(model.active_slots)
    phi = model.table["params"]["phi"][slots, 0].double().numpy()
    xs = (np.asarray(x, np.float64) - model.shift) * model._scale
    feat = model.family.features(torch.as_tensor(xs)).numpy()
    ll = feat @ phi.T
    size = np.abs(feat) @ np.abs(phi).T
    bound = feat.shape[1] * 2.0**-24 * size
    avg = np.array([ll[labels == c, c].mean() for c in range(model.k)])
    tol = np.array([bound[labels == c, c].mean() for c in range(model.k)])
    return avg + np.log(model._scale).sum(), tol


def assert_same_model_outputs(jm, tm, x, probs=True):
    """predict, cluster_params, cluster_statistics and log_posterior of two
    models on one table: labels exactly (also on points scattered between
    the clusters) and the rest to the tolerance, with two exceptions that
    float32 rounding forces.

    * ``probs=False``: the probabilities are not held where the logits
      reach -100 and beyond (the multinomial table), since one float32 ulp
      of such a logit (7.6e-6) moves a probability by more than atol.
    * The average log-likelihood of ``cluster_statistics`` sums float32
      products that cancel (at the 4 exact corners the summands reach
      5000 for a result near 0.2), so each package is held to the float32
      rounding bound of that product around the float64 value
      (:func:`ll_reference`); its responsibilities and counts to the
      tolerance."""
    tl, tp = tm.predict(x)
    jl, jp = jm.predict(x)
    np.testing.assert_array_equal(tl, jl)
    if probs:
        np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL)
    scattered = x + np.random.default_rng(1).normal(0, 4, x.shape).astype(
        np.float32)
    np.testing.assert_array_equal(tm.predict(scattered, False)[0],
                                  jm.predict(scattered, False)[0])
    jps, tps = jm.cluster_params(), tm.cluster_params()
    assert len(tps) == len(jps) == tm.k
    for a, b in zip(tps, jps):
        assert a["slot"] == b["slot"]
        for name in ("mu", "cov", "weight", "log_p"):
            if name in b:
                np.testing.assert_allclose(a[name], b[name], rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        assert a["posterior"].keys() == b["posterior"].keys()
        for name, v in b["posterior"].items():
            np.testing.assert_allclose(a["posterior"][name], v, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tm.labels, jm.labels)
    t_ll, t_resp = tm.cluster_statistics(x, tm.labels)
    j_ll, j_resp = jm.cluster_statistics(x, jm.labels)
    np.testing.assert_allclose(t_resp, j_resp, rtol=RTOL, atol=ATOL)
    ref, tol = ll_reference(tm, x, tm.labels)
    assert np.all(np.abs(t_ll - ref) <= tol), (t_ll, ref, tol)
    assert np.all(np.abs(j_ll - ref) <= tol), (j_ll, ref, tol)
    np.testing.assert_allclose(tm.log_posterior(), jm.log_posterior(),
                               rtol=RTOL)


def test_jax_file_resumes_in_the_port(files, tmp_path):
    """Before the resume the port's model of a JAX checkpoint answers as the
    JAX model does; the resume (saving on, so the per-sweep path) reaches
    the 4-corner gates and writes its own checkpoints."""
    x, gt = files["x"], files["gt"]
    jm, tm = models_of(files["jax"])
    assert_same_model_outputs(jm, tm, x)
    res = tdpmm.run_from_checkpoint(files["jax"], x, iters=60, device="cpu",
                                    save_path=f"{tmp_path}/")
    assert len(res.history.k) == 40 and res.model.step == 60
    assert res.k == 4 and tdpmm.nmi(gt, res.labels) == 1.0
    pred, _ = res.predict(x)
    np.testing.assert_array_equal(pred, res.labels)
    assert tck.load_checkpoint(f"{tmp_path}/checkpoint_60.npz")["step"] == 60


def test_port_file_resumes_in_jax(files):
    """A port checkpoint resumes in ``dpmmsubclusters_tpu`` and reaches the
    4-corner gates."""
    x, gt = files["x"], files["gt"]
    res = jdpmm.run_from_checkpoint(files["port"], x, iters=60,
                                    verbose=False, enable_saving=False)
    assert len(res.history.k) == 40
    assert res.k == 4 and jdpmm.nmi(gt, res.labels) == 1.0


def test_multinomial_model_outputs_match():
    """The multinomial branch of ``cluster_params`` (``log_p``), and
    ``predict`` / ``cluster_statistics`` / ``log_posterior`` of a JAX
    multinomial ``init_state`` table, agree across the packages."""
    x, _, _ = jdpmm.generate_mnmm_data(1_000, 12, 3, 40, seed=5)
    cfg = jdpmm.DPMMConfig(k_max=16, init_clusters=3, burnout=5,
                           verbose=False, precompute_features=False)
    engine = DPMMEngine(jdpmm.MULTINOMIAL, cfg, make_data_mesh(1))
    points, valid, _ = engine.shard_points(x)
    state = engine.init_state(jax.random.PRNGKey(3), points, valid,
                              jdpmm.MULTINOMIAL.default_prior(12))
    table = jax.tree.map(np.asarray, jax.device_get(state.table))
    labels = np.asarray(state.labels).reshape(-1)[:len(x)]
    sub = np.asarray(state.sublabels).reshape(-1)[:len(x)]
    common = dict(shift=np.zeros(12, np.float32), n_points=len(x),
                  labels_raw=labels, sublabels=sub, step=0)
    jm = jdpmm.DPMMModel(family=jdpmm.MULTINOMIAL, table=table, cfg=cfg,
                         key=np.asarray(jax.random.PRNGKey(3)), **common)
    tcfg = tdpmm.DPMMConfig(**dataclasses.asdict(cfg))
    tm = tdpmm.DPMMModel(family=tdpmm.MULTINOMIAL,
                         table=table_from_jax(table), cfg=tcfg, **common)
    assert tm.k == 3 and "log_p" in tm.cluster_params()[0]
    assert_same_model_outputs(jm, tm, x, probs=False)
