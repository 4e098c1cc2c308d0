"""The port's multi-process checkpoints, resume, re-shard and CLI on the
CPU, with two gloo ranks in subprocesses (``tests/torch_dist_worker.py``,
120 s a test), and their files across the two packages: mirrors of the JAX
package's ``tests/test_multiprocess.py::test_two_process_save_kill_resume``
and ``::test_distributed_cli``, plus the port's two-rank files resumed by
the JAX package's ``run_from_checkpoint_distributed`` (a re-shard onto one
process), a JAX ``fit_distributed`` file resumed by two port ranks, and
the global centering and standardization moments against the JAX
package's.

Tolerances: integer outputs exactly; the moments at rtol 1e-6 (float32
sums in the JAX package, float64 in the port); sampled runs to the
4-corner gates (K=4, NMI >= 0.999)."""
import torch_threads  # noqa: F401

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import dpmmsubclusters_tpu as jdpmm  # noqa: E402
import dpmmsubclusters_tpu_torch as tdpmm  # noqa: E402
from torch_dist_worker import run_ranks, spawn  # noqa: E402

CORNERS = dict(alpha=100.0, seed=6, burnout=5, verbose=False)
SPLIT = (300, 700)      # rank 0 padded to 512 rows


def four_corners(n=1000):
    """n points at 4 exact corners (reference test/module_tests.jl:1-8)."""
    x = np.zeros((n, 2), np.float32)
    labels = np.zeros(n, np.int64)
    corners = np.array([[10.0, 10.0], [-10.0, 10.0], [10.0, -10.0],
                        [-10.0, -10.0]])
    for i in range(4):
        x[i * (n // 4):(i + 1) * (n // 4)] = corners[i]
        labels[i * (n // 4):(i + 1) * (n // 4)] = i
    return x, labels


def saving(d, prefix="dist_") -> dict:
    return dict(enable_saving=True, model_save_interval=40,
                save_path=f"{d}/", save_file_prefix=prefix)


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    """Two port ranks (300 / 700 rows) fit 40 sweeps of the 4 corners and
    save at 40: the master file's path and the run's directory."""
    d = tmp_path_factory.mktemp("port2")
    x, _ = four_corners()
    spawn(d, x, SPLIT, iters=40, **CORNERS, **saving(d))
    return f"{d}/dist_40.npz", d


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's single-process ``fit_distributed`` of the same
    config, saving at 40: the master file's path."""
    d = tmp_path_factory.mktemp("jax1")
    x, _ = four_corners()
    jdpmm.fit_distributed(x, iters=40, **CORNERS, **saving(d))
    return f"{d}/dist_40.npz"


def _layout(path) -> dict:
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files if k != "meta"}


def test_rank_files_have_the_jax_layout(port_files, jax_files):
    """Rank 0 writes the master file (rank 0's labels, every rank's
    ``n_points``, the port's generator state beside the JAX key) and each
    rank its shard, with the JAX package's keys and dtypes."""
    path, _ = port_files
    for i, n in enumerate(SPLIT):
        with np.load(f"{path}.shard{i}.npz") as z:
            assert (int(z["process"]), int(z["num_processes"]),
                    int(z["n_local"]), int(z["step"])) == (i, 2, n, 40)
            assert len(z["labels"]) == n
    want = _layout(f"{jax_files}.shard0.npz")
    got = _layout(f"{path}.shard0.npz")
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in
                                                 want.items()}
    ck = tdpmm.load_checkpoint(path)
    assert ck["n_points"] == 1000 and len(ck["labels"]) == SPLIT[0]
    assert set(ck["generator"]) == {"cpu"}
    master = _layout(path)
    master.pop("torch_generator_cpu")
    jmaster = _layout(jax_files)
    assert {k: v[0] for k, v in master.items()} == {
        k: v[0] for k, v in jmaster.items()}
    with pytest.raises(ValueError, match="run_from_checkpoint_distributed"):
        tdpmm.run_from_checkpoint(path, four_corners()[0], device="cpu")


def test_save_kill_resume_and_reshard(port_files, tmp_path):
    """Fresh ranks resume the two-rank file: on the same split, on another
    split of two ranks (a re-shard) and on one process (world of one): K=4
    and NMI >= 0.999 on every rank's rows, 40 more sweeps, equal tables on
    both ranks (the JAX package's ``test_two_process_save_kill_resume``)."""
    path, _ = port_files
    x, gt = four_corners()
    for name, counts in (("same", SPLIT), ("reshard", (512, 488))):
        outs = spawn(tmp_path, x, counts, name=name, ckpt=path, iters=80)
        labels = np.concatenate([o["labels"] for o in outs])
        assert tdpmm.nmi(gt, labels) >= 0.999, name
        for o in outs:
            assert int(o["k"]) == 4 and int(o["step"]) == 80
            assert len(o["hist_k"]) == 40 and len(set(o["digests"])) == 1
    one = tdpmm.run_from_checkpoint_distributed(path, x, iters=80,
                                                device="cpu")
    assert one.k == 4 and one.model.step == 80
    assert tdpmm.nmi(gt, one.labels) >= 0.999
    with pytest.raises(ValueError, match="cover"):
        tdpmm.run_from_checkpoint_distributed(path, x[:900], iters=80,
                                              device="cpu")


def test_distributed_cli_proc_template(tmp_path):
    """``python -m dpmmsubclusters_tpu_torch.run --distributed`` on two
    gloo ranks, each reading its own ``rows{proc}.npy``: a saving fit, then
    ``--resume`` of its sweep-40 file to 80, each printing ``K = 4`` on
    both ranks (the JAX package's ``test_distributed_cli``)."""
    x, _ = four_corners()
    np.save(tmp_path / "rows0.npy", x[:SPLIT[0]])
    np.save(tmp_path / "rows1.npy", x[SPLIT[0]:])
    params = dict(data_path=str(tmp_path / "rows{proc}.npy"), iters=60,
                  **CORNERS, **saving(tmp_path, "cli_"))
    ppath = tmp_path / "params.json"
    ppath.write_text(json.dumps(params))
    for run, extra in (("fit", []), ("resume", [
            "--resume", f"{tmp_path}/cli_40.npz", "--iters", "80"])):
        outs = run_ranks([
            ["-m", "dpmmsubclusters_tpu_torch.run", "--distributed",
             "--coordinator", f"file://{tmp_path}/{run}_rendezvous",
             "--num-processes", "2", "--process-id", str(i),
             "--backend", "gloo", "--device", "cpu", *extra, str(ppath)]
            for i in range(2)])
        for out in outs:
            assert "K = 4" in out.splitlines(), (run, out[-1000:])


def test_port_rank_files_resume_in_the_jax_package(port_files):
    """The JAX package's ``run_from_checkpoint_distributed`` resumes the
    port's two-rank files in one process, re-sharding the label stream:
    K=4, NMI >= 0.999."""
    path, _ = port_files
    x, gt = four_corners()
    res = jdpmm.run_from_checkpoint_distributed(path, x, iters=80)
    assert res.k == 4 and res.model.step == 80
    assert jdpmm.nmi(gt, res.labels) >= 0.999


def test_jax_file_resumes_on_two_port_ranks(jax_files, tmp_path):
    """Two port ranks resume the JAX package's single-process
    ``fit_distributed`` file (a re-shard of its one shard; the generator
    reseeded from the JAX key): K=4, NMI >= 0.999, equal tables."""
    x, gt = four_corners()
    outs = spawn(tmp_path, x, SPLIT, ckpt=jax_files, iters=80)
    labels = np.concatenate([o["labels"] for o in outs])
    assert tdpmm.nmi(gt, labels) >= 0.999
    for o in outs:
        assert int(o["k"]) == 4 and len(set(o["digests"])) == 1


def test_global_moments_match_the_jax_package(tmp_path):
    """Centering and standardization over two ranks' rows (and over one
    process's) give the JAX package's ``fit_distributed`` shift and scale
    at rtol 1e-6 (data far from the origin, the regime standardization is
    for)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3000, 3)) * [0.5, 4.0, 20.0]
         + [300.0, -20.0, 1.0]).astype(np.float32)
    kw = dict(alpha=10.0, iters=2, seed=1, burnout=5, verbose=False)
    want = jdpmm.fit_distributed(x, **kw).model
    outs = spawn(tmp_path, x, (1200, 1800), **kw)
    one = tdpmm.fit_distributed(x, device="cpu", **kw).model
    for shift, scale in [(o["shift"], o["scale"]) for o in outs] + [
            (one.shift, one.scale)]:
        np.testing.assert_allclose(shift, want.shift, rtol=1e-6)
        np.testing.assert_allclose(scale, want.scale, rtol=1e-6)
