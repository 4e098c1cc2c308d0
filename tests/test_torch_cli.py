"""The port's reference-named compat surface and its params-file CLI on the
CPU: mirrors of tests/test_config_behaviors.py::
test_compat_reference_named_surface, tests/test_validation.py::
test_params_file_schema_validated and tests/test_fit_e2e.py::
test_params_file_mode, with ``device="cpu"`` / ``--device cpu``."""
import torch_threads  # noqa: F401

import json

import numpy as np
import pytest

from dpmmsubclusters_tpu_torch import compat as DPMMPython
from dpmmsubclusters_tpu_torch import run
from dpmmsubclusters_tpu_torch.run import fit_from_params


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


def test_compat_reference_named_surface(tmp_path):
    """The compat shim exposes the reference's export names
    (src/DPMMSubClusters.jl:36): fit, predict, calculate_posterior,
    save_model, run_model_from_checkpoint, get_labels_histogram, all on
    D x N data with 1-based labels."""
    x_dn, labels1, _, _ = DPMMPython.generate_gaussian_data(
        1200, 2, 3, 100.0, seed=2)
    assert x_dn.shape == (2, 1200) and labels1.min() == 1
    res = DPMMPython.fit_full(x_dn, 10.0, iterations=40, verbose=False,
                              seed=1, burnout=5, device="cpu")
    lp = DPMMPython.calculate_posterior(res)
    assert np.isfinite(lp)
    hist = DPMMPython.get_labels_histogram(res.labels + 1)
    assert sum(c for _, c in hist) == 1200
    path = str(tmp_path / "ck.npz")
    DPMMPython.save_model(res, path)
    lab, clusters, w = DPMMPython.run_model_from_checkpoint(
        path, x_dn, iterations=44, verbose=False, device="cpu")
    assert lab.min() >= 1 and len(clusters) == len(w)
    lab2, _ = DPMMPython.predict(res.model, x_dn)
    assert lab2.min() >= 1


def test_compat_fit_triple_and_multinomial_data():
    """``fit`` returns (1-based labels, per-cluster params, weights) with
    ``mu``/``cov`` in the data space; ``generate_mnmm_data`` is D x N."""
    x_dn, gt1, _, _ = DPMMPython.generate_gaussian_data(
        900, 2, 3, 200.0, seed=4)
    lab, clusters, w = DPMMPython.fit(x_dn, 10.0, iterations=60,
                                      verbose=False, seed=2, burnout=5,
                                      device="cpu")
    assert lab.min() >= 1 and len(clusters) == len(w) == lab.max()
    for i, (c, wi) in enumerate(zip(clusters, w)):
        assert c["mu"].shape == (2,) and c["cov"].shape == (2, 2)
        assert c["weight"] == wi
        members = x_dn.T[lab == i + 1]
        if len(members) > 50:
            np.testing.assert_allclose(c["mu"], members.mean(0), atol=1.0)
    xm, gm, probs = DPMMPython.generate_mnmm_data(300, 6, 2, 30, seed=1)
    assert xm.shape == (6, 300) and gm.min() == 1 and probs.shape == (6, 2)


def test_params_file_schema_validated(tmp_path):
    """Params files fail fast with named errors on unknown keys or a
    missing data_path (the reference silently ignores unused params-file
    globals, src/global_params.jl:39)."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"data_path": "x.npy", "alhpa": 10.0}))
    with pytest.raises(ValueError, match="unknown key.*alhpa"):
        fit_from_params(str(bad), device="cpu")
    nodata = tmp_path / "nodata.json"
    nodata.write_text(json.dumps({"alpha": 10.0}))
    with pytest.raises(ValueError, match="data_path"):
        fit_from_params(str(nodata), device="cpu")


def test_params_file_mode(tmp_path, capsys):
    """JSON params-file mode (reference advanced mode dp_parallel(path),
    src/dp-parallel-sampling.jl:317-334) through ``dp_parallel`` and the
    CLI's ``main``: npy data and a declarative config, then ``--resume``
    extends the run and prints the three result lines."""
    x, gt = four_corners(400)
    np.save(tmp_path / "data.npy", x)
    np.save(tmp_path / "gt.npy", gt)
    params = {
        "data_path": str(tmp_path / "data.npy"),
        "gt_path": str(tmp_path / "gt.npy"),
        "alpha": 100.0,
        "iters": 60,
        "seed": 5,
        "burnout": 5,
        "verbose": False,
        "prior": {
            "kappa": 1.0, "m": [0.0, 0.0], "nu": 5.0,
            "psi": [[1.0, 0.0], [0.0, 1.0]],
        },
    }
    with open(tmp_path / "params.json", "w") as f:
        json.dump(params, f)
    res = fit_from_params(str(tmp_path / "params.json"), device="cpu")
    assert res.k == 4
    assert len(res.history.nmi) == 60
    lab, clusters, _ = DPMMPython.dp_parallel(str(tmp_path / "params.json"),
                                              device="cpu")
    np.testing.assert_array_equal(lab, res.labels + 1)
    assert len(clusters) == 4

    res.model.save(str(tmp_path / "ck.npz"))
    capsys.readouterr()
    run.main(["--resume", str(tmp_path / "ck.npz"), "--iters", "70",
              "--device", "cpu", str(tmp_path / "params.json")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "K = 4"
    assert out[1].startswith("weights = [") and len(
        json.loads(out[1].split(" = ")[1])) == 4
    assert out[2].startswith("log_posterior = ")
    run.main(["--device", "cpu", str(tmp_path / "params.json")])
    assert capsys.readouterr().out.splitlines()[0] == "K = 4"
