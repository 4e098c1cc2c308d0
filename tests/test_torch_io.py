"""The port's npy loader (tests/test_io.py's three cases against
``dpmmsubclusters_tpu_torch.io.npy.load_data``), and the port's
independence from JAX: no module of the port, and not chip_smoke.py,
imports ``jax`` or ``dpmmsubclusters_tpu``."""
import torch_threads  # noqa: F401

import ast
import pathlib

import numpy as np
import pytest

from dpmmsubclusters_tpu_torch.io import npy
from dpmmsubclusters_tpu_torch.io.npy import load_data

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("swap", [False, True])
def test_load_data_scrub_and_layout(tmp_path, rng, dtype, swap):
    shape = (1000, 8)
    a = (rng.normal(size=shape) * 10).astype(dtype)
    if np.issubdtype(dtype, np.floating):
        a[0, 0] = np.nan
    np.save(tmp_path / "d.npy", a)
    got = load_data(str(tmp_path / "d.npy"), swapdims=swap)
    want = np.nan_to_num(a.astype(np.float32), nan=0.0)
    if swap:
        want = want.T
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want)


@pytest.mark.parametrize("swap", [False, True])
def test_load_data_native_path(tmp_path, rng, swap):
    """A file past the 4 MiB threshold goes through the native OpenMP
    loader, found or built; skipped only when it can be neither."""
    if npy._native_lib() is None:
        pytest.skip("native/libdpmmfastload.so can neither be found nor "
                    "built here")
    a = rng.normal(size=(300_000, 8)).astype(np.float64)
    a[5, 3] = np.nan
    np.save(tmp_path / "big.npy", a)
    with open(tmp_path / "big.npy", "rb") as f:
        descr, fortran, shape, _ = npy._parse_npy_header(f)
    assert (descr, fortran, shape) == ("<f8", False, (300_000, 8))
    got = load_data(str(tmp_path / "big.npy"), swapdims=swap)
    want = np.nan_to_num(a.astype(np.float32), nan=0.0)
    np.testing.assert_allclose(got, want.T if swap else want)


def test_load_data_prefix_convention(tmp_path, rng):
    a = rng.normal(size=(50, 3)).astype(np.float32)
    np.save(tmp_path / "mydata.npy", a)
    got = load_data(str(tmp_path) + "/", prefix="mydata")
    np.testing.assert_allclose(got, a)


def _imports(path: pathlib.Path):
    """Top-level module names a file imports (absolute imports only)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "dpmmsubclusters_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "dpmmsubclusters_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad
