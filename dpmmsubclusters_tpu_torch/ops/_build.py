"""Build and load the hand-written CUDA kernels under ``csrc/``.

The sources are compiled at first use by ``nvcc``, one process per source
side by side, and linked into one shared library with a plain C interface,
loaded with ``ctypes``.  The library's name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Output goes to ``dpmmsubclusters_tpu_torch/_build/``
(listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # rows, pairs, d, valid, phi, delta_t, phi_t, precision, log_w, seed,
    # tile_off, hard, tile, n, f, k, warps, labels, sub, partial, stats,
    # stream
    "dpmm_fused_assign": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                          _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # feat, raw, pairs, d, then as dpmm_fused_assign from valid on, without
    # warps
    "dpmm_fused_assign_bf16": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # f, k, planes
    "dpmm_assign_tc_scratch": [_I, _I, _I],
    # rows, pairs, d, labels, sub, valid, n, f, k, scratch, stats, stream
    "dpmm_stats_from_labels": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P,
                               _P],
    # feat, labels, sub, valid, n, f, k, scratch, stats, stream
    "dpmm_stats_from_labels_bf16": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # labels, sub, valid, n, k, order, stream
    "dpmm_stats_key_sort": [_P, _P, _P, _I, _I, _P, _P],
    # n, f, k; n, k
    "dpmm_stats_scratch": [_I, _I, _I],
    "dpmm_stats_order_ints": [_I, _I],
    "dpmm_stats_chunk": [],
    # x, n, f, partial, out, out_rows, stream
    "dpmm_column_sum": [_P, _I, _I, _P, _P, _I, _P],
    # n
    "dpmm_column_partials": [_I],
    # x, valid, phi, log_w, loglrw, seed, tile, n, f, k, stages, sink,
    # labels, sub, partial, stats, stream
    "dpmm_kernel_ablate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P],
    # n, f, k, stages
    "dpmm_ablate_scratch": [_I, _I, _I, _I],
    "dpmm_error_string": [_I],
}
_RESTYPES = {"dpmm_error_string": ctypes.c_char_p,
             "dpmm_ablate_scratch": ctypes.c_longlong,
             "dpmm_stats_scratch": ctypes.c_longlong,
             "dpmm_stats_order_ints": ctypes.c_longlong,
             "dpmm_assign_tc_scratch": ctypes.c_longlong}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (searched PATH and CUDA_HOME): the CUDA kernels of "
        "dpmmsubclusters_tpu_torch are built from csrc/ at first use"
    )


def build(verbose: bool = False, src_dir=CSRC) -> pathlib.Path:
    """Compile ``src_dir/*.cu`` (the kernels of ``csrc/`` by default) into
    ``_build/`` if needed; returns the path of the shared library.  Raises
    ``RuntimeError`` with the compiler's output when nvcc fails."""
    src_dir = pathlib.Path(src_dir)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / f"libdpmm_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent or
    # interrupted build never leaves a partial library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all at once, then one link
        srcs = sorted(src_dir.glob("*.cu"))
        objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for obj, src in zip(objs, srcs)], verbose)
        so = os.path.join(tmp, lib.name)
        _run([[nvcc, *LINK_FLAGS, "-o", so, *objs]], verbose)
        os.replace(so, lib)
    return lib


def _run(cmds, verbose: bool) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
        if verbose:
            print(out, flush=True)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code (a refused
    launch never runs, and a later synchronize would not report it)."""
    if rc != 0:
        err = load().dpmm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({err})")
