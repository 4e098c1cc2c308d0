"""Carry cluster tables, sampler state and feature caches from the JAX
package to the port.

The JAX package keeps the same table layout as dicts of arrays; pass them
here as numpy arrays (``jax.device_get(state.table)``).  Its per-point
streams are lane-blocked ``[N/128, 128]``; the port's are flat ``[N]``.
Its feature caches are padded to a multiple of 128 columns; the port's f32
cache is not, and its bf16 cache's rows lie a multiple of 8 values apart
(its first F columns are the cache).  Nothing here imports ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import sweep_kernels
from .priors import GAUSSIAN
from .sampler.driver import DPMMState


def table_from_jax(table_np, device="cpu"):
    """A JAX table (nested dicts of numpy arrays) as the port's tensors:
    bools stay bool, floats become float32, ``None`` stays ``None``."""
    if table_np is None:
        return None
    if isinstance(table_np, dict):
        return {k: table_from_jax(v, device) for k, v in table_np.items()}
    a = np.asarray(table_np)
    a = np.array(a, dtype=np.bool_ if a.dtype == np.bool_ else np.float32)
    return torch.from_numpy(a).to(device)


def state_from_jax(table_np, labels, sublabels, *, seed: int = 0,
                   device="cpu", step: int = 0) -> DPMMState:
    """A JAX sampler state (table + lane-blocked label streams, as numpy)
    as a port state with flat int32 streams and a fresh generator."""
    def flat(a):
        return torch.from_numpy(np.array(a, np.int32).reshape(-1)).to(device)

    gen = torch.Generator(device=device).manual_seed(seed)
    return DPMMState(table=table_from_jax(table_np, device),
                     labels=flat(labels), sublabels=flat(sublabels), gen=gen,
                     step=step)


def _rows(a, f, device) -> torch.Tensor:
    """One JAX row array (f32 or bf16, as numpy) as a tensor of its first
    ``f`` columns; bf16 keeps its bits (numpy has no bf16 of its own: the
    array's 2-byte elements are viewed as integers and back) and takes the
    port's cache layout (``sweep_kernels.pad_bf16_rows``)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, np.float32))
    if f is not None:
        t = t[:, :f]
    if t.dtype == torch.bfloat16:
        return sweep_kernels.pad_bf16_rows(t.to(device))
    return t.contiguous().to(device)


def points_from_jax(points, f=None, device="cpu"):
    """A JAX points container (``engine.featurize``'s result, as numpy) as
    the port's: a feature cache ``[N, F_pad]`` (f32 or bf16) becomes ``[N,
    f]`` in the same dtype, and the hybrid dict ``{"feat", "raw"}`` becomes
    ``{"feat": bf16 [N, F], "raw": f32 [N, D]}`` with F the Gaussian F of D
    unless ``f`` is given.  ``f=None`` keeps every column of a cache."""
    if isinstance(points, dict):
        raw = _rows(points["raw"], None, device)
        f = GAUSSIAN.feature_dim(raw.shape[1]) if f is None else f
        return {"feat": _rows(points["feat"], f, device), "raw": raw}
    return _rows(points, f, device)
