"""Carry cluster tables and sampler state from the JAX package to the port.

The JAX package keeps the same table layout as dicts of arrays; pass them
here as numpy arrays (``jax.device_get(state.table)``).  Its per-point
streams are lane-blocked ``[N/128, 128]``; the port's are flat ``[N]``.
Nothing here imports ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

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
