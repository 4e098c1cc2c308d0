"""Checkpoint save/load in the JAX package's file format.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.io.checkpoint`, with the
multi-process pair (:func:`save_checkpoint_distributed`,
:func:`load_checkpoint_distributed`) in the same layout: a master file and
one label shard a rank.
Like the reference's ``pts_less_group`` (src/dp-parallel-sampling.jl:
396-401,450-455) a checkpoint holds the labels, sub-labels, the cluster
table, the random state and the step, not the points: a resume supplies
the data again.  One ``.npz``: ``table//<path>`` for each leaf of the table
(nested dict keys in sorted order, as ``jax.tree_util`` flattens them),
flat ``labels`` / ``sublabels`` of length ``n_points``, ``key``, ``step``,
``shift``, ``scale``, ``n_points`` and ``meta`` (JSON of ``config``,
``family`` and ``version``), with the dtypes and shapes the JAX package
writes, so each package loads the other's files.

The random state is the one part that differs between the frameworks.
``key`` is a valid JAX key (``uint32[2]``, :func:`jax_key` of the fit's
seed and the step), so the JAX package can resume a file of the port.
Beside it the port writes its generator's state,
``torch.Generator.get_state()`` as uint8, under ``torch_generator_<device
type>`` (``cpu`` or ``cuda``; the JAX loader ignores it).  A resume on a
device of that type continues the same random stream; a file without it
(one the JAX package wrote, or one from the other device type) reseeds
the generator from ``key`` and ``step`` (:func:`reseed`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import DPMMConfig
from ..parallel import distributed as dist

_SEP = "//"
_GEN = "torch_generator_"
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
# On-disk format version, the JAX package's.  The decoder tolerates unknown
# config keys (a field added or renamed after a file was written).
FORMAT_VERSION = 1


def jax_key(seed: int, step: int) -> np.ndarray:
    """The JAX key written for a fit ``seed`` at ``step``: ``[(seed >> 32)
    ^ step, seed & 0xFFFFFFFF]`` as uint32, which at step 0 and a 32-bit
    seed is ``jax.random.PRNGKey(seed)``."""
    return np.array([((seed >> 32) ^ step) & _M32, seed & _M32], np.uint32)


def seed_from_key(key, step: int) -> int:
    """The inverse of :func:`jax_key`: the 64-bit seed that ``key`` encodes
    at ``step`` (for a key the JAX package drew, some fixed 64-bit value)."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return (((int(k[0]) ^ step) & _M32) << 32) | int(k[1])


def reseed(key, step: int) -> int:
    """The generator seed for a file without the port's generator state:
    the key's 64 bits mixed with the step, so a reseeded resume does not
    replay the stream the fit started from."""
    return (seed_from_key(key, step)
            ^ ((step + 1) * 0x9E3779B97F4A7C15)) & _M64


def _decode_config(cfg_dict: dict) -> DPMMConfig:
    """A config from a file: keys this DPMMConfig does not know (written by
    another version) are dropped with a warning; missing keys take their
    defaults."""
    known = {f.name for f in dataclasses.fields(DPMMConfig)}
    unknown = sorted(set(cfg_dict) - known)
    if unknown:
        warnings.warn(
            f"checkpoint config carries unknown keys {unknown} "
            f"(written by a different version?); ignoring them",
            stacklevel=3,
        )
    return DPMMConfig(**{k: v for k, v in cfg_dict.items() if k in known})


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(tree, prefix: str = "table") -> dict:
    """``{"table//a//b": leaf}`` over sorted keys; ``None`` leaves are
    dropped, as ``jax.tree_util`` drops them."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if v is None:
            continue
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{_SEP}{k}"))
        else:
            out[f"{prefix}{_SEP}{k}"] = _as_numpy(v)
    return out


def save_checkpoint(path: str, *, table, labels, sublabels, key, step: int,
                    shift, cfg: DPMMConfig, family_name: str, n_points: int,
                    scale=None, gen_state: Optional[np.ndarray] = None,
                    gen_device: str = "cpu"):
    """Write the sampler state to ``path`` (.npz).  ``table`` holds tensors
    or arrays; ``gen_state`` (uint8, ``torch.Generator.get_state()`` of a
    generator on ``gen_device``) is written beside the JAX ``key``."""
    payload = _flatten(table)
    payload["labels"] = _as_numpy(labels).reshape(-1)[:n_points]
    payload["sublabels"] = _as_numpy(sublabels).reshape(-1)[:n_points]
    payload["key"] = np.asarray(key, np.uint32)
    payload["step"] = np.asarray(step)
    payload["shift"] = np.asarray(shift)
    if scale is not None:
        payload["scale"] = np.asarray(scale)
    payload["n_points"] = np.asarray(n_points)
    payload["meta"] = np.frombuffer(
        json.dumps({"config": dataclasses.asdict(cfg), "family": family_name,
                    "version": FORMAT_VERSION}).encode(),
        dtype=np.uint8,
    )
    if gen_state is not None:
        payload[_GEN + gen_device] = np.asarray(gen_state, np.uint8)
    np.savez(path, **payload)


def save_checkpoint_distributed(path: str, *, table, labels, sublabels,
                                key, step: int, shift, cfg: DPMMConfig,
                                family_name: str, n_points_global: int,
                                n_local: int, scale=None,
                                gen_state: Optional[np.ndarray] = None,
                                gen_device: str = "cpu"):
    """Multi-process checkpoint: EVERY rank calls this.

    Rank 0 writes the master file ``path`` (:func:`save_checkpoint` of the
    replicated table, key, step, config, shift, scale and generator state;
    its label fields hold rank 0's shard) and every rank writes
    ``path.shard<i>.npz`` with its ``labels``, ``sublabels``, ``n_local``,
    ``process``, ``num_processes`` and ``step``: the JAX package's
    layout, so each package resumes the other's files."""
    me, n_local = dist.rank(), int(n_local)
    lab = _as_numpy(labels).reshape(-1)[:n_local]
    sub = _as_numpy(sublabels).reshape(-1)[:n_local]
    np.savez(f"{path}.shard{me}.npz", labels=lab, sublabels=sub,
             n_local=np.asarray(n_local), process=np.asarray(me),
             num_processes=np.asarray(dist.world()), step=np.asarray(step))
    if me == 0:
        save_checkpoint(path, table=table, labels=lab, sublabels=sub,
                        key=key, step=step, shift=shift, cfg=cfg,
                        family_name=family_name, n_points=n_points_global,
                        scale=scale, gen_state=gen_state,
                        gen_device=gen_device)


def load_checkpoint_distributed(path: str, n_local: Optional[int] = None):
    """``(master, shard)``: the master file as :func:`load_checkpoint`
    reads it, and this rank's ``{"labels", "sublabels", "n_local"}``.

    On the grid that wrote the files, with this rank's row count unchanged
    (or ``n_local`` None), this rank reads its own shard file.  Otherwise
    it is a re-shard: the table is replicated and labels are per point, so
    this rank's labels are its contiguous slice of the saved shards
    concatenated in rank order, at offsets agreed by an all-gather of every
    rank's ``n_local`` (this rank's row count, required then).  Every
    rank must reach every shard file (a shared file system).  Raises
    ``ValueError`` when the new row counts do not cover the saved
    points."""
    me, n_ranks = dist.rank(), dist.world()
    master = load_checkpoint(path)
    mine = f"{path}.shard{me}.npz"
    with np.load(mine if os.path.exists(mine) else f"{path}.shard0.npz") as z:
        saved_ranks = int(z["num_processes"])
        if (os.path.exists(mine) and saved_ranks == n_ranks
                and (n_local is None or int(z["n_local"]) == n_local)):
            return master, {"labels": z["labels"],
                            "sublabels": z["sublabels"],
                            "n_local": int(z["n_local"])}
    if n_local is None:
        raise ValueError(
            f"checkpoint was written by {saved_ranks} processes; to resume "
            f"on {n_ranks} pass n_local (this rank's row count) so the "
            f"label stream can be re-sharded")
    labels, sublabels = [], []
    for i in range(saved_ranks):
        with np.load(f"{path}.shard{i}.npz") as z:
            labels.append(z["labels"])
            sublabels.append(z["sublabels"])
    labels, sublabels = np.concatenate(labels), np.concatenate(sublabels)
    counts = dist.all_gather_ints(n_local)
    if sum(counts) != len(labels):
        raise ValueError(
            f"re-shard row counts {counts} (total {sum(counts)}) do not "
            f"cover the checkpoint's {len(labels)} points")
    start = sum(counts[:me])
    rows = slice(start, start + int(n_local))
    return master, {"labels": labels[rows], "sublabels": sublabels[rows],
                    "n_local": int(n_local)}


def load_checkpoint(path: str) -> dict:
    """A dict with ``table`` (nested dicts of numpy arrays), ``labels``,
    ``sublabels``, ``key``, ``step``, ``shift``, ``scale`` (None when
    absent), ``n_points``, ``config`` (DPMMConfig), ``family`` (str),
    ``version`` and ``generator`` (``{device type: uint8 state}``, empty for
    a file without the port's generator state)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        table: dict = {}
        for k in z.files:
            if not k.startswith(f"table{_SEP}"):
                continue
            parts = k.split(_SEP)[1:]
            node = table
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
        # a table field added after a file was written gets its neutral
        # default
        if "active" in table and "needs_smart" not in table:
            table["needs_smart"] = np.zeros_like(table["active"])
        return {
            "table": table,
            "labels": z["labels"],
            "sublabels": z["sublabels"],
            "key": z["key"],
            "step": int(z["step"]),
            "shift": z["shift"],
            "scale": z["scale"] if "scale" in z.files else None,
            "n_points": int(z["n_points"]),
            "config": _decode_config(meta["config"]),
            "family": meta["family"],
            "version": int(meta.get("version", 0)),
            "generator": {k[len(_GEN):]: z[k] for k in z.files
                          if k.startswith(_GEN)},
        }


def restore_generator(ck: dict, device) -> torch.Generator:
    """The generator a resume continues with, on ``device``: the file's own
    state for that device type, else one seeded by :func:`reseed` of the
    file's ``key`` and ``step``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    state = ck["generator"].get(device.type)
    if state is not None:
        gen.set_state(torch.from_numpy(np.array(state, np.uint8)))
    else:
        gen.manual_seed(reseed(ck["key"], ck["step"]))
    return gen
