"""Ranks of the port's multi-process tests (gloo).

``run_ranks`` starts one process a rank, each running this file on a JSON
spec: it joins a gloo group through a ``file://`` rendezvous, takes its
contiguous rows of the spec's ``.npy`` points by ``counts``, runs
``fit_distributed`` (or, with ``ckpt``, ``run_from_checkpoint_distributed``)
on the spec's device (the CPU, or ranks sharing one card), and writes
what the tests compare to ``{out}.rank{i}.npz``: its labels, sub-labels,
``history.k``, the sha256 of its table and every rank's (all-gathered),
and with ``predict`` its ``predict`` labels and ``cluster_statistics``.

    python tests/torch_dist_worker.py SPEC.json RANK
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

RANK_TIMEOUT = 120   # seconds a spawning test waits for its ranks


def run_ranks(argvs, timeout: float = RANK_TIMEOUT, env=None) -> list:
    """Run one process per argument list (``[sys.executable, *argv]``)
    side by side, one torch thread each; fail (killing them all) when any
    exceeds ``timeout`` seconds or exits non-zero.  Returns their
    outputs."""
    import pytest

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ if env is None else env, PYTHONPATH=root,
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=root, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"ranks still running after {timeout} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {i} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def spawn(tmp_path, x, counts, *, name="run", ckpt=None, predict=False,
          device="cpu", **kwargs) -> list:
    """``fit_distributed`` (or, with ``ckpt``, its resume) of ``x`` split
    by ``counts`` over ``len(counts)`` gloo ranks on ``device`` (on
    ``"cuda"`` every rank shares the one card); returns each rank's outputs
    (dicts of arrays)."""
    data = tmp_path / f"{name}_x.npy"
    if not data.exists():
        np.save(data, np.asarray(x, np.float32))
    spec = dict(init=f"file://{tmp_path}/{name}_rendezvous",
                data=str(data), counts=[int(c) for c in counts],
                out=str(tmp_path / name), ckpt=ckpt, predict=predict,
                device=device, kwargs=kwargs)
    path = tmp_path / f"{name}_spec.json"
    path.write_text(json.dumps(spec))
    run_ranks([[__file__, str(path), str(i)] for i in range(len(counts))])
    outs = []
    for i in range(len(counts)):
        with np.load(f"{spec['out']}.rank{i}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.parallel import distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    counts = spec["counts"]
    dist.initialize(spec["init"], len(counts), rank, "gloo")
    try:
        lo = sum(counts[:rank])
        rows = np.load(spec["data"])[lo:lo + counts[rank]]
        if spec["ckpt"] is None:
            res = dpmm.fit_distributed(rows, device=spec["device"],
                                       **spec["kwargs"])
        else:
            res = dpmm.run_from_checkpoint_distributed(
                spec["ckpt"], rows, device=spec["device"], **spec["kwargs"])
        m = res.model
        digest = dist.table_digest(m.table)
        digests = [None] * len(counts)
        tdist.all_gather_object(digests, digest)
        out = dict(labels_raw=m.labels_raw, sublabels=m.sublabels,
                   labels=res.labels, k=res.k,
                   hist_k=np.asarray(res.history.k), n_points=m.n_points,
                   step=m.step, shift=m.shift, scale=m._scale,
                   digest=digest, digests=np.array(digests))
        if spec["predict"]:
            pred, _ = m.predict(rows, return_probs=False)
            avg_ll, avg_prob = m.cluster_statistics(rows, res.labels)
            out.update(pred=pred, avg_ll=avg_ll, avg_prob=avg_prob)
        np.savez(f"{spec['out']}.rank{rank}.npz", **out)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
