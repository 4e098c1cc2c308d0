"""Params-file mode and the CLI.

The port's counterpart of :mod:`dpmmsubclusters_tpu.run`, and of the
reference's "advanced mode": ``dp_parallel(path)``, which ``include``s a
Julia params file of globals and loads the data from npy
(``src/dp-parallel-sampling.jl:317-334``, ``src/global_params.jl``).  Here
the params file is declarative JSON.

JSON keys = :class:`~dpmmsubclusters_tpu_torch.config.DPMMConfig` fields,
plus:

  data_path        path to the npy points file (required)
  data_transposed  true if the file is stored D x N (default false)
  family           "gaussian" (default) | "multinomial"
  alpha            DP concentration
  prior            family-specific prior arrays, e.g.
                   {"kappa": 1.0, "m": [0,0], "nu": 5.0, "psi": [[1,0],[0,1]]}
                   or {"alpha": [1, 1, ...]}
  outlier_prior    optional, same shape as prior
  gt_path          optional npy ground-truth labels (enables NMI reporting)

Run:      python -m dpmmsubclusters_tpu_torch.run params.json
Resume:   python -m dpmmsubclusters_tpu_torch.run --resume ckpt.npz params.json
          (optionally --iters N, the total sweep count to run to; the
          reference's ``run_model_from_checkpoint``,
          src/dp-parallel-sampling.jl:428-447)

``--device`` picks the device (default ``cuda``; ``cpu`` for the plain
PyTorch path).

Multi-process: ``--distributed`` joins the process group
(:func:`.parallel.distributed.initialize`: ``--coordinator HOST:PORT`` or a
URL, ``--num-processes``, ``--process-id``, ``--backend nccl|gloo``; under
``torchrun`` all from its environment) and runs ``fit_distributed``, or
with ``--resume`` ``run_from_checkpoint_distributed``, once per process.
Each process reads its own rows: ``data_path`` with ``{proc}`` names a file
per rank, otherwise each rank takes its contiguous slice of the one file.
``gt_path`` is ignored there (labels are per rank; NMI is offline).

    torchrun --nproc-per-node=4 -m dpmmsubclusters_tpu_torch.run \
        --distributed params.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .api import (FitResult, fit, fit_distributed, run_from_checkpoint,
                  run_from_checkpoint_distributed)
from .io.npy import load_data
from .parallel import distributed as dist


def _validate_params(params: dict, path: str):
    """Fail fast on a malformed params file: require ``data_path`` and
    reject unknown keys with a named error (the reference silently accepts
    unused params-file globals, src/global_params.jl:39, so a misspelled
    knob there is a no-op)."""
    import dataclasses

    from .config import DPMMConfig

    if "data_path" not in params:
        raise ValueError(
            f"params file {path!r}: missing required key 'data_path'"
        )
    allowed = {f.name for f in dataclasses.fields(DPMMConfig)} | {
        "data_path", "data_transposed", "family", "alpha", "prior",
        "outlier_prior", "gt_path",
    }
    unknown = sorted(set(params) - allowed)
    if unknown:
        raise ValueError(
            f"params file {path!r}: unknown key(s) {unknown} "
            f"(allowed: DPMMConfig fields plus data_path/data_transposed/"
            f"family/alpha/prior/outlier_prior/gt_path)"
        )


def _read_params(path: str) -> dict:
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path)
    return params


def _load_params(path: str):
    """(params without the data keys, data, gt or None) of a params file."""
    params = _read_params(path)
    data = load_data(
        params.pop("data_path"),
        swapdims=bool(params.pop("data_transposed", False)),
    )
    gt = None
    if "gt_path" in params:
        gt = np.load(params.pop("gt_path")).astype(np.int64)
    return params, data, gt


def _pop_model_args(params: dict) -> dict:
    """``prior``, ``outlier_prior`` (as float32 arrays), ``family`` and
    ``alpha`` taken out of ``params``."""
    prior = params.pop("prior", None)
    if prior is not None:
        prior = {k: np.asarray(v, np.float32) for k, v in prior.items()}
    outlier_prior = params.pop("outlier_prior", None)
    if outlier_prior is not None:
        outlier_prior = {
            k: np.asarray(v, np.float32) for k, v in outlier_prior.items()
        }
    return dict(prior=prior, outlier_prior=outlier_prior,
                family=params.pop("family", None),
                alpha=params.pop("alpha", 10.0))


def fit_from_params(path: str, *, device="cuda") -> FitResult:
    """Load a JSON params file and run ``fit`` on ``device`` (reference
    ``dp_parallel(model_params::String)``, src/dp-parallel-sampling.jl:317)."""
    params, data, gt = _load_params(path)
    model = _pop_model_args(params)
    return fit(data, gt=gt, device=device, **model, **params)


def resume_from_params(ckpt: str, path: str, iters=None, *,
                       device="cuda") -> FitResult:
    """Resume from a checkpoint on ``device``; the params file supplies the
    data (``data_path`` / ``data_transposed`` / ``gt_path``).  Everything
    else comes from the checkpoint's config, ``iters`` aside."""
    _, data, gt = _load_params(path)
    return run_from_checkpoint(ckpt, data, iters=iters, gt=gt, device=device)


def _load_local_rows(params: dict) -> np.ndarray:
    """This rank's rows in distributed mode: the file a rank when
    ``data_path`` holds ``{proc}``, else a contiguous slice of the one file
    by rank (``params`` loses its data keys)."""
    path = params.pop("data_path")
    swap = bool(params.pop("data_transposed", False))
    params.pop("gt_path", None)
    if "{proc}" in path:
        return load_data(path.format(proc=dist.rank()), swapdims=swap)
    x = load_data(path, swapdims=swap)
    n, p, i = len(x), dist.world(), dist.rank()
    return x[(n * i) // p:(n * (i + 1)) // p]


def fit_from_params_distributed(path: str, *, device="cuda") -> FitResult:
    """Multi-process params-file mode: call after ``initialize()`` on every
    rank; drives ``fit_distributed`` from the same JSON schema."""
    params = _read_params(path)
    x_local = _load_local_rows(params)
    model = _pop_model_args(params)
    return fit_distributed(x_local, device=device, **model, **params)


def resume_from_params_distributed(ckpt: str, path: str, iters=None, *,
                                   device="cuda") -> FitResult:
    """Resume a distributed checkpoint on every rank; the params file
    supplies the rows, on this rank count (a re-shard when it differs)."""
    x_local = _load_local_rows(_read_params(path))
    return run_from_checkpoint_distributed(ckpt, x_local, iters=iters,
                                           device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dpmmsubclusters_tpu_torch.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("params", help="JSON params file")
    ap.add_argument("--resume", metavar="CKPT",
                    help="checkpoint .npz to resume from")
    ap.add_argument("--iters", type=int, default=None,
                    help="with --resume: total iterations to run to")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the plain "
                         "PyTorch path)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process mode: join the process group and "
                         "run fit_distributed (launch once per process)")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous HOST:PORT or URL (torchrun: from env)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl with a card, gloo without; gloo "
                         "lets several ranks share one card")
    args = ap.parse_args(argv)
    if args.distributed:
        dist.initialize(args.coordinator, args.num_processes,
                        args.process_id, args.backend)
        try:
            if args.resume:
                result = resume_from_params_distributed(
                    args.resume, args.params, args.iters, device=args.device)
            else:
                result = fit_from_params_distributed(args.params,
                                                     device=args.device)
        finally:
            dist.shutdown()
    elif args.resume:
        result = resume_from_params(args.resume, args.params, args.iters,
                                    device=args.device)
    else:
        result = fit_from_params(args.params, device=args.device)
    print(f"K = {result.k}")
    print(f"weights = {np.round(result.weights, 4).tolist()}")
    print(f"log_posterior = {result.model.log_posterior():.2f}")


if __name__ == "__main__":
    main()
