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
PyTorch path).  ``--distributed`` (multi-process mode) is not ported yet.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .api import FitResult, fit, run_from_checkpoint
from .io.npy import load_data


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


def _load_params(path: str):
    """(params without the data keys, data, gt or None) of a params file."""
    with open(path) as f:
        params = json.load(f)
    _validate_params(params, path)
    data = load_data(
        params.pop("data_path"),
        swapdims=bool(params.pop("data_transposed", False)),
    )
    gt = None
    if "gt_path" in params:
        gt = np.load(params.pop("gt_path")).astype(np.int64)
    return params, data, gt


def fit_from_params(path: str, *, device="cuda") -> FitResult:
    """Load a JSON params file and run ``fit`` on ``device`` (reference
    ``dp_parallel(model_params::String)``, src/dp-parallel-sampling.jl:317)."""
    params, data, gt = _load_params(path)
    prior = params.pop("prior", None)
    if prior is not None:
        prior = {k: np.asarray(v, np.float32) for k, v in prior.items()}
    outlier_prior = params.pop("outlier_prior", None)
    if outlier_prior is not None:
        outlier_prior = {
            k: np.asarray(v, np.float32) for k, v in outlier_prior.items()
        }
    family = params.pop("family", None)
    alpha = params.pop("alpha", 10.0)
    return fit(
        data, alpha=alpha, prior=prior, family=family, gt=gt, device=device,
        outlier_prior=outlier_prior, **params,
    )


def resume_from_params(ckpt: str, path: str, iters=None, *,
                       device="cuda") -> FitResult:
    """Resume from a checkpoint on ``device``; the params file supplies the
    data (``data_path`` / ``data_transposed`` / ``gt_path``).  Everything
    else comes from the checkpoint's config, ``iters`` aside."""
    _, data, gt = _load_params(path)
    return run_from_checkpoint(ckpt, data, iters=iters, gt=gt, device=device)


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
                    help="multi-process mode (not ported yet)")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-process fits are not ported yet "
            "(ROADMAP.md, Queue 1 item E: parallel/ -> torch.distributed)")
    if args.resume:
        result = resume_from_params(args.resume, args.params, args.iters,
                                    device=args.device)
    else:
        result = fit_from_params(args.params, device=args.device)
    print(f"K = {result.k}")
    print(f"weights = {np.round(result.weights, 4).tolist()}")
    print(f"log_posterior = {result.model.log_posterior():.2f}")


if __name__ == "__main__":
    main()
