"""dpmmsubclusters_tpu_torch: the DPMM sub-cluster sampler in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of :mod:`dpmmsubclusters_tpu` (JAX/Pallas on TPU), module for
module: the Chang & Fisher restricted Gibbs sweeps with auxiliary 2-way
sub-clusters and Metropolis-Hastings split/merge moves.  This package covers
the Gaussian/NIW and multinomial/Dirichlet families on one device and, one
card a process, across processes (:func:`fit_distributed` over
``torch.distributed``), with or without a precomputed feature cache, with
checkpoints in the JAX package's
format (:func:`run_from_checkpoint`), the npy loader, the reference-named
``compat`` surface and the CLI (``python -m dpmmsubclusters_tpu_torch.run``);
it imports ``torch`` and ``numpy``, never ``jax``.
"""

from .api import (DPMMModel, FitResult, fit, fit_distributed,
                  run_from_checkpoint, run_from_checkpoint_distributed)
from .config import DPMMConfig
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.npy import load_data
from .priors import GAUSSIAN, MULTINOMIAL, GaussianFamily, MultinomialFamily
from .utils.generators import generate_gaussian_data, generate_mnmm_data
from .utils.metrics import get_labels_histogram, nmi, varinfo

__all__ = [
    "DPMMConfig",
    "DPMMModel",
    "FitResult",
    "GAUSSIAN",
    "GaussianFamily",
    "MULTINOMIAL",
    "MultinomialFamily",
    "fit",
    "fit_distributed",
    "generate_gaussian_data",
    "generate_mnmm_data",
    "get_labels_histogram",
    "load_checkpoint",
    "load_data",
    "nmi",
    "run_from_checkpoint",
    "run_from_checkpoint_distributed",
    "save_checkpoint",
    "varinfo",
]
