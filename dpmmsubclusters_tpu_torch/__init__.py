"""dpmmsubclusters_tpu_torch: the DPMM sub-cluster sampler in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of :mod:`dpmmsubclusters_tpu` (JAX/Pallas on TPU), module for
module: the Chang & Fisher restricted Gibbs sweeps with auxiliary 2-way
sub-clusters and Metropolis-Hastings split/merge moves.  This package covers
the Gaussian/NIW and multinomial/Dirichlet families on one device, with or
without the precomputed f32 feature cache; it imports ``torch`` and
``numpy``, never ``jax``.
"""

from .api import DPMMModel, FitResult, fit
from .config import DPMMConfig
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
    "generate_gaussian_data",
    "generate_mnmm_data",
    "get_labels_histogram",
    "nmi",
    "varinfo",
]
