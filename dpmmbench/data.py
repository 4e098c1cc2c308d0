"""The benchmark's inputs, made on the device from the run's seed.

A torch copy of the flagship mixture the repository's benchmarks use
(``chip_smoke.separated_data``): ``k_true`` means drawn N(0, I) and scaled
by ``mean_scale``, each point's generator label uniform over them, unit
covariances.  The same seed gives the same points and labels on one kind
of card; the generator labels are kept for the recovery check.
"""
from __future__ import annotations

import numpy as np
import torch


def run_seeds(seed: int, count: int) -> list:
    """``count`` seeds in [0, 2^31 - 1) for the parts of one run (data,
    sampler, fits), drawn from the run's ``--seed``."""
    state = np.random.SeedSequence(int(seed) % (1 << 63)).generate_state(
        count, np.uint32)
    return [int(v) & 0x7FFFFFFE for v in state]


def separated_data(n: int, d: int, k_true: int, mean_scale: float,
                   seed: int, device) -> tuple:
    """(x float32 [n, d], labels int64 [n]) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.randn((k_true, d), generator=gen, device=device)
    means *= mean_scale
    labels = torch.randint(0, k_true, (n,), generator=gen, device=device)
    x = torch.randn((n, d), generator=gen, device=device)
    x += means[labels]
    return x, labels


def centered(x: torch.Tensor) -> torch.Tensor:
    """``x`` less its column means (taken in float64), in place."""
    x -= x.mean(0, dtype=torch.float64).to(x.dtype)
    return x


def standardized(x: torch.Tensor) -> tuple:
    """float64 ``(x - mean) / sd`` (population sd) and the prior's map:
    ``(xs, mean, 1 / sd)``.  The reference's own standardization of the
    fit cell's points, worked out apart from the sampler's."""
    x64 = x.to(torch.float64)
    mean = x64.mean(0)
    sd = (x64 - mean).square().mean(0).sqrt()
    scale = torch.where(sd > 1e-12, 1.0 / sd, torch.ones_like(sd))
    return (x64 - mean) * scale, mean, scale
