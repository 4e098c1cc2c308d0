"""The benchmark's inputs, made on the device from the run's seed.

A torch copy of the flagship mixture the repository's benchmarks use
(``chip_smoke.separated_data``): ``k_true`` means drawn N(0, I) and scaled
by ``mean_scale``, each point's generator label uniform over them, unit
covariances.  The same seed gives the same points and labels on one kind
of card; the generator labels are kept for the recovery check.

A mixture sharded over ranks (:func:`shard_of_separated_data`) draws the
same means from the seed alone and each block of ``BLOCK_ROWS`` global
rows from a stream of its own, keyed on (seed, block index), so that the
points do not depend on how the rows are split.
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


BLOCK_ROWS = 1_000_000


def block_seed(seed: int, block: int) -> int:
    """The seed of global block ``block`` of a sharded mixture."""
    state = np.random.SeedSequence([int(seed) % (1 << 63), int(block)])
    return int(state.generate_state(1, np.uint32)[0]) & 0x7FFFFFFE


def shard_of_separated_data(row0: int, rows: int, d: int, k_true: int,
                            mean_scale: float, seed: int, device,
                            block: int = BLOCK_ROWS, pad_to: int = 0) -> tuple:
    """Global rows ``[row0, row0 + rows)`` of the mixture of
    :func:`separated_data`'s law, sharded: (x float32 [R, d], labels int64
    [R]) on ``device``, with R = max(rows, ``pad_to``) and zeros past
    ``rows``.  The means come from ``seed`` alone; each block of ``block``
    global rows draws its labels, then its points, from a generator seeded
    with :func:`block_seed`, whole, and gives this shard its overlap."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.randn((k_true, d), generator=gen, device=device)
    means *= mean_scale
    x = torch.zeros((max(rows, pad_to), d), dtype=torch.float32,
                    device=device)
    labels = torch.zeros(max(rows, pad_to), dtype=torch.int64, device=device)
    for b in range(row0 // block, -(-(row0 + rows) // block)):
        g = torch.Generator(device=device).manual_seed(block_seed(seed, b))
        lab = torch.randint(0, k_true, (block,), generator=g, device=device)
        xb = torch.randn((block, d), generator=g, device=device)
        xb += means[lab]
        lo, hi = max(row0, b * block), min(row0 + rows, (b + 1) * block)
        x[lo - row0:hi - row0] = xb[lo - b * block:hi - b * block]
        labels[lo - row0:hi - row0] = lab[lo - b * block:hi - b * block]
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
