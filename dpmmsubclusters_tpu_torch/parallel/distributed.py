"""Multi-process fits over ``torch.distributed``.

PyTorch counterpart of :mod:`dpmmsubclusters_tpu.parallel.distributed`,
and of the reference's multi-machine mode (Julia ``addprocs`` and its
node-leader reduce tree, ``docs/src/perf.md:3``, ``src/utils.jl:51-64``).
Each process drives one card and holds its own rows; the cluster table is
replicated, and every statistics pass ends in one sum-``all_reduce`` of
its ``[K, 2, F]`` sums.  A process group is all this needs: there is no
device mesh (the JAX package's ``parallel/mesh.py``).

Typical launch, the same script on every process::

    torchrun --nproc-per-node=4 my_fit.py

    import dpmmsubclusters_tpu_torch as dpmm
    from dpmmsubclusters_tpu_torch.parallel import distributed

    distributed.initialize()          # torchrun's environment
    x_local = load_my_shard(distributed.rank())
    result = dpmm.fit_distributed(x_local, alpha=10.0, iters=100)

A process group that was never initialized is a world of one, in which
every collective here is the identity, as the JAX package's
``fit_distributed`` runs in one process without ``initialize``.

Row layout.  The global row order is the ranks' rows in rank order.  Every
shard but the last is padded with invalid rows to a whole number of
``HASH_TILE`` rows, so each rank's first row starts a hash tile of kernel
A's Gumbel noise, and per-point randomness (the noise, the bf16 cache's
dither, the per-point draws of the replicated generator) is keyed on the
global padded row.  A world of one, and any split whose shards before the
last are whole tiles, therefore has exactly ``fit``'s layout, and draws
what ``fit`` draws.

The order of the sums.  Each rank's kernels sum their rows in a fixed
order and the ``all_reduce`` adds the ranks' sums; every rank receives the
same bits.  The smart pass's sums on a card are exact at any split
(``smart._exact_slot_sums``, which takes :meth:`RowLayout.reduce_max`
too).  Labels across rank counts are bit-identical only where the
float32 sums are exact (integer data, such as the 4-corner gate), as the
JAX package's ``tests/test_fit_e2e.py::test_single_device_matches_multi``
says of its mesh sizes; elsewhere the chains agree in distribution.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..sampler.assign import HASH_TILE

MOMENT_ROWS = 1 << 16     # rows per chunk of the float64 moment passes
# what a launcher (torchrun) sets for an env:// rendezvous
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    Under ``torchrun`` every argument comes from the environment
    (``ValueError`` when neither it nor a ``coordinator_address`` is
    there).  Otherwise pass the rendezvous ``coordinator_address``
    (``host:port``, or a URL such as ``tcp://host:port`` or
    ``file:///shared/path``), the world size and this process's rank.
    ``backend`` defaults to ``"nccl"`` where a card is present and
    ``"gloo"`` on the CPU; an explicit ``"gloo"`` lets several ranks share
    one card (their sums then travel through host memory).  Each rank's
    default card is ``cuda:{LOCAL_RANK}`` (the rank when ``LOCAL_RANK`` is
    unset) modulo the cards present."""
    if coordinator_address is None:
        unset = [v for v in _LAUNCHER_ENV if v not in os.environ]
        if unset:
            raise ValueError(
                f"initialize: no coordinator_address, and {', '.join(unset)}"
                f" unset: run under torchrun, or pass coordinator_address, "
                f"num_processes and process_id")
        init_method = "env://"
    elif num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator_address needs "
                         "num_processes and process_id")
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    tdist.init_process_group(
        backend=backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(minutes=10))


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def world() -> int:
    """The number of processes; 1 when no group was initialized."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 when no group was initialized."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def _comm_device() -> torch.device:
    """Where the backend takes its tensors: the card under NCCL, the host
    under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, on ``t``'s device (the identity in
    a world of one).  A tensor on a device the backend does not take (a
    card's under gloo, the host's under NCCL) is copied there and back."""
    return _all_reduce(t, tdist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise largest of ``t`` over every rank, as
    :func:`all_reduce_sum` gives the sum."""
    return _all_reduce(t, tdist.ReduceOp.MAX)


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    if world() == 1:
        return t
    comm = _comm_device()
    if t.device == comm:
        tdist.all_reduce(t, op)
        return t
    staged = t.to(comm)
    tdist.all_reduce(staged, op)
    return staged.to(t.device)


def all_gather_ints(value: int) -> list:
    """Every rank's ``value``, in rank order."""
    if world() == 1:
        return [int(value)]
    mine = torch.tensor([int(value)], dtype=torch.int64,
                        device=_comm_device())
    out = [torch.empty_like(mine) for _ in range(world())]
    tdist.all_gather(out, mine)
    return [int(t.item()) for t in out]


def table_digest(table) -> str:
    """sha256 of every tensor of a cluster table (nested dicts, sorted
    keys): equal on every rank of a healthy distributed fit, whose table is
    replicated."""
    h = hashlib.sha256()

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif v is not None:
                h.update(f"{prefix}{k}".encode())
                h.update(v.detach().cpu().contiguous().numpy().tobytes())

    walk(table, "")
    return h.hexdigest()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Where this rank's rows sit in the global row order, and the
    collectives of a fit over it.  The default is one process holding all
    the rows (``fit``): no padding, and every collective the identity.

    ``counts`` are every rank's real rows in rank order; ``row_start`` is
    this rank's first global (padded) row, a multiple of ``HASH_TILE``;
    ``n_pad`` its rows with padding; ``n_global_pad`` the padded rows of
    all ranks."""

    counts: tuple = ()
    rank: int = 0
    row_start: int = 0
    n_pad: int = 0
    n_global_pad: int = 0

    @property
    def world(self) -> int:
        return max(1, len(self.counts))

    @property
    def n_global(self) -> int:
        return sum(self.counts)

    @property
    def tile_off(self) -> int:
        """Kernel A's ``tile_off``: the hash tile this rank's rows start."""
        return self.row_start // HASH_TILE

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """:func:`all_reduce_sum` of ``t`` across this layout's ranks."""
        return all_reduce_sum(t) if self.world > 1 else t

    def reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """:func:`all_reduce_max` of ``t`` across this layout's ranks."""
        return all_reduce_max(t) if self.world > 1 else t

    def per_point(self, draw: Callable[[int], torch.Tensor],
                  n: int) -> torch.Tensor:
        """This rank's rows of a per-point draw from the replicated
        generator: ``draw(m)`` draws ``m`` values; across ranks it draws
        the global padded length and each rank takes its slice, so every
        rank advances the generator alike.  ``n`` is the local row count
        (the draw's length in a world of one)."""
        if self.world == 1:
            return draw(n)
        return draw(self.n_global_pad)[self.row_start:
                                       self.row_start + self.n_pad]

    def moments(self, x: np.ndarray) -> tuple:
        """``(mean, sd)`` float32 [D] of the rows of every rank (the
        population standard deviation), in two passes: the mean of float64
        sums, then float64 sums of the squared deviations from it, each
        summed over ranks (numpy's sequential float32 sums give an sd of
        9.927739 for 10 at 2^20 corner points)."""
        n = max(self.n_global if self.counts else len(x), 1)

        def total(fn) -> np.ndarray:
            s = sum(fn(x[p0:p0 + MOMENT_ROWS].astype(np.float64)).sum(0)
                    for p0 in range(0, len(x), MOMENT_ROWS))
            return self.reduce(torch.as_tensor(s)).numpy()

        mean = total(lambda c: c) / n
        var = total(lambda c: np.square(c - mean)) / n
        return mean.astype(np.float32), np.sqrt(var).astype(np.float32)

    def first(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        return all_gather_ints(value)[0] if self.world > 1 else int(value)


def row_layout(n_local: int) -> RowLayout:
    """This rank's :class:`RowLayout` for ``n_local`` rows; every rank
    calls it (one all-gather of the row counts)."""
    return layout_of(all_gather_ints(n_local), rank())


def layout_of(counts, me: int) -> RowLayout:
    """Rank ``me``'s :class:`RowLayout` when the ranks hold ``counts``
    rows.  Raises ``ValueError`` when any rank has no rows (on every rank:
    they all see the same counts)."""
    counts = tuple(int(c) for c in counts)
    if min(counts) < 1:
        raise ValueError(f"every rank needs at least one row; the ranks "
                         f"hold {list(counts)}")
    pads = [_round_up(c, HASH_TILE) for c in counts[:-1]] + [counts[-1]]
    return RowLayout(counts=counts, rank=me, row_start=sum(pads[:me]),
                     n_pad=pads[me], n_global_pad=sum(pads))
