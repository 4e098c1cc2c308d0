"""Cells on more than one card: one process a rank, one card a process.

The process that the benchmark's command started is rank 0.  Where the
cell asks for ``chips`` > 1 it builds (or loads) the kernels' library,
then starts ranks 1..chips-1 as child processes of the same interpreter
and module on this host (:class:`Launcher`), and runs rank 0 itself.
Rank r drives ``cuda:r``; the ranks meet at a rendezvous on 127.0.0.1,
where the cell's traffic kind joins the port's process group
(``system.join``).  Rank 0 alone prints the result; a child's numbers
reach it through the process group (:func:`reduce_max`, :func:`gather`),
and a child exits 0, or non-zero where it failed or found JAX loaded.

Rank 0 watches its children: where one exits non-zero, or the run passes
its deadline (the window's seconds and the traffic's ``margin_s``, from
the children's start), every rank is killed and the command exits
non-zero without a result.  A child dies with rank 0 (``PR_SET_PDEATHSIG``).

The collectives here are the harness's own (its barriers, the window's
stop, the judge's float64 sums), called on ``torch.distributed``
directly, never through the port.  In a world of one (no process group)
each is the identity.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from .harness import log

DEADLINE_RC = 4         # the exit code where the run passed its deadline


@dataclasses.dataclass(frozen=True)
class Ranks:
    """One rank of a run: the world's size, this rank, the rendezvous
    (``host:port``) and the kind of device (``cuda`` or ``cpu``)."""

    world: int
    rank: int
    address: str
    device_kind: str

    @property
    def device(self) -> str:
        """This rank's device: ``cuda:<rank>``, or the CPU."""
        return (f"cuda:{self.rank}" if self.device_kind == "cuda"
                else "cpu")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent (rank 0) ends;
    exit at once where it already has."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)         # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(DEADLINE_RC)


class Launcher:
    """Rank 0's children: ranks 1..world-1 of one run, started with the
    command's own arguments, watched until each has ended."""

    def __init__(self, argv: list, world: int, device_kind: str,
                 deadline_s: float):
        self.argv, self.world = list(argv), int(world)
        self.device_kind, self.deadline_s = device_kind, float(deadline_s)
        self.address = f"127.0.0.1:{free_port()}"
        # NCCL's own rendezvous over the loopback device alone, for every
        # rank (the children inherit it)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_IB_DISABLE", "1")
        self.procs = {}
        self._lock = threading.Lock()
        self._done = False
        self._watch = None

    def ranks(self, rank: int) -> Ranks:
        return Ranks(self.world, rank, self.address, self.device_kind)

    def start(self) -> None:
        """Start every child and the watch over them."""
        self.deadline = time.monotonic() + self.deadline_s
        for r in range(1, self.world):
            cmd = [sys.executable, "-m", "dpmmbench", *self.argv,
                   "--rank", str(r), "--world", str(self.world),
                   "--rendezvous", self.address,
                   "--device", self.device_kind, "--parent", str(os.getpid())]
            env = dict(os.environ, LOCAL_RANK=str(r))
            # a child's standard output joins rank 0's errors: only rank 0
            # prints the result
            self.procs[r] = subprocess.Popen(
                cmd, env=env, stdin=subprocess.DEVNULL, stdout=sys.stderr)
        log(f"started ranks 1-{self.world - 1} (pids "
            f"{[p.pid for p in self.procs.values()]}), rendezvous "
            f"{self.address}, deadline {self.deadline_s:.0f} s")
        self._watch = threading.Thread(target=self._watch_loop, daemon=True)
        self._watch.start()

    def _watch_loop(self) -> None:
        while True:
            with self._lock:
                if self._done:
                    return
                for r, proc in self.procs.items():
                    rc = proc.poll()
                    if rc not in (None, 0):
                        self._fail(f"rank {r} exited with code {rc}",
                                   rc if rc > 0 else DEADLINE_RC)
                if time.monotonic() > self.deadline:
                    self._fail(f"the run passed its deadline "
                               f"({self.deadline_s:.0f} s from the ranks' "
                               f"start)", DEADLINE_RC)
            time.sleep(0.2)

    def _fail(self, why: str, rc: int) -> None:
        """Kill every rank and end rank 0 with ``rc``, printing no result
        (called under the lock, from the watch)."""
        log(f"{why}: killing every rank")
        self._kill()
        os._exit(rc)

    def _kill(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs.values():
            proc.wait()

    def kill(self) -> None:
        """Kill every child still running and wait for each (rank 0's own
        failure)."""
        with self._lock:
            self._done = True
            self._kill()

    def wait(self) -> None:
        """Wait until every child has exited 0; the watch ends the run
        where one does not, or where the deadline passes first."""
        while True:
            with self._lock:
                if all(p.poll() == 0 for p in self.procs.values()):
                    self._done = True
                    return
            time.sleep(0.1)


# -- the harness's collectives ------------------------------------------------

def world() -> int:
    import torch.distributed as tdist

    return (tdist.get_world_size()
            if tdist.is_available() and tdist.is_initialized() else 1)


def _comm(t):
    """``t`` on the device the backend takes (the card under NCCL, the
    host under gloo)."""
    import torch
    import torch.distributed as tdist

    if tdist.get_backend() == "nccl":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t.cpu()


def _all_reduce(t, op):
    import torch.distributed as tdist

    if world() == 1:
        return t
    c = _comm(t).contiguous().clone()
    tdist.all_reduce(c, op)
    return c.to(t.device)


def reduce_sum(t):
    """The sum of ``t`` over the ranks, on ``t``'s device."""
    import torch.distributed as tdist

    return _all_reduce(t, tdist.ReduceOp.SUM)


def reduce_max(t):
    """The elementwise largest of ``t`` over the ranks."""
    import torch.distributed as tdist

    return _all_reduce(t, tdist.ReduceOp.MAX)


def gather(t) -> list:
    """Every rank's ``t`` (of one shape on every rank), in rank order, on
    ``t``'s device."""
    import torch.distributed as tdist

    if world() == 1:
        return [t]
    c = _comm(t).contiguous()
    out = [c.new_empty(c.shape) for _ in range(world())]
    tdist.all_gather(out, c)
    return [o.to(t.device) for o in out]


def barrier(device) -> None:
    """Every rank's queued work done, then every rank here."""
    import torch
    import torch.distributed as tdist

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    if world() > 1:
        flag = _comm(torch.zeros(1))
        tdist.all_reduce(flag)
        flag.item()


def rank0_says(value: bool, device) -> bool:
    """Rank 0's ``value`` on every rank (the window's stop)."""
    import torch
    import torch.distributed as tdist

    if world() == 1:
        return bool(value)
    flag = _comm(torch.tensor([int(bool(value))], dtype=torch.int32))
    tdist.broadcast(flag, 0)
    return bool(flag.item())


def max_numbers(numbers: dict) -> dict:
    """Each number the worst (largest) over the ranks; every rank holds the
    same keys.  NaN, a failed reading, is read as infinity."""
    import math

    import torch

    if world() == 1 or not numbers:
        return dict(numbers)
    keys = sorted(numbers)
    v = torch.tensor([math.inf if math.isnan(numbers[k]) else numbers[k]
                      for k in keys], dtype=torch.float64)
    return dict(zip(keys, (float(a) for a in reduce_max(v))))
