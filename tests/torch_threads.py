"""Each test process's share of the cores for torch's CPU threads.

Every ``tests/test_torch_*.py`` imports this module before it does any
torch work.  Under pytest-xdist each worker is a process of its own, and
torch's default of one intra-op thread per core in every worker puts
several busy threads on each core: the workers then spend their time
waiting on one another.  So each process takes an equal share of the cores
it may run on, split over ``PYTEST_XDIST_WORKER_COUNT`` workers (one in a
run without xdist), at least one thread.  ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS``, unless already set, carry the same share to the
processes the tests start (the CLI's; ``torch_dist_worker.py`` gives its
ranks one thread each).
"""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, len(os.sched_getaffinity(0)) // _workers)
torch.set_num_threads(THREADS)
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_name, str(THREADS))
