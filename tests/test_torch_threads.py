"""The port's test processes share the cores they may run on
(``tests/torch_threads.py``): torch's thread count in a port test module
follows the helper's rule, and every port test module imports the helper
before anything else."""
import torch_threads

import ast
import os
import pathlib

import torch

TESTS = pathlib.Path(__file__).resolve().parent


def test_torch_threads_are_this_process_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    want = max(1, len(os.sched_getaffinity(0)) // workers)
    assert torch_threads.THREADS == want
    assert torch.get_num_threads() == want
    # the processes the tests start inherit a share too
    assert int(os.environ["OMP_NUM_THREADS"]) >= 1
    assert int(os.environ["MKL_NUM_THREADS"]) >= 1


def test_every_port_test_module_imports_the_helper_first():
    files = sorted(TESTS.glob("test_torch_*.py"))
    assert len(files) > 30, files
    late = []
    for path in files:
        imports = [node for node in ast.parse(path.read_text()).body
                   if isinstance(node, (ast.Import, ast.ImportFrom))
                   and getattr(node, "module", None) != "__future__"]
        first = imports[0] if imports else None
        if not (isinstance(first, ast.Import)
                and [a.name for a in first.names] == ["torch_threads"]):
            late.append(path.name)
    assert not late, f"import torch_threads first in {late}"
