"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port; names compare as whole top-level
names (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from tinybench import REPO

BENCH = REPO / "dpmmbench"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(imported(path))
        assert "dpmmsubclusters_tpu_torch" not in names, path
        assert not names & {"jax", "jaxlib", "flax", "dpmmsubclusters_tpu"}


def test_only_system_and_the_readers_import_the_port_and_none_jax():
    """``system.py`` drives the port; the readers of ``metrics/`` read its
    spans and counters; nothing else imports it."""
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(imported(path))
        assert not names & {"jax", "jaxlib", "flax", "dpmmsubclusters_tpu"}
        if path.name != "system.py" and path.parent.name != "metrics":
            assert "dpmmsubclusters_tpu_torch" not in names, path


GUARD = """
import sys
from dpmmbench import harness
sys.modules["dpmmsubclusters_tpu_torch_x"] = sys
assert harness.forbidden_modules() == [], harness.forbidden_modules()
sys.modules["jax.numpy"] = sys
sys.modules["dpmmsubclusters_tpu.ops"] = sys
assert harness.forbidden_modules() == ["dpmmsubclusters_tpu.ops",
                                       "jax.numpy"]
"""


def test_the_guard_compares_whole_top_level_names():
    """In a fresh process, which a test session that imports JAX is not."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
