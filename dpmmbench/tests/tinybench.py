"""A copy of the benchmark's files cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = dict(n=4096, d=4, k_true=4, mean_scale=25.0)
TINY_SAMPLER = dict(k_max=16, merge_candidates=16)


def make_tiny(root: Path, fit_iters: int = 30, sizes=None) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder under
    ``root``, its configurations at 4096 x 4-d, K=4, width 16 (means x25,
    as far apart in 4-d as x8 puts them in 32-d), or at ``sizes[name]``
    ({"data": ..., "sampler": ...}) where given; returns the copy's
    ``BENCHMARK.json``."""
    shutil.copytree(REPO / "dpmmbench", root / "dpmmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (root / "dpmmbench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        size = (sizes or {}).get(c["name"], {})
        c["data"].update(TINY, **size.get("data", {}))
        c["sampler"].update(TINY_SAMPLER, **size.get("sampler", {}))
        p.write_text(json.dumps(c))
    fit = root / "dpmmbench" / "traffic" / "fit.json"
    t = json.loads(fit.read_text())
    t["iters"] = fit_iters
    fit.write_text(json.dumps(t))
    bench = root / "BENCHMARK.json"
    shutil.copy(REPO / "BENCHMARK.json", bench)
    return bench
