"""The benchmark of ``dpmmsubclusters_tpu_torch`` on one NVIDIA H100.

``python3 -m dpmmbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once (``__main__.py``).  The
harness (``harness.py``) finds each configuration, traffic mix, limits
file and per-layer metric by name in ``configs/``, ``traffic/``,
``limits/`` and ``metrics/``, the runner of each kind of traffic in
``traffic_kinds/`` and each configuration's reference module by the path
it names; ``system.py`` is the one module that imports the port;
``reference/`` is the plain float64 reference that ``check.py`` judges
the port against.
"""
