"""A device trace of one short span, reduced to what the per-layer
readers and the result's ``breakdown`` take.

``torch.profiler`` records the host (CPU ops and the benchmark's layer
spans) and the card (kernels, copies and fills).  The Chrome trace it
exports is read back once: device intervals inside the span, their union
(the busy time), the idle gaps between them, each gap named by the
innermost host span and op that ran at its middle, and the device time of
each kernel group of ``kernels.json``.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import torch

SPAN = "dpmmbench.traced_span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 120


def capture(fn, apart=()) -> dict:
    """Run ``fn()`` under the profiler inside one named span, synchronize,
    and return :func:`reduce` of the exported trace (``apart`` as
    there)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, apart)


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events, points):
    """For each time in ``points``, the name of the innermost of the
    properly nested intervals ``events`` ((start, end, name)) holding it,
    or None; one sweep over both, sorted."""
    order = sorted(range(len(points)), key=points.__getitem__)
    evs = sorted(events, key=lambda e: (e[0], -e[1]))
    out = [None] * len(points)
    stack, i = [], 0
    for q in order:
        t = points[q]
        while i < len(evs) and evs[i][0] <= t:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce(events: list, apart=()) -> dict:
    """The span's window and busy seconds, its device ops (count, seconds
    by name), and its idle seconds by what the host was doing.  Where
    ``apart`` names substrings of kernel names (the collectives), also
    ``compute_busy_s``: the busy seconds of every other op."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    tid = span[0].get("tid")
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            a = max(t0, float(e["ts"]))
            b = min(t1, float(e["ts"]) + float(e.get("dur", 0.0)))
            if b > a:
                dev.append((a, b, e["name"]))
    busy = _union([(a, b) for a, b, _ in dev])
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if busy and t1 > prev:
        gaps.append((prev, t1))
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("tid") == tid and e.get("name") != SPAN
            and e.get("ph") == "X"]
    mids = [(a + b) / 2 for a, b in gaps]
    spans = _innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in host
                        if e.get("cat") == "user_annotation"], mids)
    ops = _innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in host if e.get("cat") == "cpu_op"],
                     mids)
    idle = {}
    for (a, b), s, o in zip(gaps, spans, ops):
        label = " > ".join(v for v in (s, o) if v) or "outside any op"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top = lambda d: [[_short(k), v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    out = {"window_s": (t1 - t0) * 1e-6,
           "busy_s": sum(b - a for a, b in busy) * 1e-6,
           "device_ops": len(dev),
           "device_s_by_name": by_name,
           "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}
    if apart:
        out["compute_busy_s"] = sum(
            b - a for a, b in _union([(a, b) for a, b, name in dev
                                      if not any(p in name for p in apart)])
        ) * 1e-6
    return out


def group_seconds(trace: dict, groups: dict) -> dict:
    """Device seconds of each kernel group (``kernels.json``: group ->
    substrings of kernel names) and of the rest, "other"."""
    out = dict.fromkeys(list(groups) + ["other"], 0.0)
    for name, secs in trace["device_s_by_name"].items():
        hit = next((g for g, pats in groups.items()
                    if any(p in name for p in pats)), "other")
        out[hit] += secs
    return out
