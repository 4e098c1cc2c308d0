"""Device-to-host reads of the sampling loop a sweep, in the traced span:
the port's ``host_sync.<site>`` counters summed over its ``sweeps``
counter (both count only while a profiler records).  A steady cell's
blocks are fenced by the benchmark, so there the count is the port's own
reads; ``host_syncs_per_sweep.fit`` counts the traced fit's, the loop's
block fences included.  None where the port keeps no such counters."""


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    sweeps = counts.get("sweeps")
    if not sweeps:
        return None
    return sum(v for name, v in counts.items()
               if name.startswith("host_sync.")) / sweeps
