"""Kernel A's tensor-core passes at a pass width of 256 that ran, as a
share of those the table width calls for, in the traced span: 100 x the
port's ``kernel_a.passes_run`` counter over its ``kernel_a.passes_width``
(its launches count only while a profiler records, and only where the
width calls for more than one pass).  Below 100 where the launches skip
the passes past the highest live column.  None where the port keeps no
such counters or no such launch was counted."""


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    width = counts.get("kernel_a.passes_width")
    if not width:
        return None
    return 100.0 * counts.get("kernel_a.passes_run", 0) / width
