"""``fit``'s centering and standardization of the host points (and of the
prior): the median length of the port's ``entry.standardize`` spans, in
s on the device clock, over every fit of the process: the warm-up, the
window and the traced fit.  None where the port records no such span."""
import statistics


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    secs = [s.seconds for s in profiling.spans()
            if s.name == "entry.standardize"]
    return statistics.median(secs) if secs else None
