"""The sampler's init (random labels, statistics, the smart init of the
first clusters, the first parameter draw): the median length of the
port's ``entry.init_state`` spans, in s on the device clock.  A steady
cell inits once; in the fit cell (``init_s.fit``) the median covers every
fit of the process: the warm-up, the window and the traced fit.  None
where the port records no such span."""
import statistics


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    secs = [s.seconds for s in profiling.spans()
            if s.name == "entry.init_state"]
    return statistics.median(secs) if secs else None
