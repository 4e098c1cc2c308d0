"""The parameter draws (step A: the NIW posterior draws and the weights):
the port's ``table_math.sample_params`` spans summed over its ``sweeps``
counter, in ms a sweep on the device clock, in the traced span (both are
recorded only while a profiler records).  None where the port records no
such span."""


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    sweeps = profiling.counters().get("sweeps")
    secs = [s.seconds for s in profiling.spans()
            if s.name == "table_math.sample_params"]
    if not sweeps or not secs:
        return None
    return 1e3 * sum(secs) / sweeps
