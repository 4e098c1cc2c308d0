"""The family's conjugate math (its parameter draws, posteriors and log
marginals: NIW's Cholesky factors and Wishart draws, or Dirichlet's Gamma
draws and lgamma sums): the port's ``table_math.family.*`` spans, those
not inside another such span, summed over its ``sweeps`` counter, in ms a
sweep on the device clock, in the traced span (both are recorded only
while a profiler records).  None where the port records no such span."""

PREFIX = "table_math.family."


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    sweeps = profiling.counters().get("sweeps")
    spans = profiling.spans()
    family = {s.id for s in spans if s.name.startswith(PREFIX)}
    secs = [s.seconds for s in spans
            if s.id in family and s.parent not in family]
    if not sweeps or not secs:
        return None
    return 1e3 * sum(secs) / sweeps
