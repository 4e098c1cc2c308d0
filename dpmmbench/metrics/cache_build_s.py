"""The feature cache's build (``engine.featurize``: for the hybrid cache
the bf16 rows with stochastic rounding): the median length of the port's
``cache_build.featurize`` spans, in s on the device clock.  None where the
port records no such span."""
import statistics


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    secs = [s.seconds for s in profiling.spans()
            if s.name == "cache_build.featurize"]
    return statistics.median(secs) if secs else None
