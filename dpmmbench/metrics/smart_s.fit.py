"""The smart passes of a fit (the init's, and each block's refresh of the
slots split off): for each ``entry.fit`` span the summed length of the
``table_math.smart`` spans under it, in s on the device clock; the median
over every fit of the process: the warm-up, the window and the traced
fit.  None where the port records no such span."""
import statistics


def read(ctx):
    from dpmmsubclusters_tpu_torch.utils import profiling

    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    fits = {s.id: 0.0 for s in spans if s.name == "entry.fit"}
    for s in spans:
        if s.name != "table_math.smart":
            continue
        up = by_id.get(s.parent)
        while up is not None and up.id not in fits:
            up = by_id.get(up.parent)
        if up is not None:
            fits[up.id] += s.seconds
    return statistics.median(fits.values()) if fits else None
