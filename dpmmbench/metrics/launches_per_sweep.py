"""Device ops (kernels, copies, fills) the host launched a sweep in the
traced span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.sweeps or not tr["device_ops"]:
        return None
    return tr["device_ops"] / ctx.sweeps
