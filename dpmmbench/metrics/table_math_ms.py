"""The table math (every device op that is neither kernel A nor kernel
B: parameter draws, posteriors, split and merge moves, copies and fills):
device ms a sweep in the traced span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.sweeps or not tr["device_ops"]:
        return None
    return tr["group_s"]["other"] * 1e3 / ctx.sweeps
