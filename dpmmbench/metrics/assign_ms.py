"""Kernel A's assign pass: device ms a sweep in the traced span (the
kernels of ``kernels.json``'s "assign" group)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.sweeps or not tr["group_s"]["assign"]:
        return None
    return tr["group_s"]["assign"] * 1e3 / ctx.sweeps
