"""Kernel B (key sort, partial sums, chunk reduction; also kernel A's
statistics pass): device ms a sweep in the traced span."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.sweeps or not tr["group_s"]["stats"]:
        return None
    return tr["group_s"]["stats"] * 1e3 / ctx.sweeps
