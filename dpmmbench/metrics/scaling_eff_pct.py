"""Weak-scaling efficiency: 100 x the ms a sweep of a world of one over
rank 0's own rows and cache (timed after the window, while the other
ranks wait) / the window's ``sweep_ms`` over every rank.  None where no
world of one was timed."""


def read(ctx):
    one = getattr(ctx, "one_rank_sweep_s", None)
    if not one or not ctx.sweep_s:
        return None
    return 100.0 * one / ctx.sweep_s
