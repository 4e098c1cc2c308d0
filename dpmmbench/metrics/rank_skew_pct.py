"""How unevenly the ranks' cards work: 100 x (the largest less the smallest
of the ranks' device ms a sweep outside the NCCL kernels) / the largest,
over the same traced blocks, each rank's from its own trace.  None
without a trace of two ranks or more."""


def read(ctx):
    ms = getattr(ctx, "rank_ms", None)
    if not ms or len(ms) < 2 or max(ms) <= 0:
        return None
    return 100.0 * (max(ms) - min(ms)) / max(ms)
