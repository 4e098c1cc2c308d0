"""The share of the traced work's untraced wall time in which no device
op ran, in %: 1 - (the union of the device ops' intervals in the trace) /
(the wall time the same work took untraced: the window's seconds a sweep
times the traced sweeps, or the window's fits of the traced fit's seed).
The profiler's own host cost stretches a host-bound span's wall time, not
its device time, so the untraced wall time is the one divided by.  On
several ranks, rank 0's ops outside the collectives (``compute_busy_s``):
under the profiler the ranks fall out of step and a collective's kernel
spins for the others, so its device time is the profiler's, not the
window's."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["device_ops"] or not ctx.untraced_s:
        return None
    return 100.0 * (1.0 - tr.get("compute_busy_s", tr["busy_s"])
                    / ctx.untraced_s)
