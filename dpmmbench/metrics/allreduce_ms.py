"""The port's collectives (its sum over the ranks of each statistics
pass, and the smart pass's sums and maxima): rank 0's device ms a sweep
in NCCL's kernels (``kernels.json``'s "allreduce" group) over the traced
blocks, the wait for the slowest rank included, since a collective's
kernel spins until every rank has arrived.  None without such kernels
(off a card, or on one card)."""


def read(ctx):
    return getattr(ctx, "allreduce_ms", None)
