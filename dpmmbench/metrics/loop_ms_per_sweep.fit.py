"""The host loop inside ``fit``: the window's fits' summed block times
(``history.times``, one fence a block of sweeps) over their sweeps, in
ms a sweep."""


def read(ctx):
    if not ctx.fits:
        return None
    sweeps = sum(f["sweeps"] for f in ctx.fits)
    return 1e3 * sum(f["loop_s"] for f in ctx.fits) / sweeps
