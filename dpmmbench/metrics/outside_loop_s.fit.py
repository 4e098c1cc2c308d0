"""Entry and cache build of ``fit``: a fit's wall time less its blocks'
time (standardization, transfer, cache, init and the tier steps), the
mean over the window's fits, in s."""


def read(ctx):
    if not ctx.fits:
        return None
    return sum(f["wall_s"] - f["loop_s"] for f in ctx.fits) / len(ctx.fits)
