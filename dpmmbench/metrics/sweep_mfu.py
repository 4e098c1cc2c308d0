"""The whole sweep's share of the card's peak, in %: the sweep's least
time over the wall time a sweep of the same run's measured window (the
untraced one: the profiler's host overhead would lengthen a host-bound
sweep twofold).

The least time counts kernel A's and kernel B's work once for the sweep,
with the live clusters K: the row sources read once (the f32 cache; the
bf16 cache; the bf16 cache and the raw points of the hybrid pair; or the
raw points), valid, the coefficients and log-weights read, labels and
sub-labels written, the [2K, F] sums written; the ll product's passes at
their peak, plus one float32 add a feature a point and one float32
product a built quadratic feature.  The table math is not counted.
Nothing here depends on which kernel ran.
"""

ROW_BYTES = {"f32_cache": lambda f, d: 4 * f, "bf16_cache": lambda f, d: 2 * f,
             "hybrid": lambda f, d: 2 * f + 4 * d, "raw": lambda f, d: 4 * d}


def least_s(w: dict, peaks: dict) -> float:
    n, d, f, k = w["n"], w["d"], w["f"], w["k_live"]
    nbytes = (n * ROW_BYTES[w["rows"]](f, d) + n + 4 * (2 * f * k + k)
              + 8 * n + 4 * 2 * k * f)
    product = 2.0 * n * f * (k + 1) * w["passes"]
    built = n * (f - 1 - d) if w["rows"] in ("raw", "hybrid") else 0
    t_flop = product / peaks[f"{w['peak']}_flop_per_s"] \
        + (n * f + built) / peaks["fp32_flop_per_s"]
    return max(nbytes / peaks["hbm_bytes_per_s"], t_flop)


def read(ctx):
    if ctx.trace is None or ctx.work is None or not ctx.trace["device_ops"]:
        return None
    return 100.0 * least_s(ctx.work, ctx.peaks) / ctx.sweep_s
