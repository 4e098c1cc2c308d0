"""Kernel B (key sort, partial sums, chunk reduction; also kernel A's
statistics pass): its least time over its device time, in %.

Counted from what the inputs need, with the live clusters K: each point's
statistics row read once (the f32 cache, the bf16 cache, or the raw
points, from which the Gaussian rows are built: the hybrid pair's raw
plane), its label, sub-label and valid read once, the [2K, F] sums written
once; operations: one float32 add a feature a point, and one float32
product a built quadratic feature.  Nothing here depends on which kernel
ran.
"""

ROW_BYTES = {"f32_cache": lambda f, d: 4 * f, "bf16_cache": lambda f, d: 2 * f,
             "hybrid": lambda f, d: 4 * d, "raw": lambda f, d: 4 * d}


def least_s(w: dict, peaks: dict) -> float:
    n, d, f, k = w["n"], w["d"], w["f"], w["k_live"]
    nbytes = n * ROW_BYTES[w["rows"]](f, d) + 9 * n + 4 * 2 * k * f
    built = n * (f - 1 - d) if w["rows"] in ("raw", "hybrid") else 0
    return max(nbytes / peaks["hbm_bytes_per_s"],
               (n * f + built) / peaks["fp32_flop_per_s"])


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.work is None or not tr["group_s"]["stats"]:
        return None
    return 100.0 * least_s(ctx.work, ctx.peaks) * ctx.sweeps \
        / tr["group_s"]["stats"]
