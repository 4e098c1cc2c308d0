"""Kernel A's assign pass: its least time over its device time, in %.

The least time is the larger of the bytes it must move at the card's
memory bandwidth and the operations it must do at the peak of the stated
precision (``peaks.json``).  It counts what the inputs need, with the
live clusters K of the traced sweep, not the table's width: each point's
row is read once (the f32 cache, the bf16 cache, or the raw points from
which it builds the row), with valid, the K whole columns and K delta
columns of coefficients and the K log-weights; labels and sub-labels are
written once.  Operations: 2 F (K + 1) a point (K whole columns and the
label's delta column) a pass of the ll product, at bf16's peak for each
of its bf16 passes (three for the float32-faithful split) or float32's
for the exact product; rows built from the raw points add one float32
product a quadratic feature.  Nothing here depends on which kernel ran.
"""

ROW_BYTES = {"f32_cache": lambda f, d: 4 * f, "bf16_cache": lambda f, d: 2 * f,
             "hybrid": lambda f, d: 2 * f, "raw": lambda f, d: 4 * d}


def least_s(w: dict, peaks: dict) -> float:
    n, d, f, k = w["n"], w["d"], w["f"], w["k_live"]
    nbytes = n * ROW_BYTES[w["rows"]](f, d) + n + 4 * (2 * f * k + k) + 8 * n
    flop = 2.0 * n * f * (k + 1) * w["passes"]
    built = n * (f - 1 - d) if w["rows"] == "raw" else 0
    t_flop = flop / peaks[f"{w['peak']}_flop_per_s"] \
        + built / peaks["fp32_flop_per_s"]
    return max(nbytes / peaks["hbm_bytes_per_s"], t_flop)


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.work is None or not tr["group_s"]["assign"]:
        return None
    return 100.0 * least_s(ctx.work, ctx.peaks) * ctx.sweeps \
        / tr["group_s"]["assign"]
