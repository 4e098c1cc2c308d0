"""The comparison that decides a run's ``correct``.

It judges what the timed path produced against the plain float64
reference of ``reference/``:

* ``assign_gap`` (nats): kernel A's last call of the window.  For each
  point, how far the noisy logit of the label the port chose lies below
  the reference's best, and, where the port's sub-label and the
  reference's disagree, the reference's margin of that decision; the
  widest over all points.  The noise is the port's counter hash (a frozen
  copy), so a sound port reads rounding only.
* ``label_flips``: an exact count, limited at 0: the points whose label's
  noisy logit lies below the reference's best by more than the rounding
  of the stated ll precision can explain (:data:`TIE_EPS` times each
  side's sum of |feature x coefficient|), so a label moved where it is
  produced counts even where its statistics were made to agree.
* ``stats_err``: the statistics of kernel A's last call (and of the last
  kernel B call, where the window made one) against float64 sums of the
  points by the labels and sub-labels that call was given or produced:
  the worst (slot, side), as the largest entry's gap over that slot's
  largest entry or the median slot's, whichever is larger.
* ``post_err``: the final table's posterior against the reference's NIW
  posterior of the table's own statistics and the benchmark's prior, by
  the same worst-slot measure over kappa, m, nu and psi.
* ``k_err`` and ``nmi_loss``: the recovery, |K - K_true| and 1 - NMI of
  the final labels against the generator's labels.

The reference module is the configuration's (its ``reference`` key:
``reference/gauss.py`` for the Gaussian family); the noise is the port's
counter hash, frozen in ``reference/gumbel.py``.

``control`` puts the reference in the port's place in the next precision
below the stated one (the reference module's ``LOWER``) and judges it the same
way: its labels and sub-labels from rounded rows and coefficients with
the same noise, its statistics from rounded rows, its posterior in that
precision.
"""
from __future__ import annotations

import torch

from .reference import gumbel

BLOCK_VALUES = 1 << 26     # float64 feature values a block holds
# The rounding of a logit that the stated ll precision allows, relative
# to its row's sum of |f_i c_i| (and |log w|): one bf16 pass rounds the
# cache stochastically (< 1 ulp, 2^-7) and the coefficients to nearest
# (2^-8), and adds F terms in float32 (F 2^-24 < 2^-12.9 for F <= 2145):
# under 2^-6.4; the float32-faithful three-pass split drops lo x lo and
# rounds the lo parts (3 x 2^-16) besides the same adds: under 2^-12.5.
TIE_EPS = {"bfloat16": 2.0 ** -6, "float32": 2.0 ** -12}


def _live(log_w: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(torch.isfinite(log_w))[:, 0]


def _noisy_best(logit, s, rit, slots, width: int, hard: bool):
    """(index into columns, value) of each row's largest ``logit + G``,
    with G the counter-hash noise at slot ``slots[j]`` of a
    ``width``-wide draw; only columns within the noise's range of the
    row's largest logit can win, so only theirs is drawn."""
    if hard:
        val, idx = logit.max(1)
        return idx, val
    top = logit.max(1).values
    cand = torch.nonzero(logit >= (top - gumbel.G_MAX - 4.0)[:, None])
    r, j = cand[:, 0], cand[:, 1]
    v = logit[r, j] + gumbel.noise(s[r], rit[r], slots[j], width)
    best = torch.full_like(top, -torch.inf).scatter_reduce(
        0, r, v, "amax")
    win = v == best[r]
    idx = torch.zeros(logit.shape[0], dtype=torch.long, device=logit.device)
    idx[r[win]] = j[win]
    return idx, best


def _label_value(logit, col, s, rit, slots, width: int, hard: bool):
    """Each row's ``logit + G`` at its column ``col`` (-inf where col <
    0)."""
    rows = torch.arange(logit.shape[0], device=logit.device)
    ok = col >= 0
    c = col.clamp(min=0)
    v = logit[rows, c]
    if not hard:
        v = v + gumbel.noise(s, rit, slots[c], width)
    return torch.where(ok, v, -torch.inf)


class AssignCall:
    """Kernel A's inputs as the sampler's state holds them (drawn
    parameters [K, 3, ...]: whole, left, right; log-weights [K];
    sub-cluster weights [K, 2]; the hash seed and flags) and its
    outputs (labels, sub-labels [N], statistics [K, 2, F])."""

    def __init__(self, ref, params, log_w, lr_w, seed: int, hard: bool,
                 tile: int, tile_off: int, labels, sub, stats):
        self.width = log_w.shape[0]
        self.log_w = log_w.to(torch.float64)
        self.live = _live(log_w)
        self.hard, self.seed = bool(hard), int(seed)
        self.tile, self.tile_off = int(tile), int(tile_off)
        self.labels, self.sub, self.stats = labels, sub, stats
        self.coeff_w = ref.coeffs(params, 0, self.live)
        # the sub-label's delta: right less left, with the log ratio of
        # the sub-cluster weights (clamped as the sampler clamps them)
        lrw = torch.log(torch.clamp(lr_w.to(torch.float64), min=1e-37))
        cl = ref.coeffs(params, 1)
        cr = ref.coeffs(params, 2)
        delta = (cr - cl).T.clone()                          # [K, F]
        delta[:, 0] += lrw[:, 1] - lrw[:, 0]
        self.delta = delta
        self.col_of = torch.full((self.width,), -1, dtype=torch.long,
                                 device=log_w.device)
        self.col_of[self.live] = torch.arange(self.live.numel(),
                                              device=log_w.device)


GAPS = ("label_gap", "sub_gap", "sub_flips", "label_flips")
COUNTS = ("sub_flips", "label_flips")


def _gaps(g: dict, n: int) -> dict:
    """The judged gaps: the widest of labels and sub-labels together
    (``assign_gap``), each apart, the share of points whose sub-label lies
    on the other side of the reference's decision, and the count of
    labels moved beyond a tie."""
    return {"assign_gap": max(g["label_gap"], g["sub_gap"]),
            "label_gap": g["label_gap"], "sub_gap": g["sub_gap"],
            "sub_flip_rate": g["sub_flips"] / n,
            "label_flips": g["label_flips"]}


def _add(into: dict, got: dict) -> None:
    """Fold one block's gaps into the run's: counts add, gaps take the
    widest."""
    for key, v in got.items():
        into[key] = into[key] + v if key in COUNTS else max(into[key], v)


def _block_rows(f: int) -> int:
    return max(1024, BLOCK_VALUES // f)


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst leaf (first dimension) of |got - want|, each leaf's largest
    gap over the larger of its own largest |want| and the median leaf's."""
    if want.numel() == 0:
        return 0.0
    g = got.reshape(got.shape[0], -1).to(torch.float64)
    w = want.reshape(want.shape[0], -1).to(torch.float64)
    scale = w.abs().amax(1)
    floor = scale.median().clamp(min=1e-30)
    return float(((g - w).abs().amax(1) / torch.maximum(scale, floor)).max())


def _stats_leaves(stats_k2f: torch.Tensor, ref_2kf: torch.Tensor):
    """Program [K, 2, F] and reference [2K, F] (sub * K + label) as
    matching [2K, F] leaves, keeping slots either side gives points."""
    prog = torch.cat([stats_k2f[:, 0], stats_k2f[:, 1]], 0).to(torch.float64)
    used = (prog[:, 0] != 0) | (ref_2kf[:, 0] != 0)
    return prog[used], ref_2kf[used]


def judge_sweep(ref, x, call: AssignCall, stats_calls, tie: float,
                control=None, reduce=None):
    """Kernel A's last call judged over every point in blocks by the
    reference module ``ref``, with the statistics of ``stats_calls``
    ((labels, sub, stats [K, 2, F]) each); ``tie`` is the stated ll
    precision's :data:`TIE_EPS`.
    With ``control`` = {"ll": precision, "stats": precision}, the
    control's labels, sub-labels and statistics are made in the same pass
    and judged alike.  Returns :func:`_gaps` and "stats_err" (and
    "control": the same of the control).  Float32 products (the
    control's) run without TF32.  Across ranks, whose statistics the port
    sums over every rank (in place of kernel A's and kernel B's outputs),
    ``reduce`` sums the reference's float64 sums of this rank's points
    over the ranks before they are compared."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, dev = x.shape[0], x.device
    k = call.width
    f = ref.feature_dim(x.shape[1])
    acc = {"prog": torch.zeros((2 * k, f), dtype=torch.float64, device=dev)}
    stats_acc = [torch.zeros((2 * k, f), dtype=torch.float64, device=dev)
                 for _ in stats_calls]
    gap = {"prog": dict.fromkeys(GAPS, 0.0)}
    if control:
        acc["ctl"] = torch.zeros_like(acc["prog"])
        acc["ctl_q"] = torch.zeros((2 * k, f), dtype=torch.float32,
                                   device=dev)
        gap["ctl"] = dict.fromkeys(GAPS, 0.0)
        cw_q = ref.quantize(call.coeff_w, control["ll"])
        delta_q = ref.quantize(call.delta.T, control["ll"]).T
    slots = call.live
    for p0 in range(0, n, _block_rows(f)):
        p1 = min(n, p0 + _block_rows(f))
        rows = torch.arange(p0, p1, device=dev)
        feats = ref.features(x[p0:p1])
        logit = feats @ call.coeff_w + call.log_w[slots]
        # each logit's rounding scale: sum over the row of |f_i c_i|
        size = feats.abs() @ call.coeff_w.abs() + call.log_w[slots].abs()
        s = gumbel.tile_seeds(call.seed, rows, call.tile, call.tile_off)
        rit = rows % call.tile
        s_sub = s ^ gumbel.SUB_SALT
        g_sub = (gumbel.noise(s_sub, rit, torch.ones_like(rit), 2)
                 - gumbel.noise(s_sub, rit, torch.zeros_like(rit), 2))
        best_col, best = _noisy_best(logit, s, rit, slots, k, call.hard)
        best_size = size.gather(1, best_col[:, None])[:, 0]

        def judge(lab, side):
            lab = lab.long()
            col = call.col_of[lab.clamp(0, k - 1)]
            col = torch.where((lab >= 0) & (lab < k), col, -1)
            v = _label_value(logit, col, s, rit, slots, k, call.hard)
            margin = (feats * call.delta[lab.clamp(0, k - 1)]).sum(1) + g_sub
            wrong = (margin > 0) != (side != 0)
            own = size.gather(1, col.clamp(min=0)[:, None])[:, 0]
            return {"label_gap": float((best - v).max()),
                    "sub_gap": float(torch.where(wrong, margin.abs(),
                                                 0.0).max()),
                    "sub_flips": float(wrong.sum()),
                    "label_flips": float(
                        ((best - v) > tie * (own + best_size)).sum())}

        lab, side = call.labels[p0:p1], call.sub[p0:p1]
        _add(gap["prog"], judge(lab, side))
        acc["prog"] += ref.sums_by_key(feats, side.long() * k + lab.long(),
                                         2 * k)
        for i, (sl, ss, _) in enumerate(stats_calls):
            stats_acc[i] += ref.sums_by_key(
                feats, ss[p0:p1].long() * k + sl[p0:p1].long(), 2 * k)
        if control:
            fq = ref.quantize(feats, control["ll"])
            logit_q = (fq @ cw_q).to(torch.float64) + call.log_w[slots]
            col_q = _noisy_best(logit_q, s, rit, slots, k, call.hard)[0]
            lab_q = slots[col_q]
            m_q = (fq * delta_q[lab_q]).sum(1).to(torch.float64) + g_sub
            side_q = (m_q > 0).to(torch.int32)
            _add(gap["ctl"], judge(lab_q, side_q))
            key = side_q.long() * k + lab_q
            acc["ctl"] += ref.sums_by_key(feats, key, 2 * k)
            acc["ctl_q"] += ref.sums_by_key(
                ref.quantize(feats, control["stats"]), key, 2 * k)
    if reduce is not None:
        acc = {key: reduce(v) for key, v in acc.items()}
        stats_acc = [reduce(a) for a in stats_acc]
    errs = [_leaf_err(*_stats_leaves(call.stats, acc["prog"]))]
    errs += [_leaf_err(*_stats_leaves(st, a))
             for (_, _, st), a in zip(stats_calls, stats_acc)]
    out = {**_gaps(gap["prog"], n), "stats_err": max(errs)}
    if control:
        q = acc["ctl_q"].to(torch.float64)
        q_k2f = torch.stack([q[:k], q[k:]], 1)
        out["control"] = {**_gaps(gap["ctl"], n),
                          "stats_err": _leaf_err(*_stats_leaves(
                              q_k2f, acc["ctl"]))}
    return out


def judge_posterior(ref, active, stats: dict, post: dict, prior: dict,
                    control_precision=None) -> dict:
    """The table's posterior of its active slots (all three sides) against
    the reference's posterior of the same statistics and the benchmark's
    ``prior`` (unbatched); with ``control_precision`` also the posterior
    computed in that precision (the control)."""
    idx = torch.nonzero(active)[:, 0]
    st = {name: v[idx] for name, v in stats.items()}
    shape = st["n"].shape
    pr = {name: v.to(torch.float64).expand(shape + v.shape)
          for name, v in prior.items()}
    want = ref.posterior(pr, st)

    def err(got):
        return max(_leaf_err(got[name].reshape(shape.numel(), -1),
                             want[name].reshape(shape.numel(), -1))
                   for name in want)

    out = {"post_err": err({name: post[name][idx] for name in want})}
    if control_precision:
        dtype = {"bfloat16": torch.bfloat16,
                 "float32": torch.float32}[control_precision]
        out["control"] = {"post_err": err(ref.posterior(pr, st, dtype))}
    return out


def recovery(ref, labels, gt, k: int, k_true: int) -> dict:
    return {"k_err": float(abs(int(k) - int(k_true))),
            "nmi_loss": 1.0 - ref.nmi(labels, gt)}


def contingency(labels, gt, k_slots: int, k_true: int) -> torch.Tensor:
    """int64 [k_slots, k_true] counts of the points by (label, generator
    label); tables of several ranks' points add."""
    key = labels.long() * k_true + gt.long()
    return torch.bincount(key, minlength=k_slots * k_true).view(
        k_slots, k_true)


def recovery_from_table(ref, table, k: int, k_true: int) -> dict:
    """:func:`recovery` of the points counted in a contingency table (the
    ranks' tables summed)."""
    return {"k_err": float(abs(int(k) - int(k_true))),
            "nmi_loss": 1.0 - ref.nmi_of_table(table)}


def table_digest(table) -> str:
    """sha256 of every value of a cluster table (nested dicts, sorted
    keys): equal on every rank where the table is replicated."""
    import hashlib

    h = hashlib.sha256()

    def walk(node, prefix):
        for key in sorted(node):
            v = node[key]
            h.update(f"{prefix}{key}".encode())
            if isinstance(v, dict):
                walk(v, f"{prefix}{key}/")
            elif torch.is_tensor(v):
                h.update(str(v.dtype).encode())
                h.update(v.detach().cpu().contiguous().view(-1).view(
                    torch.uint8).numpy().tobytes())
            else:
                h.update(repr(v).encode())

    walk(table, "")
    return h.hexdigest()
