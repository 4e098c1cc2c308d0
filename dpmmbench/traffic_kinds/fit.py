"""Whole ``fit`` calls back to back on host data made once from the
traffic's ``data_seed``: the traffic's set of fit seeds in an order drawn
from ``--seed``, whole passes over the set until ``--seconds`` have
passed; one operation is one fit.  Every fit's recovery is judged, and
the window's last fit's kernel A call and final table.  With ``--trace
1`` the first fit seed of the run's order is fitted once more under the
profiler, so that its untraced wall time is known from the window."""
from __future__ import annotations

from types import SimpleNamespace

from dpmmbench import check, data, harness, system, trace


def run(p, seed, seconds, trace_on, device, clock, t_proc, control=False):
    import numpy as np
    import torch

    d = p.config["data"]
    tr = p.traffic
    pool = list(tr["fit_seeds"])
    order = np.random.default_rng(data.run_seeds(seed, 1)[0]).permutation(
        len(pool))
    seeds = dict(data=int(tr["data_seed"]), warm=int(tr["warmup"]["seed"]),
                 fits=[int(pool[i]) for i in order])
    phases = harness.Phases(torch, clock, t_proc)
    system.load_kernels(device)
    phases.mark("kernels' library")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    x, gt = data.separated_data(d["n"], d["d"], d["k_true"],
                                d["mean_scale"], seeds["data"], device)
    x_host = x.cpu().numpy()
    phases.mark("data")
    iters = int(tr["iters"])
    sampler = dict(p.sampler)
    capture = system.Capture()
    capture.install()
    try:
        for i in range(int(tr["warmup"]["fits"])):
            system.fit(x_host, sampler, iters, seeds["warm"] + i, device)
        phases.mark("warm-up fit")
        t0 = clock()
        setup_s = t0 - t_proc
        fits = []
        while True:
            t = clock()
            stats0 = capture.stats_calls
            fit_seed = seeds["fits"][len(fits) % len(pool)]
            res = system.fit(x_host, sampler, iters, fit_seed, device)
            harness.sync(torch)
            wall = clock() - t
            hist = res.history.times
            fits.append(dict(seed=fit_seed, wall_s=wall,
                             loop_s=float(sum(hist)), sweeps=len(hist),
                             k=res.k,
                             stats_calls=capture.stats_calls - stats0,
                             labels=res.model.labels_raw))
            if clock() - t0 >= seconds and len(fits) % len(pool) == 0:
                break
        window_s = clock() - t0
        call = capture.call() if capture.assign is not None else None
        stats_calls = [capture.stats] if capture.stats is not None else []
        final = system.table_view(res.model.table)
        peak = (torch.cuda.max_memory_allocated()
                if torch.device(device).type == "cuda" else 0)
        harness.log(
            f"{p.name}: {len(fits)} fits in {window_s:.4f} s, set-up "
            f"{setup_s:.3f} s ({phases.report()}); fits (seed, wall s, "
            "loop s, kernel B calls, K): "
            + "; ".join(f"{f['seed']} {f['wall_s']:.3f} {f['loop_s']:.3f} "
                        f"{f['stats_calls']} {f['k']}" for f in fits))
        traced = None
        if trace_on:
            system.reset_counters()
            with system.spans():
                traced = trace.capture(lambda: system.fit(
                    x_host, sampler, iters, seeds["fits"][0], device))
            traced["counters"] = system.counters()
    finally:
        capture.uninstall()
    del res, capture
    harness.sync(torch)
    xs, mean, scale = data.standardized(x)
    del x
    prior = p.ref.standardized_prior(p.ref.default_prior(d["d"], xs.device),
                                     mean, scale)
    numbers, ctl = harness.judge(p, xs, call, stats_calls, final, prior,
                                 control)
    limits = harness.limits_of(p)
    worst = {"k_err": 0.0, "nmi_loss": 0.0}
    bad_fits = 0
    for f in fits:
        r = check.recovery(p.ref, torch.as_tensor(f["labels"],
                                                  device=gt.device),
                           gt, f["k"], d["k_true"])
        bad_fits += int(any(r[key] > limits.get(key, -1.0) for key in r))
        worst = {key: max(worst[key], r[key]) for key in worst}
    numbers.update(worst)
    same = [f["wall_s"] for f in fits if f["seed"] == seeds["fits"][0]]
    ctx = SimpleNamespace(trace=traced, work=None, sweeps=None, sweep_s=None,
                          untraced_s=sum(same) / len(same),
                          fits=[{k: v for k, v in f.items() if k != "labels"}
                                for f in fits])
    return dict(attempted=len(fits), bad=bad_fits, numbers=numbers,
                control=ctl, e2e={"fit_s": window_s / len(fits),
                                  "setup_s": setup_s},
                ctx=ctx, peak=peak)
