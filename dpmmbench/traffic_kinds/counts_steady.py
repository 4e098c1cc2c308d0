"""Steady sweeps over count documents: the ``steady`` kind's blocks of
``block`` sweeps through ``DPMMEngine.step_block`` at the configuration's
fixed width, fenced once a block, after a warm-up from the generator's
labels, but on counts made by ``counts.mnmm_data`` and never centred
(centring would turn counts negative).  One operation is one sweep.  The
judge takes kernel A's last call of the window and the final table; a
window that leaves the sub-labels and weights as they were is not correct
(``stale_state``)."""
from __future__ import annotations

from types import SimpleNamespace

from dpmmbench import check, counts, data, harness, system, trace


def run(p, seed, seconds, trace_on, device, clock, t_proc, control=False):
    import torch

    d = p.config["data"]
    tr = p.traffic
    seeds = dict(zip(("data", "sampler"), data.run_seeds(seed, 2)))
    phases = harness.Phases(torch, clock, t_proc)
    system.load_kernels(device)
    phases.mark("kernels' library")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    x, gt, _ = counts.mnmm_data(d["n"], d["d"], d["k_true"], d["trials"],
                                seeds["data"], device)
    phases.mark("data")
    sampler = dict(p.sampler, init_clusters=d["k_true"])
    capture = system.Capture()
    capture.install()
    try:
        engine = system.make_engine(p.config["family"], sampler, device)
        points, valid, n_total = system.place(engine, x, seeds["sampler"])
        state = system.init_state(engine, points, valid, d["d"],
                                  seeds["sampler"], gt.cpu().numpy())
        phases.mark("init")
        block = int(tr["block"])
        flags = dict(final=tr["finals"], no_more_splits=tr["no_more_splits"])

        def blocks(count):
            nonlocal state, k
            for _ in range(count):
                state, k = system.run_block(engine, state, points, valid,
                                            n_total, block, **flags)

        k = None
        blocks(int(tr["warmup"]["blocks"]))
        start_sub = state.sublabels.clone()
        start_w = state.table["log_weights"].clone()
        stats0 = capture.stats_calls
        phases.mark("warm-up")
        t0 = clock()
        setup_s = t0 - t_proc
        sweeps, times = 0, []
        while True:
            t = clock()
            blocks(1)
            times.append(clock() - t)
            sweeps += block
            if clock() - t0 >= seconds:
                break
        harness.sync(torch)
        window_s = clock() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        harness.log(
            f"{p.name}: {sweeps} sweeps in {window_s:.4f} s, K={k}, set-up "
            f"{setup_s:.3f} s ({phases.report()}), peak {peak} bytes; block "
            f"seconds {harness.spread(times)}; kernel B calls "
            f"{capture.stats_calls - stats0}")
        harness.log("block seconds in order: "
                    + " ".join(f"{b:.4f}" for b in times))
        traced = None
        if trace_on:
            system.reset_counters()
            span_blocks = int(tr["trace"]["blocks"])
            with system.spans():
                traced = trace.capture(lambda: blocks(span_blocks))
            traced["sweeps"] = span_blocks * block
            traced["counters"] = system.counters()
        stale = bool(torch.equal(state.sublabels, start_sub)
                     and torch.equal(state.table["log_weights"], start_w))
        call = capture.call() if capture.assign is not None else None
        stats_calls = ([capture.stats] if capture.stats_calls > stats0
                       else [])
    finally:
        capture.uninstall()
    final = system.table_view(state.table)
    labels = state.labels
    k_final = int(final["active"].sum())
    # the port's state is freed before the reference runs
    del engine, points, state, capture, start_sub, start_w
    harness.sync(torch)
    if cuda:
        torch.cuda.empty_cache()
    prior = p.ref.default_prior(d["d"], x.device)
    numbers, ctl = harness.judge(p, x, call, stats_calls, final, prior,
                                 control)
    numbers.update(check.recovery(p.ref, labels, gt, k_final, d["k_true"]))
    numbers["stale_state"] = float(stale)
    sweep_s = window_s / sweeps
    ctx = SimpleNamespace(
        trace=traced, work=harness.work(p, k), fits=None,
        sweeps=traced["sweeps"] if traced else None, sweep_s=sweep_s,
        untraced_s=sweep_s * traced["sweeps"] if traced else None)
    return dict(attempted=sweeps, bad=0, numbers=numbers, control=ctl,
                e2e={"sweep_ms": sweep_s * 1e3, "peak_mem_gb": peak / 1e9,
                     "setup_s": setup_s},
                ctx=ctx, peak=peak)
