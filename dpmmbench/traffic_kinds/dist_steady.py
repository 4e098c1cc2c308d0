"""Steady sweeps of one chain sharded over ranks, one card a rank: the
``steady`` kind's blocks of ``block`` sweeps through
``DPMMEngine.step_block`` on every rank, each over its own rows and
cache, the table replicated and every statistics pass summed over the
ranks by the port's collectives (its engine over ``row_layout``).

Rank r holds global rows [r n / R, (r + 1) n / R) of the configuration's
mixture (``data.shard_of_separated_data``: the same points however the
rows are split), centred by the mean of every rank's rows; the rows of
each rank but the last are padded to whole hash tiles with invalid rows,
as the port lays them out.  The ranks start from the generator's labels,
run the warm-up, then meet at a barrier; rank 0's clock times the window
and decides, once a block, whether it goes on (every rank runs the same
blocks), and a barrier closes it.  One operation is one sweep of all the
ranks.  The process group's backend follows the ranks' device: NCCL on
cards, gloo on the CPU.  With a trace, every rank traces and throws away
the trace's ``warmup_blocks`` (its profiler's cold start), meets the
others at a barrier, then traces the same blocks (the collectives'
kernels apart); last rank 0 alone times a world of one over its own rows
and cache (``traffic["scaling"]``), while the others wait at a barrier.

Each rank judges its own rows as the ``steady`` kind does: kernel A's last
call (its rows, its hash tiles from its first global row) and the
statistics, which the port sums over the ranks in place, against the
float64 sums of every rank's rows, summed; and the final table's
posterior.  Recovery takes the contingency table summed over the ranks;
``table_mismatch`` counts the ranks whose final table differs from rank
0's.  Each number is the worst over the ranks.
"""
from __future__ import annotations

from types import SimpleNamespace

from dpmmbench import check, data, harness, ranks, system, trace


def _detached(v):
    """A copy of ``v``'s tensors (nested dicts, lists and tuples), so that
    later work on the card cannot change what the judge reads."""
    import torch

    if torch.is_tensor(v):
        return v.clone()
    if isinstance(v, dict):
        return {key: _detached(a) for key, a in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_detached(a) for a in v)
    return v


def _one_rank_sweep_s(p, sampler, device, points, valid, n_local, state,
                      block, flags, clock) -> float:
    """Seconds a sweep of a world of one over this rank's rows and cache,
    from ``state`` (with a copy of its generator): the traffic's
    ``scaling`` warm-up blocks, then its timed blocks, each fenced as the
    window's are."""
    import torch

    sc = p.traffic["scaling"]
    solo = system.make_engine(p.config["family"], sampler, device)
    st = system.with_own_generator(state)
    for _ in range(int(sc["warmup_blocks"])):
        st, _ = system.run_block(solo, st, points, valid, float(n_local),
                                 block, **flags)
    harness.sync(torch)
    t = clock()
    for _ in range(int(sc["blocks"])):
        st, _ = system.run_block(solo, st, points, valid, float(n_local),
                                 block, **flags)
    harness.sync(torch)
    return (clock() - t) / (int(sc["blocks"]) * block)


def run(p, seed, seconds, trace_on, device, clock, t_proc, control=False):
    import torch

    d = p.config["data"]
    tr = p.traffic
    cuda = torch.device(device).type == "cuda"
    me = p.ranks or ranks.Ranks(1, 0, "", "cuda" if cuda else "cpu")
    if me.world != int(p.config.get("devices", 1)) or d["n"] % me.world:
        raise ValueError(f"{p.name}: {d['n']} rows over "
                         f"{p.config.get('devices', 1)} devices, run on "
                         f"{me.world} ranks")
    n_local = d["n"] // me.world
    seeds = dict(zip(("data", "cache", "sampler"), data.run_seeds(seed, 3)))
    phases = harness.Phases(torch, clock, t_proc)
    if me.world > 1:
        system.join(me.address, me.world, me.rank,
                    "nccl" if me.device_kind == "cuda" else "gloo")
    phases.mark("process group")
    system.load_kernels(device)
    phases.mark("kernels' library")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    layout = system.row_layout(n_local)
    x, gt = data.shard_of_separated_data(
        me.rank * n_local, n_local, d["d"], d["k_true"], d["mean_scale"],
        seeds["data"], device, pad_to=layout.n_pad)
    x[:n_local] -= (ranks.reduce_sum(x[:n_local].sum(0, dtype=torch.float64))
                    / d["n"]).to(x.dtype)
    phases.mark("data")
    sampler = dict(p.sampler)
    warm = tr["warmup"]
    init_labels = None
    if warm["init"] == "generator_labels":
        sampler["init_clusters"] = d["k_true"]
        init_labels = gt.cpu().numpy()
    capture = system.Capture()
    capture.install()
    try:
        engine = system.make_engine(p.config["family"], sampler, device,
                                    layout)
        points, valid, n_total = system.place_shard(engine, x, n_local,
                                                    seeds["cache"])
        phases.mark("cache")
        state = system.init_state(engine, points, valid, d["d"],
                                  seeds["sampler"], init_labels)
        phases.mark("init")
        block = int(tr["block"])
        flags = dict(final=tr["finals"], no_more_splits=tr["no_more_splits"])
        for _ in range(int(warm["blocks"])):
            state, k = system.run_block(engine, state, points, valid,
                                        n_total, block, **flags)
        start_sub = state.sublabels.clone()
        start_w = state.table["log_weights"].clone()
        stats0 = capture.stats_calls
        ranks.barrier(device)
        phases.mark("warm-up")
        t0 = clock()
        setup_s = t0 - t_proc
        sweeps, blocks = 0, []
        while True:
            t = clock()
            state, k = system.run_block(engine, state, points, valid, n_total,
                                        block, **flags)
            blocks.append(clock() - t)
            sweeps += block
            if ranks.rank0_says(clock() - t0 >= seconds, device):
                break
        ranks.barrier(device)
        window_s = clock() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        harness.log(
            f"{p.name} rank {me.rank}/{me.world}: {sweeps} sweeps in "
            f"{window_s:.4f} s, K={k}, set-up {setup_s:.3f} s "
            f"({phases.report()}), peak {peak} bytes; block seconds "
            f"{harness.spread(blocks)}; kernel B calls "
            f"{capture.stats_calls - stats0}")
        harness.log(f"rank {me.rank} block seconds in order: "
                    + " ".join(f"{b:.4f}" for b in blocks))
        traced = None
        if trace_on:

            def span(blocks):
                def go():
                    nonlocal state, k
                    for _ in range(blocks):
                        state, k = system.run_block(engine, state, points,
                                                    valid, n_total, block,
                                                    **flags)
                return go

            trace.capture(span(int(tr["trace"]["warmup_blocks"])))
            ranks.barrier(device)
            system.reset_counters()
            span_blocks = int(tr["trace"]["blocks"])
            with system.spans():
                traced = trace.capture(span(span_blocks),
                                       p.groups["allreduce"])
            traced["sweeps"] = span_blocks * block
            traced["counters"] = system.counters()
        stale = bool(torch.equal(state.sublabels, start_sub)
                     and torch.equal(state.table["log_weights"], start_w))
        call = (_detached(capture.call()) if capture.assign is not None
                else None)
        stats_calls = ([_detached(capture.stats)]
                       if capture.stats_calls > stats0 else [])
    finally:
        capture.uninstall()
    final = _detached(system.table_view(state.table))
    k_final = int(final["active"].sum())
    counts = check.contingency(state.labels[:n_local], gt[:n_local],
                               state.table["active"].shape[0], d["k_true"])
    digest = check.table_digest(state.table)
    one_rank_s = None
    if trace_on:
        if me.rank == 0:
            one_rank_s = _one_rank_sweep_s(p, sampler, device, points, valid,
                                           n_local, state, block, flags,
                                           clock)
            harness.log(f"rank 0 alone, a world of one over its rows: "
                        f"{one_rank_s * 1e3:.4f} ms a sweep")
        ranks.barrier(device)
    # the port's state is freed before the reference runs
    del engine, points, valid, state, capture, start_sub, start_w
    harness.sync(torch)
    if cuda:
        torch.cuda.empty_cache()
    prior = p.ref.default_prior(d["d"], x.device)
    numbers, ctl = harness.judge(p, x[:n_local], call, stats_calls, final,
                                 prior, control, reduce=ranks.reduce_sum)
    numbers.update(check.recovery_from_table(
        p.ref, ranks.reduce_sum(counts), k_final, d["k_true"]))
    numbers["stale_state"] = float(stale)
    digests = ranks.gather(torch.tensor([int(digest[:15], 16)],
                                        dtype=torch.int64, device=device))
    numbers["table_mismatch"] = float(sum(int(g) != int(digests[0])
                                          for g in digests))
    numbers = ranks.max_numbers(numbers)
    if ctl is not None:
        ctl = ranks.max_numbers(ctl)
    peaks = [int(v) for v in ranks.gather(
        torch.tensor([peak], dtype=torch.int64, device=device))]
    rank_ms = allreduce_ms = None
    if traced is not None:
        groups = trace.group_seconds(traced, p.groups)
        own = (sum(traced["device_s_by_name"].values())
               - groups["allreduce"]) * 1e3 / traced["sweeps"]
        if groups["allreduce"] > 0:
            allreduce_ms = groups["allreduce"] * 1e3 / traced["sweeps"]
        by_rank = torch.stack(ranks.gather(torch.tensor(
            [own, traced["busy_s"], traced["window_s"]], dtype=torch.float64,
            device=device))).cpu()
        rank_ms = by_rank[:, 0].tolist()
        # the result's busy and window seconds: the ranks' mean
        traced["busy_s"], traced["window_s"] = by_rank[:, 1:].mean(0).tolist()
        harness.log(f"by rank: device ms a sweep outside the collectives "
                    f"{rank_ms}, traced busy and window seconds "
                    f"{by_rank[:, 1:].tolist()}; collectives' kernels "
                    f"{allreduce_ms} ms a sweep (rank 0's)")
    ranks.barrier(device)
    if me.world > 1:
        system.leave()
    sweep_s = window_s / sweeps
    ctx = SimpleNamespace(
        trace=traced, work=harness.work(p, k), fits=None,
        sweeps=traced["sweeps"] if traced else None, sweep_s=sweep_s,
        untraced_s=sweep_s * traced["sweeps"] if traced else None,
        rank_ms=rank_ms, one_rank_sweep_s=one_rank_s,
        allreduce_ms=allreduce_ms)
    return dict(attempted=sweeps, bad=0, numbers=numbers, control=ctl,
                e2e={"sweep_ms": sweep_s * 1e3,
                     "peak_mem_gb": max(peaks) / 1e9, "setup_s": setup_s},
                ctx=ctx, peak=max(peaks), peak_by_rank=peaks)
