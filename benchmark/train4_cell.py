"""A training cell over ranks: the port's data-parallel K-macro-step
dispatch, one rank process per card, each host-fed with its block of the
global batch, timed over the whole window.

``benchmark.ranks`` starts the ranks as the trainer's launcher does
(``RankGroup``, ``init_data_axis``); each runs ``rank_main``.  Set-up, on
every rank: the dataset drawn from the seed, the port's ``create_state``
with the rank's own noise stream, ``dispatch_train_step`` over the axis,
a feed of the rank's block (``macro_batch_at(..., block=(r, ranks))``),
then ``check_steps`` macro-steps as dispatches of one (the program's
readings for the comparison) and one dispatch of K.  The window opens
after a barrier; rank 0's clock decides when it ends, and that decision
is all-reduced at every dispatch boundary, as the trainer stops its ranks
on a signal; it ends on a synchronize and a barrier.
The window's rate is every real image of the completed macro-steps,
(dsteps + gsteps) x the global batch each, over rank 0's window: on a
host whose cores share their time with other machines it spreads too
widely to bound, so the cell reports it per layer
(``train.images_per_s.train4``).  Its end-to-end metrics are
``setup_s``, from this command's start to the window's opening barrier
(``time.perf_counter``, the host's monotonic clock, which every process
shares), and ``memory_peak_bytes``, the allocator's peak on the fullest
card over set-up and the window.

With ``--trace 1`` every rank runs the traced dispatches and rank 0
profiles them: ``trace_dispatches`` under CUDA activity and
``label_dispatches`` under host and CUDA activity (``benchmark.trace``),
then the same counts again with the program's spans on, window A without
and window B under the profiler (``benchmark.program_trace``), all on the
cell's own state.

Then every rank reads its memory peak, holds the window's dispatch to
dispatches of one on a copy of its state (``dispatch_gap``), its state to
rank 0's (``rank_gap``) and the blocks its feed gave the checked
macro-steps to its columns of the reference's global batch
(``block_gap``); the ranks end, and this process follows the
checked macro-steps with the plain reference of the data-parallel step
(``benchmark/reference/gan_dp.py``) on the first card.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Dict

from benchmark import common, program_trace, ranks, trace
from benchmark import train_cell, train_check as tc
from benchmark.feed import Feed, images
from benchmark.reference import gan_dp

# seconds a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 120.0
# seconds the ranks may take, beyond the window, for their set-up, the
# traced windows and the checks (seen: 18-51, 130-135 and 6-9 s on four
# H100s): the group's deadline is their sum with the window
SETUP_S, TRACED_S, CHECKS_S = 300.0, 600.0, 120.0


def start(c: dict, t: dict, seed: int, axis, mark=lambda name: None):
    """Set-up of one rank up to the window: its data, state, the
    dispatches over the axis, its feed, the program's readings of the
    checked macro-steps with the blocks fed to them, and one warm-up
    dispatch; ``mark(name)`` after each."""
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.train import create_state, dispatch_train_step
    cfg = common.port_config(c, seed)
    dsteps, gsteps, k = c["dsteps"], c["gsteps"], c["steps_per_dispatch"]
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    mark("data")
    state = create_state(cfg, seed=seed, device=axis.device, rank=axis.index)
    mark("state")
    step = dispatch_train_step(cfg, dsteps, gsteps, steps_per_dispatch=k, axis=axis)
    single = dispatch_train_step(cfg, dsteps, gsteps, steps_per_dispatch=1, axis=axis)
    feed = Feed(ArraySource(data, seed=seed), dsteps + gsteps, c["real_batch_size"], k,
                block=(axis.index, axis.size))
    feed.kept = []
    state, prog = train_cell.checked_steps(c, state, single, feed, t["check_steps"])
    fed, feed.kept = feed.kept, None
    mark("checked_steps")
    state, _ = step(state, feed.dispatch_batch(record=False))
    mark("warm_up")
    return cfg, data, state, step, single, feed, prog, fed


def checks(cfg, c: dict, seed: int, data, fed, state, step, single, feed, axis):
    """``dispatch_gap``, ``rank_gap`` and ``block_gap`` over every rank,
    after the window."""
    state, gap = train_cell.dispatch_check(cfg, seed, state, step, single, feed, axis.device,
                                           dispatches=1)
    return state, {"dispatch_gap": max(axis.gather_objects(gap)),
                   "rank_gap": tc.rank_gap(state, axis),
                   "block_gap": tc.block_gap(c, seed, data, fed, axis)}


def rank_main(axis, ctx: dict):
    """One rank's run; rank 0 returns what the command reports."""
    import torch
    if ctx.get("rank_hook"):
        ctx["rank_hook"](axis)
    c, t, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], axis.device
    k, main = c["steps_per_dispatch"], axis.index == 0
    # seconds since the command's start at which each phase ended, rank 0's
    phases = {"rank_imported": ranks.LOADED - ctx["t0"],
              "joined": time.perf_counter() - ctx["t0"]}

    def mark(name: str) -> None:
        phases[name] = time.perf_counter() - ctx["t0"]

    cfg, data, state, step, single, feed, prog, fed = start(c, t, seed, axis, mark)
    box = {"state": state}

    def dispatches(n: int, record: bool = False):
        def go():
            for _ in range(n):
                box["state"], _ = step(box["state"], feed.dispatch_batch(record=record))
        return go

    common.sync(dev)
    axis.barrier()
    setup_s = time.perf_counter() - ctx["t0"]

    # the window: every rank stops at the same dispatch, when rank 0's
    # clock has passed --seconds
    macro_steps, t0 = 0, time.perf_counter()
    walls, cpus = [], []
    while True:
        w0, c0 = time.perf_counter(), time.thread_time()
        dispatches(1, record=True)()
        macro_steps += k
        stop = axis.any(main and time.perf_counter() - t0 >= ctx["seconds"])[0]
        walls.append(time.perf_counter() - w0)
        cpus.append(time.thread_time() - c0)
        if stop:
            break
    common.sync(dev)
    axis.barrier()
    window_s = time.perf_counter() - t0
    mark("window")
    # each rank's median wall and launching-thread CPU seconds a dispatch
    # (whether a slow window is a slow host or a wait on the other ranks),
    # its slowest dispatch and how many took over 1.25x the median wall (a
    # stall, or a host that slowed within the window)
    med = statistics.median(walls)
    look = axis.gather_objects((med, statistics.median(cpus), max(walls),
                                sum(w > 1.25 * med for w in walls), len(walls)))
    run_info = {"kind": "train4", "config": c, "traffic": t, "chips": ctx["chips"],
                "rate": {"macro_steps": macro_steps, "window_s": window_s,
                         "images": macro_steps * (c["dsteps"] + c["gsteps"])
                         * c["real_batch_size"]},
                "spans": {"data.wait": list(feed.waits)}, "peaks": ctx["peaks"]}
    extra: Dict = {}
    if ctx["trace"]:
        n_a, n_b = t["trace_dispatches"], t["label_dispatches"]
        if main and dev.type == "cuda":
            summary = trace.device_window(dispatches(n_a))
            summary["macro_steps"] = n_a * k
            gaps = trace.host_window(dispatches(n_b))
            run_info["trace"] = summary
            extra = {"busy_s": summary["busy_s"], "window_s": summary["window_s"],
                     "breakdown": {"device_ops": summary["device_ops"], "idle_gaps": gaps}}
        else:
            dispatches(n_a)()
            dispatches(n_b)()
        t_w = time.perf_counter()
        w = program_trace.dispatch_windows(dispatches, n_a, n_b, k, dev, profile=main)
        w.update(seconds=time.perf_counter() - t_w, untraced_per_s=macro_steps / window_s,
                 traced_per_s=w["units_a"] / w["wall_a"])
        run_info["program"] = w if main and dev.type == "cuda" else None
    mark("traced")
    peaks = axis.gather_objects(torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    state, gaps = checks(cfg, c, seed, data, fed, box.pop("state"), step, single, feed, axis)
    feed.close()
    mark("checks")
    if not main:
        return None
    return {"setup_s": setup_s, "run": run_info, "extra": extra, "peaks": peaks,
            "prog": prog, "gaps": gaps,
            "attempted": macro_steps, "phases": phases, "look": look}


def run(ctx: dict) -> Dict:
    import torch
    c, t, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    phases: Dict[str, float] = {}
    deadline = SETUP_S + ctx["seconds"] + (TRACED_S if ctx["trace"] else 0.0) + CHECKS_S
    out = ranks.run(rank_main, c["num_data_shards"], ctx["device"], (ctx,),
                    timeout=COLLECTIVE_TIMEOUT_S, deadline=deadline,
                    mark=lambda name: phases.update({name: time.perf_counter() - ctx["t0"]}))
    phases.update(out["phases"], ranks_ended=time.perf_counter() - ctx["t0"])
    dev = torch.device(ctx["device"], 0) if ctx["device"] == "cuda" else torch.device("cpu")
    run_info = out["run"]
    if run_info.get("program"):
        program_trace.record(run_info["program"])
    device = common.device_info(ctx["chips"], dev, peaks=out["peaks"])
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    ref = tc.reference_readings(c, seed, data, t["check_steps"], dev, model=gan_dp)
    phases["reference"] = time.perf_counter() - ctx["t0"]
    print("train4 phases (s since start): " + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
          + "; dispatch s by rank (median wall, median CPU, slowest wall, over 1.25x of n): "
          + ", ".join(f"({wall:.3f}, {cpu:.3f}, {top:.3f}, {slow} of {n})"
                      for wall, cpu, top, slow, n in out["look"]), file=sys.stderr)
    numbers = {**tc.compare(out["prog"], ref), **out["gaps"]}
    memory = device["memory_peak_bytes"] if device["platform"] == "gpu" else None
    return {"setup_s": out["setup_s"], "run": run_info, "device": device,
            "extra": out["extra"], "checks": common.judge(numbers, c["limits"]["train4"]),
            "attempted": out["attempted"], "failed": 0,
            "e2e": {"memory_peak_bytes": memory}}
