"""A training cell: the port's K-macro-step dispatch, host-fed, timed
over the whole window.

Set-up: the dataset drawn from the seed, the port's ``create_state`` and
``dispatch_train_step`` at the configuration's flags, the feed thread,
then ``check_steps`` macro-steps through that dispatch function and feed,
one per dispatch, which give the program's readings for the comparison,
and one dispatch of K that warms every shape the window uses.  The window
runs dispatches until ``--seconds`` have passed and ends on a synchronize; ``train_images_per_s`` is every real image of
the completed macro-steps, (dsteps + gsteps) x the global batch each,
over the window's wall time.  With ``--trace 1`` the profiler windows
come after the timed window and never enter a rate.  After everything the
program ran, its state is freed and the reference follows the checked
macro-steps (``benchmark.train_check``), after the window's own
dispatch has been held to dispatches of one on a copy of its state
(``dispatch_check``), with the memory peak already read.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

from benchmark import common, trace
from benchmark.feed import Feed, images
from benchmark import train_check as tc


def mmd_time_ms(cfg, c: dict, seed: int, dev, iters: int = 200) -> float:
    """CUDA-event ms of one forward and backward of the port's
    ``mmd2_objective`` at the cell's feature shapes (global batch x dof)."""
    import torch
    from smmdax_torch.losses import mmd2_objective
    g = torch.Generator(device=dev).manual_seed(seed)
    b = c["batch_size"]
    fx = torch.randn((b, c["dof_dim"]), generator=g, device=dev).requires_grad_(True)
    fy = torch.randn((b, c["dof_dim"]), generator=g, device=dev).requires_grad_(True)

    def call():
        torch.autograd.grad(mmd2_objective(cfg, fx, fy), (fx, fy))

    for _ in range(5):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def checked_steps(c: dict, state, single, feed, steps: int):
    """The first ``steps`` macro-steps, each a dispatch of one through
    ``single`` on the feed's batches: the program's readings."""
    prog = tc.Readings()
    before = tc.snapshot(tc.program_groups(state))
    for i in range(steps):
        state, m = single(state, feed.dispatch_batch(record=False, k=1))
        prog.losses.append({key: float(m[key]) for key in tc.LOSS_KEYS})
        if i == 0:
            prog.grads = tc.program_grads(state, c["beta1"])
    prog.changes = tc.change_norms(before, tc.program_groups(state))
    return state, prog


def start(c: dict, t: dict, seed: int, dev):
    """Set-up up to the window: the program's state and dispatch, the
    feed, the program's readings of the checked macro-steps and one
    warm-up dispatch."""
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.train import create_state, dispatch_train_step

    cfg = common.port_config(c, seed)
    dsteps, gsteps, k = c["dsteps"], c["gsteps"], c["steps_per_dispatch"]
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    state = create_state(cfg, seed=seed, device=dev)
    step = dispatch_train_step(cfg, dsteps, gsteps, steps_per_dispatch=k)
    feed = Feed(ArraySource(data, seed=seed), dsteps + gsteps, c["real_batch_size"], k)
    # the checked macro-steps: the same dispatch of one macro-step each,
    # as the trainer dispatches fewer than K at an event boundary
    single = dispatch_train_step(cfg, dsteps, gsteps, steps_per_dispatch=1)
    state, prog = checked_steps(c, state, single, feed, t["check_steps"])
    state, _ = step(state, feed.dispatch_batch(record=False))
    return cfg, data, state, step, single, feed, prog


def dispatch_check(cfg, seed: int, state, step, single, feed, dev, dispatches: int = 2):
    """``dispatch_gap`` (``train_check``): ``dispatches`` more of the
    window's dispatches, and a copy of the state through each of their
    macro-steps as a dispatch of one."""
    from smmdax_torch.checkpoint import load_state_dict, state_dict
    from smmdax_torch.train import create_state
    twin = load_state_dict(create_state(cfg, seed=seed, device=dev), state_dict(state))
    m = mt = None
    for _ in range(dispatches):
        batch = feed.dispatch_batch(record=False)
        state, m = step(state, batch)
        for real in batch:
            twin, mt = single(twin, real)
    return state, tc.same_state(state, twin, m, mt)


def run(ctx: dict) -> Dict:
    import torch

    c, t, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], torch.device(ctx["device"])
    k = c["steps_per_dispatch"]
    per_step, batch = c["dsteps"] + c["gsteps"], c["real_batch_size"]
    cfg, data, state, step, single, feed, prog = start(c, t, seed, dev)
    common.sync(dev)
    setup_s = time.perf_counter() - ctx["t0"]

    # the window
    macro_steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx["seconds"]:
        state, _ = step(state, feed.dispatch_batch())
        macro_steps += k
    common.sync(dev)
    window_s = time.perf_counter() - t0
    run_info = {"kind": "train", "config": c, "traffic": t, "chips": ctx["chips"],
                "rate": {"macro_steps": macro_steps, "window_s": window_s,
                         "images": macro_steps * per_step * batch},
                "spans": {"data.wait": list(feed.waits)}, "peaks": ctx["peaks"]}
    extra: Dict = {}
    if ctx["trace"] and dev.type == "cuda":
        n = t["trace_dispatches"]

        def dispatches(count: int):
            def go():
                nonlocal state
                for _ in range(count):
                    state, _ = step(state, feed.dispatch_batch(record=False))
            return go

        summary = trace.device_window(dispatches(n))
        summary["macro_steps"] = n * k
        gaps = trace.host_window(dispatches(t["label_dispatches"]))
        run_info["trace"] = summary
        run_info["mmd"] = {"ms": mmd_time_ms(cfg, c, seed, dev), "kernel": c["kernel"],
                           "alphas": c["rq_alphas"], "rows": c["batch_size"],
                           "dof": c["dof_dim"]}
        extra = {"busy_s": summary["busy_s"], "window_s": summary["window_s"],
                 "breakdown": {"device_ops": summary["device_ops"], "idle_gaps": gaps}}
    device = common.device_info(ctx["chips"], dev)

    state, dispatch_gap = dispatch_check(cfg, seed, state, step, single, feed, dev)
    feed.close()
    del state, step, single
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = tc.reference_readings(c, seed, data, t["check_steps"], dev)
    numbers = {**tc.compare(prog, ref), "dispatch_gap": dispatch_gap}
    checks = common.judge(numbers, c["limits"]["train"])
    return {"setup_s": setup_s, "run": run_info, "device": device, "extra": extra,
            "checks": checks, "attempted": macro_steps, "failed": 0, "e2e": {
                "train_images_per_s": run_info["rate"]["images"] / window_s}}
