"""Ranks of the port's data-parallel tests, one spawned process each.

This module imports only ``torch`` and ``smmdax_torch``: a spawned child
imports the module its target lives in, and a test module would load JAX.
The test process computes every input and JAX reference, hands numpy
arrays and state dicts to ``run``, and compares what the ranks return.

Each group is gloo on the CPU over a ``FileStore`` in a directory the
caller names (pytest's ``tmp_path``), so parallel test workers never
share a store.
"""

from __future__ import annotations

import multiprocessing
import os
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

from smmdax_torch.parallel import (init_data_axis, ring_mmd2,
                                   ring_mmd2_and_ratio)

RUN_TIMEOUT_S = 300


def run(world_size: int, task: str, payload: Dict[str, Any], tmp_dir) -> List[Any]:
    """Run ``task(axis, payload)`` on ``world_size`` gloo ranks; returns
    the ranks' results in rank order.  Raises with a rank's traceback if
    one failed, or if the group did not finish in RUN_TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    tmp_dir = str(tmp_dir)
    store = os.path.join(tmp_dir, f"store_{task}_{world_size}")
    outs = [os.path.join(tmp_dir, f"{task}_{world_size}_rank{r}.pt")
            for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store, task, payload, outs[r]))
             for r in range(world_size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RUN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        result = torch.load(out, weights_only=False) if os.path.exists(out) else None
        if p.exitcode != 0 or result is None or "error" in result:
            msg = result["error"] if result else f"exit code {p.exitcode}"
            raise RuntimeError(f"rank {r} of {world_size} ({task}) failed:\n{msg}")
        results.append(result["value"])
    return results


def _rank_main(rank, world_size, store, task, payload, out):
    torch.set_num_threads(1)
    if payload.get("cwd"):
        # a directory of this rank's own: relative paths land there
        cwd = os.path.join(payload["cwd"], f"rank{rank}")
        os.makedirs(cwd, exist_ok=True)
        os.chdir(cwd)
    try:
        axis = init_data_axis("cpu", rank, world_size, store)
        try:
            value = TASKS[task](axis, payload)
        finally:
            axis.close()
        torch.save({"value": value}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def _block(a: np.ndarray, axis) -> np.ndarray:
    """This rank's contiguous block of dim 0."""
    b = a.shape[0] // axis.size
    return a[axis.index * b:(axis.index + 1) * b]


def _value_and_grads(fn, x, y, axis):
    """fn(x_loc, y_loc) on this rank's blocks: the value and the rank's
    gradients divided by the ranks (the psum -> psum convention gives each
    rank size x its share of the global gradient)."""
    xl = torch.from_numpy(_block(x, axis)).requires_grad_()
    yl = torch.from_numpy(_block(y, axis)).requires_grad_()
    val = fn(xl, yl)
    gx, gy = torch.autograd.grad(val, (xl, yl))
    return (float(val.detach()), (gx / axis.size).numpy(), (gy / axis.size).numpy())


# ---------------------------------------------------------------------------
# tasks


def ring_cases(axis, payload):
    """{case: (value, dx block, dy block)} of ring_mmd2 /
    ring_mmd2_and_ratio (the ratio and, separately, its MMD^2)."""
    out = {}
    for case in payload["cases"]:
        name, kernel, est, biased, use_pallas, add_dot, x, y = case
        kw = dict(kernel=kernel, use_pallas=use_pallas, add_dot=add_dot)
        if est == "mmd2":
            fn = lambda a, b: ring_mmd2(a, b, axis, biased=biased, **kw)  # noqa: E731
            out[name] = _value_and_grads(fn, x, y, axis)
        else:
            fn = lambda a, b: ring_mmd2_and_ratio(a, b, axis, **kw)[1]  # noqa: E731
            out[name] = _value_and_grads(fn, x, y, axis)
            val = ring_mmd2_and_ratio(torch.from_numpy(_block(x, axis)),
                                      torch.from_numpy(_block(y, axis)), axis, **kw)[0]
            out[name + "/mmd2"] = float(val)
    return out


def critic_loss_case(axis, payload):
    """A critic loss on this rank's blocks through a linear critic: loss,
    mmd2, ratio, sigma and the pmean'd gradient of the critic weight."""
    from smmdax_torch.configs import Config
    from smmdax_torch.losses import critic_loss
    cfg = Config(**payload["cfg"])
    w = torch.from_numpy(payload["w"]).requires_grad_()

    def critic(x):
        return x.reshape(x.shape[0], -1) @ w

    loss, aux = critic_loss(cfg, critic, torch.from_numpy(_block(payload["real"], axis)),
                            torch.from_numpy(_block(payload["fake"], axis)), axis=axis)
    g, = torch.autograd.grad(loss, w)
    return dict(loss=float(loss), mmd2=float(aux.mmd2), ratio=float(aux.ratio),
                sigma=float(aux.sigma), grad=axis.pmean(g).numpy())


def train_step_case(axis, payload):
    """One macro-step of ``data_parallel_train_step`` from the given
    weights, with this rank's noise: the state after it and the metrics."""
    from smmdax_torch.configs import Config
    from smmdax_torch.train import create_state, data_parallel_train_step
    cfg = Config(**payload["cfg"])
    state = create_state(cfg, device="cpu", rank=axis.index)
    state.gen.load_state_dict(payload["gen"])
    state.disc.load_state_dict(payload["disc"])
    if state.g_params_ema is not None:
        state.g_params_ema = {n: p.detach().clone() for n, p in state.gen.named_parameters()}
        state.g_stats_ema = {n: b.detach().clone() for n, b in state.gen.named_buffers()}
    noise = payload["noise"][axis.index]
    step = data_parallel_train_step(cfg, cfg.dsteps, cfg.gsteps, axis)
    state, metrics = step(state, payload["real"], noise=noise)

    def np_dict(named):
        return {n: t.detach().numpy().copy() for n, t in named}

    return dict(
        step=state.step,
        metrics={k: float(v) for k, v in metrics.items()},
        gen=np_dict(state.gen.named_parameters()),
        gen_stats=np_dict(state.gen.named_buffers()),
        disc=np_dict(state.disc.named_parameters()),
        disc_buffers=np_dict(state.disc.named_buffers()),
        g_params_ema=np_dict((state.g_params_ema or {}).items()),
        g_stats_ema=np_dict((state.g_stats_ema or {}).items()),
        d_count=state.d_opt.count, g_count=state.g_opt.count)


def collectives_case(axis, payload):
    """The collectives and their backward on known data: psum, pmean,
    all_gather (backward: reduce-scatter), ppermute_next (backward: the
    reverse shift)."""
    r = axis.index
    x = torch.from_numpy(_block(payload["coll_x"], axis)).requires_grad_()
    s = axis.psum(x)
    gs, = torch.autograd.grad(torch.sum(s * (r + 1)), x)
    g_all = axis.all_gather(x)
    gg, = torch.autograd.grad(torch.sum(g_all * torch.from_numpy(payload["coll_w"])), x)
    shifted = axis.ppermute_next(x)
    gp, = torch.autograd.grad(torch.sum(shifted * (r + 1)), x)
    return dict(psum=s.detach().numpy(), pmean=axis.pmean(x).detach().numpy(),
                psum_grad=gs.numpy(), gathered=g_all.detach().numpy(),
                gather_grad=gg.numpy(), shifted=shifted.detach().numpy(),
                shift_grad=gp.numpy())


def ring_suite(axis, payload):
    return dict(ring=ring_cases(axis, payload), collectives=collectives_case(axis, payload))


def dp_suite(axis, payload):
    return dict(losses=[critic_loss_case(axis, case) for case in payload["losses"]],
                step=train_step_case(axis, payload["step"]))


def _np_state(state) -> Dict[str, Dict[str, np.ndarray]]:
    def np_dict(named):
        return {n: t.detach().cpu().numpy().copy() for n, t in named}

    return dict(gen=np_dict(state.gen.named_parameters()),
                gen_stats=np_dict(state.gen.named_buffers()),
                disc=np_dict(state.disc.named_parameters()),
                disc_buffers=np_dict(state.disc.named_buffers()),
                g_params_ema=np_dict((state.g_params_ema or {}).items()),
                g_stats_ema=np_dict((state.g_stats_ema or {}).items()))


def gspmd_case(axis, payload):
    """``steps`` GSPMD macro-steps of ``data_parallel_train_step`` from the
    given weights on the GLOBAL batches, with the global draws: the state
    and each step's metrics."""
    from smmdax_torch.configs import Config
    from smmdax_torch.train import create_state, data_parallel_train_step
    cfg = Config(**payload["cfg"])
    state = create_state(cfg, device="cpu")
    if not payload.get("self_draw"):
        state.gen.load_state_dict(payload["gen"])
        state.disc.load_state_dict(payload["disc"])
        if state.g_params_ema is not None:
            state.g_params_ema = {n: p.detach().clone()
                                  for n, p in state.gen.named_parameters()}
            state.g_stats_ema = {n: b.detach().clone() for n, b in state.gen.named_buffers()}
    step = data_parallel_train_step(cfg, cfg.dsteps, cfg.gsteps, axis)
    metrics = []
    for real, noise in zip(payload["reals"], payload["noises"]):
        state, m = step(state, real, noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, **_np_state(state))


def batchnorm_case(axis, payload):
    """``BatchNorm`` with the axis on this rank's block of an NCHW batch:
    the output block, the running statistics after one update, and the
    block of the gradient of sum(w * y) over the global batch."""
    from smmdax_torch.nn.layers import BatchNorm
    x = torch.from_numpy(_block(payload["x"], axis)).requires_grad_()
    w = torch.from_numpy(_block(payload["w"], axis))
    bn = BatchNorm(x.shape[1])
    y = bn(x, train=True, update_stats=True, axis=axis)
    g, = torch.autograd.grad(torch.sum(w * y), x)
    return dict(y=y.detach().numpy(), grad=g.numpy(), mean=bn.mean.numpy().copy(),
                var=bn.var.numpy().copy())


def gspmd_suite(axis, payload):
    return dict(cases=[gspmd_case(axis, c) for c in payload["cases"]],
                bn=batchnorm_case(axis, payload["bn"]))


def _run_record(state) -> Dict[str, Any]:
    """Everything of a trained state, to compare runs bit for bit: the
    tensors, the counters and the noise stream's state."""
    return dict(arrays=_np_state(state), step=state.step, sched_fails=state.sched_fails,
                counts=(state.d_opt.count, state.g_opt.count),
                lrs=(float(state.lr_d), float(state.lr_g)),
                generator=state.generator.get_state().numpy().copy())


def _files(root: str) -> List[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def trainer_suite(axis, payload):
    """The trainer over ranks: who writes (relative directories, in this
    rank's own working directory), a shard_map resume, scoring, a SIGTERM
    to rank 1 alone, and the sharded device pool at two dispatch sizes."""
    import signal
    from smmdax_torch.configs import Config
    from smmdax_torch.trainer import Trainer
    base, root = payload["base"], payload["root"]

    def cfg(run, **kw):
        dirs = {k: os.path.join(root, run, k) for k in ("checkpoint_dir", "sample_dir",
                                                        "log_dir")}
        return Config(**{**base, **dirs, **kw})

    def train(c):
        return Trainer(c, device="cpu", axis=axis).train()

    out = {}
    writes = train(Config(**{**base, **payload["writes"]}))
    out["writes"] = dict(run=_run_record(writes), files=_files(os.getcwd()))

    ring = payload["ring"]
    m = ring["max_iteration"]
    full = train(cfg("ring_full", **ring))
    train(cfg("ring_half", **{**ring, "max_iteration": m // 2, "checkpoint_every": m // 2}))
    resumed = Trainer(cfg("ring_half", **ring), device="cpu", axis=axis)
    resumed_from = resumed.state.step
    out["resume"] = dict(full=_run_record(full), resumed=_run_record(resumed.train()),
                         resumed_from=resumed_from)

    scorer = Trainer(cfg("scores", **payload["scores"]), device="cpu", axis=axis)
    scorer.SCORE_CHUNK_IMAGE_BYTES = payload["chunk_bytes"]
    out["scores"] = [scorer._score(s) for s in (1, 2)]

    sig = Trainer(cfg("sigterm", **payload["sigterm"]), device="cpu", axis=axis)
    if axis.index == 1:
        get_step = sig._get_step

        def signalling(dsteps, k):
            fn = get_step(dsteps, k)

            def step(state, *args):
                state, metrics = fn(state, *args)
                if state.step == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return state, metrics

            return step

        sig._get_step = signalling
    stopped = sig.train()
    out["sigterm"] = dict(step=stopped.step, saved=sig.ckpt.latest_step())

    pool = payload["pool"]
    runs = {}
    for k in (1, 3):
        t = Trainer(cfg(f"pool_k{k}", **pool, steps_per_dispatch=k), device="cpu", axis=axis)
        runs[k] = _run_record(t.train())
        rows = t._dev_data.numpy().copy()
    out["pool"] = dict(k1=runs[1], k3=runs[3], rows=rows)
    return out


def dryrun_suite(axis, payload):
    """``graft_entry.dryrun_multichip`` on this group's axis (the caller's
    ``DataAxis`` path), with the given weights and draws for the modes
    ``payload["inputs"]`` names: every mode's outcome, and what the rank
    printed."""
    import contextlib
    import io
    from smmdax_torch import graft_entry
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        records = graft_entry.dryrun_multichip(axis.size, axis=axis, inputs=payload["inputs"])
    return dict(records=records, printed=out.getvalue())


def tracing_suite(axis, payload):
    """Each collective once under program tracing: the drained span names,
    the counters, and the payload bytes they should count."""
    from smmdax_torch import tracing
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + axis.index
    tracing.enable()
    try:
        axis.psum(x)
        gathered = axis.all_gather(x.clone().requires_grad_())
        axis.ppermute_next(x)
        gathered.sum().backward()             # the gather's transpose: a reduce-scatter
        axis.all_gather_rows(x[:axis.index + 1])
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    top = axis.size                            # all_gather_rows pads to the longest block
    expect = 4 * (3 * x.numel() + axis.size * x.numel() + top * 3)
    return [s.name for s in spans], counters, expect


TASKS = {"ring_suite": ring_suite, "dp_suite": dp_suite, "gspmd_suite": gspmd_suite,
         "trainer_suite": trainer_suite, "dryrun_suite": dryrun_suite,
         "tracing_suite": tracing_suite}
