"""The flagship's forward entry and the multichip dry run (the port's
counterpart of the JAX package's ``__graft_entry__.py``).

``entry(device)`` returns the flagship's single-device forward and its
example arguments: G(z) in eval mode, the critic on the real and the fake
batch, and the scaled-MMD critic loss, at ``flagship_cfg()``'s full width.

``dryrun_multichip(n, device)`` runs the full training step (critic and
generator updates, spectral norm, scaled MMD, global-batch statistics)
over n ranks in the 13 modes of ``_MODES``, JAX's names in JAX's order,
one tiny macro-step (or two) each, with the evidence contract of the JAX
package's dry run:

* each mode's OK (or FAILED) line prints, flushed, the moment the ranks
  agree on its outcome; the first ``N_CORE_MODES`` always run, and an
  optional mode is skipped with a printed line once the budget left
  (``SMMDAX_DRYRUN_BUDGET``, default 480 s) is below the median time of
  the modes run so far; ``dryrun_multichip: N/13 modes OK in Ts`` always
  ends the run, which raises afterwards if a mode failed;
* SIGTERM, SIGINT or SIGALRM (armed at budget + 60 s) writes that summary
  and ends the process: exit 0 once the core modes have passed, 3 before.

The ranks are processes: gloo on the CPU (``device="cpu"``), NCCL on the
cards, one per card; more ranks than cards is refused, where the JAX
package moves to virtual CPU devices.  ``n == 1`` runs in this process on
a one-rank axis, and a caller that holds a ``DataAxis`` of n ranks runs
the modes on it, on every rank (no signal handlers then: the caller owns
the process).  Otherwise ``dryrun_multichip`` spawns n ranks and keeps the
tally itself from rank 0's outcomes, sent through a pipe: a signal
handler cannot run in a rank blocked inside a collective, so the launcher
writes the summary, stops the ranks and picks the exit code.

Every rank makes the same decisions: rank 0 decides each skip and
broadcasts it, each mode's outcome is gathered from all ranks before the
next mode starts, and a collective of the spawned groups waits at most
``GROUP_TIMEOUT_S``, so a mode that raised on one rank mid-collective
fails the others in bounded time.

    python -m smmdax_torch.graft_entry [--device cpu]

runs ``entry()``'s forward once and the dry run on every visible card (one
rank with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import multiprocessing
import os
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smmdax_torch.configs import Config
from smmdax_torch.eval.features import RandomConvFeatures
from smmdax_torch.eval.scores import kid_from_features, relative_mmd_test
from smmdax_torch.losses import critic_loss
from smmdax_torch.parallel.collectives import DataAxis, init_data_axis, rank_device
from smmdax_torch.parallel.launch import POLL_S, RankFailed, RankGroup
from smmdax_torch.train import (TrainState, build_train_step, check_devices, check_ranks,
                                create_state, device_data_train_step, dispatch_train_step,
                                resolve_device)
from smmdax_torch.trainer import split_rows

Tensor = torch.Tensor

DRYRUN_BUDGET_S = float(os.environ.get("SMMDAX_DRYRUN_BUDGET", 480.0))
N_CORE_MODES = 3  # gspmd, shard_map+ring, shard_map+ring tmmd: never skipped
# the longest a collective of the spawned groups waits for the other ranks
GROUP_TIMEOUT_S = 120.0
_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGALRM)


def flagship_cfg(tiny: bool = False) -> Config:
    """The flagship (``__graft_entry__._flagship_cfg``): sn-smmd, rq, the
    ResNet pair on 32 px synthetic data, B 64, dof 16, one critic and one
    generator update; ``tiny`` cuts the widths for the dry run."""
    if tiny:
        return Config(model="sn-smmd", kernel="rq", architecture="resnet",
                      dataset="synthetic", output_size=32, batch_size=16,
                      gf_dim=8, df_dim=8, dof_dim=4, z_dim=8,
                      dsteps=1, gsteps=1, gradient_penalty=0.0)
    return Config(model="sn-smmd", kernel="rq", architecture="resnet",
                  dataset="synthetic", output_size=32, batch_size=64,
                  dof_dim=16, dsteps=1, gsteps=1)


# ---------------------------------------------------------------------------
# the forward entry


def forward_fn(cfg: Config, gen: torch.nn.Module, disc: torch.nn.Module
               ) -> Callable[..., Tuple[Tensor, Tensor, Tensor]]:
    """``forward(g_params, g_stats, d_params, d_spectral, real, z) ->
    (loss, mmd2, sigma)``: G(z) in eval mode (running BN statistics), the
    critic on ``real`` and the fake batch without a spectral-norm update,
    and ``critic_loss`` over ``cfg``.  The weights are arguments, the
    modules' state dicts split as JAX splits its trees (parameters and BN
    statistics of G; parameters and spectral-norm vectors of the critic),
    run through ``torch.func.functional_call``."""

    def forward(g_params, g_stats, d_params, d_spectral, real, z):
        fake = torch.func.functional_call(gen, {**g_params, **g_stats}, (z,),
                                          {"train": False})

        def critic(x: Tensor) -> Tensor:
            return torch.func.functional_call(disc, {**d_params, **d_spectral}, (x,),
                                              {"update_sn": False})

        loss, aux = critic_loss(cfg, critic, real, fake)
        return loss, aux.mmd2, aux.sigma

    return forward


def entry(device="cuda") -> Tuple[Callable[..., Tuple[Tensor, Tensor, Tensor]], tuple]:
    """(fn, example_args): the flagship's single-device forward
    (``forward_fn`` at ``flagship_cfg()``), the counterpart of
    ``__graft_entry__.entry``.  ``example_args`` are the weights of
    ``create_state(cfg, 0, device)`` and zero real images and latents on
    ``device``; weights converted from a JAX state drop in through
    ``convert.load_module``.  The JAX forward also takes an rng, which this
    config never draws from (the exact sigma needs no probe, and there is no
    penalty), so ``fn`` takes none.  Raises without a card unless
    ``device="cpu"``."""
    cfg = flagship_cfg()
    state = create_state(cfg, 0, device)
    b, dev = cfg.batch_size, state.device

    def named(items):
        return {n: t.detach() for n, t in items}

    example_args = (
        named(state.gen.named_parameters()), named(state.gen.named_buffers()),
        named(state.disc.named_parameters()), named(state.disc.named_buffers()),
        torch.zeros((b,) + cfg.image_shape, device=dev),
        torch.zeros((b, cfg.z_dim), device=dev))
    return forward_fn(cfg, state.gen, state.disc), example_args


# ---------------------------------------------------------------------------
# the dry run's modes


@dataclasses.dataclass
class DryrunContext:
    """What every mode shares (``__graft_entry__._dryrun_ctx``): the tiny
    flagship config at B = 2n over n shards, one global macro-batch
    ``real`` (numpy's ``default_rng(0)``, bit-equal to JAX's) and the uint8
    pool of 8n samples (``default_rng(1)``), and this rank's axis.

    ``inputs``, the hook through which a caller replaces what a mode draws:
    ``{mode name: {"gen": state dict, "disc": state dict, "noise": [each
    rank's draws]}}`` (the draws as ``train_step(..., noise=...)`` takes
    them: global in GSPMD mode, the rank's own in shard_map mode).  A
    mode's state is otherwise ``create_state(cfg, 0, device)``, with each
    shard_map rank's own noise stream."""

    axis: DataAxis
    cfg: Config
    real: np.ndarray
    pool: np.ndarray
    inputs: Dict[str, Dict[str, Any]]
    mode: str = ""
    metrics: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.axis.size

    @property
    def device(self) -> torch.device:
        return self.axis.device

    def rows(self, x: np.ndarray, dim: int = 0) -> np.ndarray:
        """This rank's contiguous block of ``x`` along ``dim``."""
        b = x.shape[dim] // self.n
        return np.take(x, range(self.axis.index * b, (self.axis.index + 1) * b), axis=dim)

    def state(self, cfg: Config) -> TrainState:
        given = self.inputs.get(self.mode, {})
        rank = self.axis.index if cfg.dp_mode == "shard_map" else 0
        state = create_state(cfg, 0, self.device, rank=rank)
        if "gen" in given:      # (the tiny config keeps no EMA shadow to reset)
            state.gen.load_state_dict(given["gen"])
            state.disc.load_state_dict(given["disc"])
        return state

    def noise(self) -> Optional[Dict[str, Any]]:
        given = self.inputs.get(self.mode, {})
        return given["noise"][self.axis.index] if "noise" in given else None

    def record(self, metrics: Dict[str, Tensor]) -> Dict[str, float]:
        """The mode's metrics as floats, each finite, kept for the caller."""
        values = {k: float(v) for k, v in metrics.items()}
        for k, v in values.items():
            _require(np.isfinite(v), f"{k} = {v}")
        self.metrics[self.mode] = values
        return values


def dryrun_context(axis: DataAxis, inputs: Optional[Dict[str, Dict[str, Any]]] = None
                   ) -> DryrunContext:
    n = axis.size
    cfg = flagship_cfg(tiny=True).replace(batch_size=2 * n, num_data_shards=n)
    per_step = cfg.dsteps + cfg.gsteps
    real = np.random.default_rng(0).standard_normal(
        (per_step, cfg.batch_size) + cfg.image_shape).astype(np.float32) * np.float32(0.5)
    pool = np.random.default_rng(1).integers(0, 256, (8 * n,) + cfg.image_shape, np.uint8)
    return DryrunContext(axis=axis, cfg=cfg, real=real, pool=pool, inputs=inputs or {})


def _program(cfg: Config, axis: Optional[DataAxis]) -> str:
    """Which program a step ran: one device's, or over the ranks GSPMD's
    global-batch step or shard_map's per-rank one."""
    if axis is None:
        return "single-device program"
    kind = "per-rank shard_map" if cfg.dp_mode == "shard_map" else "GSPMD"
    return f"{kind} program on {axis.size} rank(s)"


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _run_step(ctx: DryrunContext, cfg: Config) -> Tuple[Dict[str, float], str]:
    """``create_state`` and one macro-step of ``build_train_step(...,
    axis=ctx.axis)`` on this rank's block of the macro-batch: the
    per-rank program even on one rank."""
    step = build_train_step(cfg, cfg.dsteps, cfg.gsteps, axis=ctx.axis)
    state, m = step(ctx.state(cfg), ctx.rows(ctx.real, 1), noise=ctx.noise())
    _require(state.step == 1, f"step {state.step}")
    return ctx.record(m), _program(cfg, ctx.axis)


def _data_step(ctx: DryrunContext, cfg: Config, k: int) -> Tuple[Dict[str, float], str]:
    """k macro-steps of ``device_data_train_step`` on the pool, whole on
    every rank or each rank's equal slice of it (``device_data_sharding``)."""
    pool = ctx.pool if cfg.device_data_sharding == "replicated" else ctx.rows(ctx.pool)
    step = device_data_train_step(cfg, cfg.dsteps, cfg.gsteps, k, ctx.axis)
    state, m = step(ctx.state(cfg), torch.from_numpy(pool).to(ctx.device))
    _require(state.step == k, f"step {state.step} after {k} macro-steps")
    return ctx.record(m), _program(cfg, check_ranks(cfg, ctx.axis))


def _mode_gspmd(ctx: DryrunContext) -> str:
    """GSPMD: the step in global-batch terms (global BN statistics and
    draws, gathered features)."""
    m, prog = _run_step(ctx, ctx.cfg)
    return f"mmd2={m['d_loss_mmd2']:.5f} sigma={m['d_sigma']:.3f}; {prog}"


def _mode_shardmap_ring(ctx: DryrunContext) -> str:
    """shard_map with the ring global-batch estimator (per-rank noise,
    pmean'd gradients, the ring shift)."""
    cfg = ctx.cfg.replace(use_ring_mmd=True, dp_mode="shard_map")
    m, prog = _run_step(ctx, cfg)
    return f"mmd2={m['d_loss_mmd2']:.5f} sigma={m['d_sigma']:.3f}; {prog}"


def _mode_ring_tmmd(ctx: DryrunContext) -> str:
    """tmmd through the ring's variance statistics (the pair-stats path)."""
    cfg = ctx.cfg.replace(model="tmmd", use_ring_mmd=True, dp_mode="shard_map",
                          with_sn=False, with_scaling=False)
    m, prog = _run_step(ctx, cfg)
    return f"mmd2={m['d_loss_mmd2']:.5f} ratio={m['d_ratio']:.5f}; {prog}"


def _mode_gspmd_witness_gp(ctx: DryrunContext) -> str:
    """The witness penalty under GSPMD: double backprop through the
    gathered features (two-sided, so non-zero at init)."""
    cfg = ctx.cfg.replace(gradient_penalty=1.0, gp_variant="two_sided")
    m, prog = _run_step(ctx, cfg)
    _require(m["d_gp"] > 0.0, "witness GP vanished under GSPMD")
    return f"mmd2={m['d_loss_mmd2']:.5f} gp={m['d_gp']:.5f}; {prog}"


def _mode_k_dispatch(ctx: DryrunContext) -> str:
    """Two macro-steps per dispatch over the ranks; the step counter
    advances by 2."""
    cfg = ctx.cfg
    step = dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 2, ctx.axis)
    real = ctx.rows(ctx.real, 1)
    state, m = step(ctx.state(cfg), np.stack([real, real * np.float32(0.9)]))
    _require(state.step == 2, f"step {state.step} after a dispatch of 2")
    m = ctx.record(m)
    return f"mmd2={m['d_loss_mmd2']:.5f}; {_program(cfg, check_ranks(cfg, ctx.axis))}"


def _mode_device_data(ctx: DryrunContext) -> str:
    """The uint8 pool on the device, whole on every rank; each macro-step
    gathers its global batch there and each rank takes its block."""
    m, prog = _data_step(ctx, ctx.cfg, 1)
    return f"mmd2={m['d_loss_mmd2']:.5f}; {prog}"


def _mode_sharded_pool(ctx: DryrunContext) -> str:
    """The pool split over the ranks (each holds 8 samples); each rank
    gathers its rows from its own slice."""
    m, prog = _data_step(ctx, ctx.cfg.replace(device_data_sharding="sharded"), 1)
    return f"mmd2={m['d_loss_mmd2']:.5f}; {prog}"


def _mode_wgan_gp(ctx: DryrunContext) -> str:
    """wgan-gp under GSPMD: a scalar critic, its penalty's double backprop."""
    cfg = ctx.cfg.replace(model="wgan-gp", with_sn=False, with_scaling=False,
                          gradient_penalty=1.0, dof_dim=1)
    m, prog = _run_step(ctx, cfg)
    _require(m["d_gp"] > 0.0, "WGAN-GP vanished under GSPMD")
    return f"gp={m['d_gp']:.5f}; {prog}"


def _mode_shardmap_witness_gp(ctx: DryrunContext) -> str:
    """The witness penalty in shard_map mode with the gathered estimator."""
    cfg = ctx.cfg.replace(gradient_penalty=1.0, gp_variant="two_sided",
                          use_ring_mmd=False, dp_mode="shard_map")
    m, prog = _run_step(ctx, cfg)
    _require(m["d_gp"] > 0.0, "witness GP vanished in shard_map")
    return f"mmd2={m['d_loss_mmd2']:.5f} gp={m['d_gp']:.5f}; {prog}"


def _mode_ring_witness_gp(ctx: DryrunContext) -> str:
    """The witness penalty with the ring estimator: the loss on the ring,
    the penalty's witness over the gathered features."""
    cfg = ctx.cfg.replace(gradient_penalty=1.0, gp_variant="two_sided",
                          use_ring_mmd=True, dp_mode="shard_map")
    m, prog = _run_step(ctx, cfg)
    _require(m["d_gp"] > 0.0, "witness GP vanished on the ring")
    return f"mmd2={m['d_loss_mmd2']:.5f} gp={m['d_gp']:.5f}; {prog}"


def _mode_tmmd_gathered(ctx: DryrunContext) -> str:
    """tmmd on the gathered features' full Gram blocks."""
    cfg = ctx.cfg.replace(model="tmmd", use_ring_mmd=False, dp_mode="shard_map",
                          with_sn=False, with_scaling=False)
    m, prog = _run_step(ctx, cfg)
    return f"mmd2={m['d_loss_mmd2']:.5f} ratio={m['d_ratio']:.5f}; {prog}"


def _mode_k2_sharded_pool(ctx: DryrunContext) -> str:
    """Two macro-steps per dispatch on the sharded pool."""
    m, prog = _data_step(ctx, ctx.cfg.replace(device_data_sharding="sharded"), 2)
    return f"mmd2={m['d_loss_mmd2']:.5f}; {prog}"


def _rank_features(ctx: DryrunContext, ext: RandomConvFeatures, images: np.ndarray
                   ) -> np.ndarray:
    """Features of ``images``: each rank extracts its contiguous rows in
    whole extractor batches, as the trainer splits them, gathered in rank
    order."""
    lo, hi = split_rows(len(images), ext.batch, ctx.axis.index, ctx.n)
    return ctx.axis.all_gather_rows(torch.from_numpy(ext(images[lo:hi]))).numpy()


def _mode_mesh_eval(ctx: DryrunContext) -> str:
    """Feature extraction split over the ranks, then KID and the
    scheduler's relative-MMD test on the gathered features."""
    n, cfg = ctx.n, ctx.cfg
    ext = RandomConvFeatures(feature_dim=32, width=8, batch=8 * n, device=ctx.device)
    rng_e = np.random.default_rng(2)
    imgs_a = rng_e.standard_normal((16 * n,) + cfg.image_shape).astype(np.float32) * 0.5
    imgs_b = imgs_a + 0.3 * rng_e.standard_normal(imgs_a.shape).astype(np.float32)
    f_ref = _rank_features(ctx, ext, imgs_a)
    f_a = _rank_features(ctx, ext, imgs_b)
    kid, _ = kid_from_features(f_ref, f_a, subset_size=16, n_subsets=4)
    p_val, _ = relative_mmd_test(f_ref, f_a, f_ref[::-1], subset_size=16, n_subsets=2)
    _require(np.isfinite(kid) and np.isfinite(p_val), f"kid {kid}, p {p_val}")
    ctx.metrics[ctx.mode] = dict(kid=kid, p=p_val)
    return f"kid={kid:.5f} p={p_val:.3f}; features of {len(imgs_a)} images over {n} rank(s)"


# JAX's names in JAX's order: the core first, then the optional modes in
# the order of their value (mesh-sharded-eval, cheap and distinct, before
# the costly composition K2+sharded-pool)
_MODES = [
    ("gspmd", _mode_gspmd),
    ("shard_map+ring", _mode_shardmap_ring),
    ("shard_map+ring tmmd", _mode_ring_tmmd),
    ("gspmd+witness-gp", _mode_gspmd_witness_gp),
    ("gspmd+steps_per_dispatch=2", _mode_k_dispatch),
    ("gspmd+device-resident-data", _mode_device_data),
    ("gspmd+sharded-pool", _mode_sharded_pool),
    ("gspmd+wgan-gp", _mode_wgan_gp),
    ("shard_map+witness-gp", _mode_shardmap_witness_gp),
    ("shard_map+ring+witness-gp", _mode_ring_witness_gp),
    ("shard_map+tmmd-gathered", _mode_tmmd_gathered),
    ("mesh-sharded-eval", _mode_mesh_eval),
    ("gspmd+K2+sharded-pool", _mode_k2_sharded_pool),
]

Mode = Tuple[str, Callable[[DryrunContext], str]]


# ---------------------------------------------------------------------------
# running the modes, on every rank


def run_modes(ctx: DryrunContext, modes: Sequence[Mode], budget: float, t0: float,
              report: Callable[[Dict[str, Any]], None]) -> None:
    """Run ``modes`` in order on this rank, ``report``ing each outcome
    (rank 0's report is the one a caller reads).  Rank 0 decides each
    skip; the outcome of a mode is gathered from every rank, and a mode
    failed on one rank failed on all."""
    axis = ctx.axis
    times: List[float] = []
    for i, (name, fn) in enumerate(modes):
        left = budget - (time.time() - t0)
        # the median, not the max: mode costs vary by more than 10x
        est = sorted(times)[len(times) // 2] if times else 120.0
        skip, left, est = axis.broadcast_object((i >= N_CORE_MODES and left < est, left, est))
        if skip:
            report(dict(name=name, status="skipped", left=left, estimate=est))
            continue
        ctx.mode = name
        t_m = time.time()
        try:
            detail, error = fn(ctx), None
        except Exception as e:     # noqa: BLE001 - a failed mode is reported
            detail, error = None, f"{e!r:.300}"
        errors = axis.gather_objects(error)
        seconds = time.time() - t_m
        failed = [f"rank {r}: {e}" for r, e in enumerate(errors) if e is not None]
        if not failed:
            times.append(seconds)
        report(dict(name=name, status="failed" if failed else "ok", seconds=seconds,
                    detail="; ".join(failed) if failed else detail,
                    metrics=ctx.metrics.pop(name, None)))


class _Tally:
    """The outcomes as they arrive, printed (on the printing rank) line by
    line, and the summary."""

    def __init__(self, n: int, names: Sequence[str], budget: float, t0: float,
                 verbose: bool = True):
        self.n, self.names, self.budget, self.t0 = n, list(names), budget, t0
        self.verbose = verbose
        self.records: List[Dict[str, Any]] = []

    def _names(self, status: str) -> List[str]:
        return [r["name"] for r in self.records if r["status"] == status]

    def _print(self, line: str) -> None:
        if self.verbose:
            print(line, flush=True)

    def header(self) -> None:
        self._print(f"# dryrun_multichip({self.n}): {len(self.names)} modes, budget "
                    f"{self.budget:.0f}s, core {N_CORE_MODES}")

    def add(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)
        name = rec["name"]
        if rec["status"] == "skipped":
            self._print(f"# skipping {name}: {rec['left']:.0f}s left < "
                        f"{rec['estimate']:.0f}s estimate")
        elif rec["status"] == "ok":
            self._print(f"dryrun_multichip({self.n}) {name}: OK — {rec['detail']} "
                        f"({rec['seconds']:.0f}s)")
        else:
            self._print(f"dryrun_multichip({self.n}) {name}: FAILED — {rec['detail']}")

    def failed(self) -> List[str]:
        return self._names("failed")

    def summary(self) -> str:
        failed, skipped = self.failed(), self._names("skipped")
        return (f"dryrun_multichip: {len(self._names('ok'))}/{len(self.names)} modes OK "
                f"in {time.time() - self.t0:.0f}s"
                + (f", failed {failed}" if failed else "")
                + (f", skipped {skipped}" if skipped else ""))

    def core_passed(self) -> bool:
        # an optional mode's failure does not void a run whose core passed
        return set(self.names[:N_CORE_MODES]) <= set(self._names("ok"))

    def signal_text(self, signum: int) -> str:
        return (f"\n# dryrun signal {signum} at {time.time() - self.t0:.0f}s\n"
                + self.summary() + "\n")

    def finish(self) -> List[Dict[str, Any]]:
        self._print(self.summary())
        if self.failed():
            raise RuntimeError(f"dryrun_multichip modes failed: {self.failed()}")
        return self.records


@contextlib.contextmanager
def _signal_contract(handler, budget: float):
    """``handler`` on SIGTERM, SIGINT and SIGALRM, and the SIGALRM
    backstop at budget + 60 s, for the duration (off the main thread,
    nothing: Python takes signals there only)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    prev = {s: signal.signal(s, handler) for s in _SIGNALS}
    signal.alarm(int(budget) + 60)
    try:
        yield
    finally:
        signal.alarm(0)
        for s, h in prev.items():
            signal.signal(s, h)


def _ignore(_record) -> None:
    pass


# ---------------------------------------------------------------------------
# the entry point of the dry run


def dryrun_multichip(n_devices: int, device="cuda", axis: Optional[DataAxis] = None,
                     inputs: Optional[Dict[str, Dict[str, Any]]] = None
                     ) -> List[Dict[str, Any]]:
    """Run ``_MODES`` over ``n_devices`` ranks under the budget and signal
    contract of the module docstring; returns rank 0's outcome of each
    mode (name, status, seconds, detail, metrics), and raises after the
    summary if a mode failed.

    ``axis``: a ``DataAxis`` of ``n_devices`` ranks the caller holds; every
    rank calls with its own, the modes run on it, rank 0 prints, and no
    signal handler is installed.  Otherwise ``device`` places the ranks:
    one in this process for ``n_devices == 1``, else ``n_devices`` spawned
    processes, gloo on the CPU or NCCL one per card (no more ranks than
    cards).  ``inputs``: ``DryrunContext``'s hook.  ``_MODES`` and
    ``DRYRUN_BUDGET_S`` are read at the call (a caller may replace them);
    spawned ranks get the list itself, so its functions must be picklable."""
    modes, budget = list(_MODES), DRYRUN_BUDGET_S
    names = [name for name, _ in modes]
    t0 = time.time()
    if axis is not None:
        if axis.size != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) on an axis of {axis.size} ranks")
        tally = _Tally(n_devices, names, budget, t0, verbose=axis.index == 0)
        tally.header()
        run_modes(dryrun_context(axis, inputs), modes, budget, t0, tally.add)
        return tally.finish()
    dev = resolve_device(device)
    if dev.type == "cuda":
        try:
            check_devices(Config(num_data_shards=n_devices), dev)
        except ValueError as e:
            raise ValueError(f"{e}: dryrun_multichip({n_devices}) runs one rank per card; "
                             f"pass device='cpu' for {n_devices} gloo ranks on the "
                             "CPU") from None
    tally = _Tally(n_devices, names, budget, t0)
    if n_devices == 1:
        def bail(signum, frame):
            # async-signal-safe: no buffered print inside the handler
            os.write(1, tally.signal_text(signum).encode())
            os._exit(0 if tally.core_passed() else 3)

        with _signal_contract(bail, budget):
            tally.header()
            one = init_data_axis(rank_device(dev, 0))
            try:
                run_modes(dryrun_context(one, inputs), modes, budget, t0, tally.add)
            finally:
                one.close()
        return tally.finish()
    _launch(n_devices, dev, modes, budget, inputs, tally)
    return tally.finish()


class _Interrupted(Exception):
    """A signal reached the launcher."""


def _launch(n: int, device: torch.device, modes: Sequence[Mode], budget: float,
            inputs, tally: _Tally) -> None:
    """Run the modes on ``n`` spawned ranks (``parallel.launch``); rank 0's
    outcomes reach ``tally`` through a pipe.  A rank that fails has the
    others killed and raises here with its traceback; on a signal the ranks
    are killed, the summary written, and the process exits 0 if the core
    passed, else 3."""
    recv, send = multiprocessing.get_context("spawn").Pipe(duplex=False)
    caught: List[int] = []
    eof = False
    deadline = tally.t0 + budget + 300

    def drain() -> None:
        nonlocal eof
        while not eof and recv.poll():
            try:
                tally.add(recv.recv())
            except (EOFError, OSError):   # rank 0 has exited
                eof = True

    def poll() -> None:
        if eof:
            time.sleep(POLL_S)
        else:
            recv.poll(POLL_S)
        drain()
        if caught:
            raise _Interrupted
        if time.time() > deadline:
            raise RuntimeError(f"dryrun_multichip({n}) ranks exceeded budget+300s — killed")

    rank_args = [(modes, budget, tally.t0, inputs, send if r == 0 else None)
                 for r in range(n)]
    try:
        with _signal_contract(lambda signum, frame: caught.append(signum), budget), \
                RankGroup(_dryrun_rank, n, device, rank_args,
                          timeout=GROUP_TIMEOUT_S) as group:
            tally.header()
            group.start()
            send.close()
            try:
                group.wait(poll)
            except _Interrupted:
                pass
            except RankFailed as e:
                raise RuntimeError(f"dryrun_multichip({n}): {e}") from None
            drain()
    finally:
        send.close()
        recv.close()
    if caught:
        sys.stdout.write(tally.signal_text(caught[0]))
        sys.stdout.flush()
        raise SystemExit(0 if tally.core_passed() else 3)


def _dryrun_rank(axis: DataAxis, modes: Sequence[Mode], budget: float, t0: float, inputs,
                 send) -> None:
    """One spawned rank: run the modes on its axis, rank 0 sending each
    outcome to the launcher."""
    run_modes(dryrun_context(axis, inputs), modes, budget, t0,
              _ignore if send is None else send.send)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    fn, example_args = entry(args.device)
    with torch.no_grad():
        out = fn(*example_args)
    print("entry:", [float(x) for x in out], flush=True)
    # every visible card, as the JAX package's run takes every device; one
    # rank on the CPU
    cuda = torch.device(args.device).type == "cuda"
    dryrun_multichip(torch.cuda.device_count() if cuda else 1, args.device)


if __name__ == "__main__":
    main()
