"""Training macro-step and sampling (port of ``smmdax/train.py``).

The JAX package threads an immutable ``TrainState`` through one jitted
program.  Here the state holds the two ``nn.Module``s (their parameters,
BatchNorm running averages and spectral-norm ``u`` buffers), Adam moments
and EMA shadows keyed by state-dict names, the learning rates as device
tensors, and the ``torch.Generator`` the step draws its noise from.  The
step updates all of it IN PLACE (no second copy of the weights) and
returns the same state object.

One macro-step is ``dsteps`` critic updates then ``gsteps`` generator
updates, as ``smmdax.train.build_train_step``:

* critic update: fakes from the generator in train mode WITHOUT updating
  its BN statistics, detached; one spectral-norm refresh on a dummy
  forward; then the loss, Adam, and the new ``u`` kept;
* generator update: the forward updates the BN statistics; Adam; then
  the EMA of the weights and of the BN statistics.

Adam is ``optax.scale_by_adam`` (eps 1e-8, bias-corrected) with the
learning rate applied by hand from ``state.lr_d`` / ``state.lr_g``,
written out so the order of operations matches.

Data parallelism runs one process per rank (one per card), each with a
``DataAxis`` over the group, in either of JAX's two modes
(``cfg.dp_mode``, ``jit_train_step(mode=...)``):

* ``shard_map``: the per-rank program ``build_train_step(...,
  axis=axis)`` on this rank's block of the batch, with its own noise
  stream (``create_state(..., rank=...)``), the global-batch losses of
  ``smmdax_torch.losses`` (ring or gathered), and the gradients and the
  generator's BN running averages pmean'd over the ranks.  Each rank
  normalises with its own block's statistics.
* ``gspmd`` (the default): the step in global-batch terms, which XLA
  partitions in the JAX package.  Every rank draws the macro-step's
  GLOBAL noise from one shared stream (rank 0's, the single-device one)
  and takes its rows of the latents and of the penalty's weights and the
  whole probe, the weights pairing the rows of the global real and fake
  batches that one device pairs; BatchNorm takes the global batch's
  statistics; the MMD is the global-batch one on the gathered features.  So two ranks compute
  what one device computes on the global batch.

Either way the state stays identical on every rank.
``data_parallel_train_step`` takes the global macro-batch and hands each
rank its block; the trainer feeds each rank its block alone.

``dispatch_train_step`` is the counterpart of JAX's ``jit_train_step``:
k macro-steps per call on a (k, ...) batch stack, as the trainer
dispatches them (over ranks, this rank's block of each).
``device_data_train_step`` and ``on_device_train_step`` are those of ``jit_train_step_device_data`` and
``jit_train_step_on_device``: each macro-step gathers its batch from a
dataset resident on the device, or draws a uniform one there, from a
stream that is a pure function of (``cfg.random_seed``, the step), so it
is the same at any k and across a resume.  Over ranks the pool is either
whole on every rank (``device_data_sharding="replicated"``: the global
gather, each rank taking its block) or split into equal slices
(``"sharded"``: each rank gathers its rows from its own slice, with an
index stream keyed also by its rank).  ``sample`` and
``interpolate`` generate in eval mode from the EMA weights, with their
own ``torch.Generator``.

With ``cfg.remat`` the losses get the critic under activation
checkpointing (``critic_fn``), the counterpart of ``jax.checkpoint`` in
the JAX package's ``_critic_fn``: its activations are recomputed in the
backward passes instead of kept.  It changes memory, not values.

The step's phases are spans of ``smmdax_torch.tracing`` (``train.*``),
recorded only while tracing is on.

``macro_step_flops`` and ``sample_flops`` count the FLOPs of a macro-step
and of ``sample`` for the bench's MFU (``smmdax_torch.bench``), from
torch's formulas over one eager call; ``macro_step_flops`` gives the basis
and the gap to the JAX package's count.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import flop_registry

from smmdax_torch import tracing
from smmdax_torch.configs import Config
from smmdax_torch.data.transforms import normalize_uint8
from smmdax_torch.losses import LossAux, critic_loss, generator_loss
from smmdax_torch.nn import build_models
from smmdax_torch.parallel.collectives import DataAxis

Tensor = torch.Tensor
Noise = Dict[str, Tensor]

_ADAM_EPS = 1e-8


@dataclasses.dataclass
class AdamState:
    """``optax.ScaleByAdamState``: step count and moments by parameter name."""

    count: int
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    generator: torch.Generator        # noise stream of the train step
    gen: nn.Module                    # generator weights + BN running stats
    disc: nn.Module                   # critic weights + spectral-norm u
    g_opt: AdamState
    d_opt: AdamState
    lr_g: Tensor                      # float32 scalars on the device: a
    lr_d: Tensor                      # scheduler may change them in place
    sched_fails: int = 0
    g_params_ema: Optional[Dict[str, Tensor]] = None   # EMA shadows when
    g_stats_ema: Optional[Dict[str, Tensor]] = None    # cfg.ema_decay > 0

    @property
    def device(self) -> torch.device:
        return self.lr_d.device


def resolve_device(device="cuda") -> torch.device:
    """The device to run on; raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


def _adam_init(module: nn.Module) -> AdamState:
    return AdamState(
        count=0,
        mu={n: torch.zeros_like(p) for n, p in module.named_parameters()},
        nu={n: torch.zeros_like(p) for n, p in module.named_parameters()})


def create_state(cfg: Config, seed: int = 0, device="cuda",
                 rank: int = 0) -> TrainState:
    """Fresh state: weights drawn from ``seed`` (on the CPU, so every
    device and rank starts from the same weights), noise stream seeded on
    the device.  Each data-parallel ``rank`` draws from a stream of its
    own (the counterpart of JAX's ``fold_in(rng, axis_index)``); rank 0's
    is the single-device stream."""
    dev = resolve_device(device)
    gen, disc = build_models(cfg, torch.Generator().manual_seed(seed))
    gen.to(dev)
    disc.to(dev)
    noise = torch.Generator(device=dev)
    noise.manual_seed(seed + 1 + (rank << 32))

    def shadow(tensors):
        return {n: t.detach().clone() for n, t in tensors}

    ema = cfg.ema_decay > 0
    return TrainState(
        step=0, generator=noise, gen=gen, disc=disc,
        g_opt=_adam_init(gen), d_opt=_adam_init(disc),
        lr_g=torch.tensor(cfg.lr_g, dtype=torch.float32, device=dev),
        lr_d=torch.tensor(cfg.lr_d, dtype=torch.float32, device=dev),
        g_params_ema=shadow(gen.named_parameters()) if ema else None,
        g_stats_ema=shadow(gen.named_buffers()) if ema else None)


# ---------------------------------------------------------------------------
# single-update building blocks


def _generate(gen: nn.Module, z: Tensor, update_stats: bool,
              bn_axis: Optional[DataAxis] = None) -> Tensor:
    return gen(z, train=True, update_stats=update_stats, axis=bn_axis)


def _refresh_spectral(cfg: Config, disc: nn.Module, device) -> None:
    """One power-iteration step for every SN layer, kept in ``u``."""
    if not cfg.with_sn:
        return
    with torch.no_grad():
        disc(torch.zeros((1,) + cfg.image_shape, device=device), update_sn=True)


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """No gradients for ``module``'s parameters inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags):
            p.requires_grad_(flag)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _apply_update(cfg: Config, module: nn.Module, grads, opt: AdamState,
                  lr: Tensor) -> None:
    """params += -lr * scale_by_adam(grads), in place."""
    names = [n for n, _ in module.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    mu = [opt.mu[n] for n in names]
    nu = [opt.nu[n] for n in names]
    b1, b2 = cfg.beta1, cfg.beta2
    opt.count += 1
    with torch.no_grad():
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, opt.count))
        den = torch._foreach_div(nu, _bias_correction(b2, opt.count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _ADAM_EPS)
        updates = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)


def _pmean_(tensors, axis: Optional[DataAxis]) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    all-reduce over their concatenation."""
    if axis is None or not tensors:
        return
    with torch.no_grad():
        flat = axis.pmean(torch.cat([t.reshape(-1) for t in tensors]))
        for t, f in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(f.view_as(t))


def _ema_update(decay: float, shadow: Dict[str, Tensor],
                live: Dict[str, Tensor]) -> None:
    """shadow <- decay * shadow + (1 - decay) * live, in place (nothing
    for a generator without BN statistics)."""
    keys = list(shadow)
    if not keys:
        return
    ema = [shadow[k] for k in keys]
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul([live[k] for k in keys],
                                                    1.0 - decay))


def critic_fn(cfg: Config, disc: nn.Module) -> Callable[[Tensor], Tensor]:
    """The critic the losses call: ``disc`` itself, or with ``cfg.remat``
    its forward under ``torch.utils.checkpoint`` (non-reentrant, which
    composes with the create-graph backward of sigma and the penalties)."""
    if not cfg.remat:
        return disc

    def critic(x: Tensor) -> Tensor:
        return checkpoint(disc, x, use_reentrant=False)

    return critic


def _penalty_pairs(real: Tensor, fake: Tensor, axis: DataAxis
                   ) -> Tuple[Tensor, Tensor]:
    """GSPMD mode with unequal real and fake batches: the rows this rank's
    penalty weights pair, rows [r m/n, (r+1) m/n) of the GLOBAL real[:m]
    and fake[:m] (m = min of the two batches), from the gathered blocks.
    Each rank's own blocks are those rows only when the batches are equal."""
    with torch.no_grad():
        real, fake = axis.all_gather(real), axis.all_gather(fake)
    b = min(real.shape[0], fake.shape[0]) // axis.size
    rows = slice(axis.index * b, (axis.index + 1) * b)
    return real[rows], fake[rows]


def _d_update(cfg: Config, state: TrainState, real: Tensor, z: Tensor,
              probe: Optional[Tensor], eps: Optional[Tensor],
              axis: Optional[DataAxis] = None,
              bn_axis: Optional[DataAxis] = None) -> LossAux:
    with tracing.span("train.d_update"):
        with tracing.span("train.d_generate"), torch.no_grad():
            fake = _generate(state.gen, z, update_stats=False, bn_axis=bn_axis)
        with tracing.span("train.sn_refresh"):
            _refresh_spectral(cfg, state.disc, real.device)
        with tracing.span("train.d_loss"):
            pairs = None
            # bn_axis is set in GSPMD mode only
            if eps is not None and bn_axis is not None and real.shape[0] != fake.shape[0]:
                pairs = _penalty_pairs(real, fake, bn_axis)
            loss, aux = critic_loss(cfg, critic_fn(cfg, state.disc), real, fake, probe=probe,
                                    eps=eps, axis=axis, pairs=pairs)
        with tracing.span("train.d_grad"):
            grads = torch.autograd.grad(loss, list(state.disc.parameters()))
            _pmean_(grads, axis)
        with tracing.span("train.d_adam"):
            _apply_update(cfg, state.disc, grads, state.d_opt, state.lr_d)
    return aux


def _g_update(cfg: Config, state: TrainState, real: Tensor, z: Tensor,
              probe: Optional[Tensor], axis: Optional[DataAxis] = None,
              bn_axis: Optional[DataAxis] = None) -> LossAux:
    with tracing.span("train.g_update"):
        with _frozen(state.disc):
            with tracing.span("train.g_loss"):
                fake = _generate(state.gen, z, update_stats=True, bn_axis=bn_axis)
                loss, aux = generator_loss(cfg, critic_fn(cfg, state.disc), real, fake,
                                           probe=probe, axis=axis)
            with tracing.span("train.g_grad"):
                grads = torch.autograd.grad(loss, list(state.gen.parameters()))
                _pmean_(grads, axis)
        with tracing.span("train.g_adam"):
            if bn_axis is None:
                # each rank normalised with its own block's statistics; the
                # running averages are pmean'd so the state stays replicated
                # (with the global statistics they are equal on every rank
                # already)
                _pmean_([b for _, b in state.gen.named_buffers()], axis)
            _apply_update(cfg, state.gen, grads, state.g_opt, state.lr_g)
        if cfg.ema_decay > 0:
            if state.g_params_ema is None or state.g_stats_ema is None:
                raise ValueError(
                    f"cfg.ema_decay={cfg.ema_decay} but the TrainState EMA "
                    "shadows are missing: build the state with create_state(cfg)")
            with tracing.span("train.ema"):
                _ema_update(cfg.ema_decay, state.g_params_ema,
                            dict(state.gen.named_parameters()))
                _ema_update(cfg.ema_decay, state.g_stats_ema,
                            dict(state.gen.named_buffers()))
    return aux


# ---------------------------------------------------------------------------
# the macro-step


def _needs_probe(cfg: Config) -> bool:
    return cfg.with_scaling and cfg.scaling_grad_estimator == "hutchinson"


def _needs_eps(cfg: Config) -> bool:
    return cfg.model == "wgan-gp" or cfg.gradient_penalty > 0


def _fake_count(cfg: Config, axis: Optional[DataAxis]) -> int:
    """Generated batch per update: global without an axis, this rank's
    share with one (batch_size is the global fake batch)."""
    return cfg.batch_size if axis is None else cfg.batch_size // axis.size


def draw_noise(cfg: Config, state: TrainState, dsteps: int, gsteps: int,
               axis: Optional[DataAxis] = None) -> Noise:
    """Every random draw of one macro-step (this rank's, with ``axis``),
    from ``state.generator`` on the device: latents ``d_z``/``g_z``
    uniform in [-1, 1], Rademacher probes ``d_probe``/``g_probe``
    (hutchinson sigma), and the penalty's interpolation weights ``d_eps``
    (b, 1, 1, 1) per critic update."""
    dev, g = state.device, state.generator
    nz = _fake_count(cfg, axis)
    n_real = cfg.real_batch_size if axis is None else cfg.real_batch_size // axis.size

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def rademacher(shape):
        return torch.randint(0, 2, shape, generator=g, device=dev).float() * 2.0 - 1.0

    noise = {"d_z": uniform((dsteps, nz, cfg.z_dim), -1.0, 1.0),
             "g_z": uniform((gsteps, nz, cfg.z_dim), -1.0, 1.0)}
    if _needs_probe(cfg):
        noise["d_probe"] = rademacher((dsteps, cfg.dof_dim))
        noise["g_probe"] = rademacher((gsteps, cfg.dof_dim))
    if _needs_eps(cfg):
        noise["d_eps"] = uniform((dsteps, min(nz, n_real), 1, 1, 1))
    return noise


def _rank_rows(cfg: Config, noise: Noise, axis: DataAxis) -> Noise:
    """This rank's share of a macro-step's GLOBAL draws (GSPMD mode): its
    block of the latents and of the penalty's weights, the whole probe.
    The weights pair row i of the real and the fake batch: the rank's
    block of them pairs the global rows ``_penalty_pairs`` takes."""
    n, r = axis.size, axis.index
    out = dict(noise)
    b = cfg.batch_size // n
    for key in ("d_z", "g_z"):
        out[key] = noise[key][:, r * b:(r + 1) * b]
    if "d_eps" in noise:
        be = min(b, cfg.real_batch_size // n)
        out["d_eps"] = noise["d_eps"][:, r * be:(r + 1) * be]
    return out


def _pick(noise: Noise, key: str, i: int) -> Optional[Tensor]:
    return noise[key][i] if key in noise else None


def build_train_step(cfg: Config, dsteps: int, gsteps: int,
                     axis: Optional[DataAxis] = None
                     ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """``train_step(state, real, noise=None) -> (state, metrics)``.

    ``real``: (dsteps + gsteps, B, H, W, C), uint8 (normalized here) or
    float in [-1, 1], numpy or torch; with ``axis``, this rank's block of
    the global batch, and ``cfg.dp_mode`` picks the program: ``shard_map``,
    the per-rank program of JAX's shard_map mode, or ``gspmd``, global-batch
    code (module docstring; ``use_ring_mmd`` implies shard_map).
    ``noise``: every draw of the macro-step (keys as ``draw_noise``), e.g.
    to replay another implementation's draws; drawn from
    ``state.generator`` when None.  In ``shard_map`` mode they are this
    rank's draws, in ``gspmd`` mode the global ones, of which each rank
    takes its rows.  Metrics are 0-d device tensors with the JAX
    package's keys, global over the ranks.

    The backward passes run on the calling thread.  On a CUDA device
    PyTorch's autograd engine otherwise runs them on a worker thread, and
    the sigma term's create-graph backward then builds its nodes there: the
    engine orders ready nodes by sequence numbers counted per thread, so the
    order in which a parameter's gradient contributions are summed (and so
    its float32 value) would depend on how many nodes each thread has made
    before in the process, and a run resumed in a new process would leave
    the uninterrupted trajectory."""

    # the ring is a per-rank program: it implies shard_map, as in JAX
    gspmd = axis is not None and cfg.dp_mode == "gspmd" and not cfg.use_ring_mmd
    # GSPMD: the losses are the global-batch ones (the JAX program has no
    # axis, so neither the per-rank estimator nor the ring applies), BN
    # takes the global statistics, the draws are global
    loss_cfg = cfg.replace(global_batch_mmd=True, use_ring_mmd=False) if gspmd else cfg
    bn_axis = axis if gspmd else None
    draw_axis = None if gspmd else axis

    def train_step(state: TrainState, real, noise: Optional[Noise] = None):
        with torch.autograd.set_multithreading_enabled(False):
            return _macro_step(state, real, noise)

    def _macro_step(state: TrainState, real, noise: Optional[Noise]):
        dev = state.device
        with tracing.span("train.h2d"):
            real = torch.as_tensor(real).to(dev)
            if real.dtype == torch.uint8:
                real = normalize_uint8(real)
        if real.shape[0] != dsteps + gsteps:
            raise ValueError(f"real carries {real.shape[0]} updates' batches, "
                             f"the step runs {dsteps} + {gsteps}")
        if noise is None:
            with tracing.span("train.noise"):
                noise = draw_noise(cfg, state, dsteps, gsteps, draw_axis)
        else:
            noise = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                     for k, v in noise.items()}
        if gspmd:
            noise = _rank_rows(cfg, noise, axis)

        for i in range(dsteps):
            d_aux = _d_update(loss_cfg, state, real[i], noise["d_z"][i],
                              _pick(noise, "d_probe", i), _pick(noise, "d_eps", i),
                              axis, bn_axis)
        for j in range(gsteps):
            g_aux = _g_update(loss_cfg, state, real[dsteps + j], noise["g_z"][j],
                              _pick(noise, "g_probe", j), axis, bn_axis)
        state.step += 1
        metrics = {
            "d_loss_mmd2": d_aux.mmd2,
            "d_sigma": d_aux.sigma,
            "d_gp": d_aux.gp,
            "d_ratio": d_aux.ratio,
            "g_loss": g_aux.ratio if cfg.model != "wgan-gp" else -g_aux.critic_fake,
            "g_mmd2": g_aux.mmd2,
            "critic_real": d_aux.critic_real,
            "critic_fake": d_aux.critic_fake,
            "lr_d": state.lr_d,
            "lr_g": state.lr_g,
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def data_parallel_train_step(cfg: Config, dsteps: int, gsteps: int,
                             axis: Optional[DataAxis]
                             ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The counterpart of ``jit_train_step`` on a mesh:
    ``train_step(state, real, noise=None)`` with ``real`` the GLOBAL
    macro-batch (dsteps + gsteps, B, ...), of which this rank takes its
    contiguous block along dim 1.  ``cfg.num_data_shards`` is pinned to
    the axis size; a one-rank axis (or none) runs the single-device
    program.  The step runs in ``cfg.dp_mode`` (``use_ring_mmd`` implies
    shard_map).  ``noise`` is this rank's in shard_map mode and the global
    draws in gspmd mode."""
    if axis is None or axis.size == 1:
        return build_train_step(cfg.replace(num_data_shards=1), dsteps, gsteps)
    n = axis.size
    if cfg.batch_size % n or cfg.real_batch_size % n:
        raise ValueError(
            f"data-parallel training needs batch sizes divisible by the ranks "
            f"({cfg.batch_size}/{cfg.real_batch_size} vs {n} ranks)")
    cfg = cfg.replace(num_data_shards=n)
    step = build_train_step(cfg, dsteps, gsteps, axis=axis)

    def train_step(state: TrainState, real, noise: Optional[Noise] = None):
        real = torch.as_tensor(real)
        if real.shape[1] % n:
            raise ValueError(f"a global batch of {real.shape[1]} does not "
                             f"split over {n} ranks")
        b = real.shape[1] // n
        return step(state, real[:, axis.index * b:(axis.index + 1) * b], noise)

    return train_step


def check_devices(cfg: Config, device) -> None:
    """Refuse more shards than the cards visible, as ``make_mesh`` refuses
    more shards than devices: a run over several ranks never quietly runs
    on fewer.  CPU ranks (gloo) are processes and have no such limit."""
    if torch.device(device).type != "cuda" or cfg.num_data_shards <= 1:
        return
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cfg.num_data_shards > visible:
        raise ValueError(f"num_data_shards={cfg.num_data_shards} but only "
                         f"{visible} CUDA devices are visible")


def check_ranks(cfg: Config, axis: Optional[DataAxis]) -> Optional[DataAxis]:
    """The axis a step builder (or the trainer) runs over, None for one
    rank, checked against the config: a
    config of n shards needs an axis of n ranks (no run over several
    ranks quietly becomes one), and its batches must split over them."""
    n = 1 if axis is None else axis.size
    if cfg.num_data_shards != n:
        raise ValueError(
            f"num_data_shards={cfg.num_data_shards} but the step runs on {n} "
            f"rank(s): start one process per rank (python -m smmdax_torch.main "
            f"--num_data_shards {cfg.num_data_shards}) and pass each its DataAxis")
    if n > 1 and (cfg.batch_size % n or cfg.real_batch_size % n):
        raise ValueError(
            f"data-parallel training needs batch sizes divisible by the ranks "
            f"({cfg.batch_size}/{cfg.real_batch_size} vs {n} ranks)")
    return axis if n > 1 else None


def _block(t: Tensor, axis: Optional[DataAxis]) -> Tensor:
    """This rank's contiguous block of dim 1 of a global macro-batch."""
    if axis is None:
        return t
    b = t.shape[1] // axis.size
    return t[:, axis.index * b:(axis.index + 1) * b]


def _repeat(step, k: int):
    """``k`` calls of ``step`` per call, returning the last metrics."""
    if k == 1:
        return step

    def multi(state: TrainState, *args):
        for _ in range(k):
            state, metrics = step(state, *args)
        return state, metrics

    return multi


def dispatch_train_step(cfg: Config, dsteps: int, gsteps: int,
                        steps_per_dispatch: int = 1, axis: Optional[DataAxis] = None
                        ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The counterpart of ``jit_train_step``: ``step(state, real) ->
    (state, metrics)`` running ``steps_per_dispatch`` (k) macro-steps per
    call.  With k > 1, ``real`` is the (k, dsteps + gsteps, B, H, W, C)
    stack, copied to the device once, and the metrics are the last
    macro-step's.  The macro-steps run one after another, so the state is
    bit-identical to k calls of ``build_train_step``.  With ``axis``,
    ``real`` is this rank's block (B / ranks rows) and the step runs in
    ``cfg.dp_mode``.  Each call is one ``train.dispatch`` span
    (``smmdax_torch.tracing``)."""
    axis = check_ranks(cfg, axis)
    step = build_train_step(cfg, dsteps, gsteps, axis=axis)
    k = steps_per_dispatch

    if k == 1:
        def single(state: TrainState, real, noise: Optional[Noise] = None):
            with tracing.span("train.dispatch"):
                return step(state, real, noise)

        return single

    def multi(state: TrainState, reals):
        with tracing.span("train.dispatch"):
            with tracing.span("train.h2d"):
                reals = torch.as_tensor(reals).to(state.device)
            if reals.shape[0] != k:
                raise ValueError(f"a dispatch of {k} macro-steps got {reals.shape[0]} batches")
            for real in reals:
                state, metrics = step(state, real)
            return state, metrics

    return multi


# tags of the two in-program data streams (JAX's fold-in constants)
_POOL_TAG = 0x0DA7A0D1
_SYNTH_TAG = 0x0DDDA7A


def data_stream(cfg: Config, tag: int, step: int, device,
                rank: Optional[int] = None) -> torch.Generator:
    """The generator of macro-step ``step``'s in-program data: seeded from
    (``cfg.random_seed``, ``tag``, ``step``) alone, or with a ``rank`` for
    a stream of that rank's own, so the stream is the same at any dispatch
    size and across a resume.  It is never ``state.generator``, whose
    draws are the step's noise."""
    key = [cfg.random_seed, tag, step] + ([] if rank is None else [rank])
    seed = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def batch_indices(generator: torch.Generator, pool_n: int, per_step: int,
                  nb: int) -> Tensor:
    """(per_step, nb) gather indices into a pool of ``pool_n``, without
    replacement within each row (a duplicate inside one batch biases the
    unbiased MMD^2 upward), on ``generator``'s device:

    * the macro-step fits the pool: one permutation sliced into rows, so
      no sample recurs in the whole macro-step;
    * a macro-step larger than the pool: each row drawn on its own,
      without replacement;
    * a pool smaller than the batch: draws with replacement."""
    dev = generator.device
    if pool_n < nb:
        return torch.randint(0, pool_n, (per_step, nb), generator=generator, device=dev)
    if per_step * nb <= pool_n:
        perm = torch.randperm(pool_n, generator=generator, device=dev)
        return perm[:per_step * nb].reshape(per_step, nb)
    keys = torch.rand((per_step, pool_n), generator=generator, device=dev)
    return torch.sort(keys, dim=1, stable=True).indices[:, :nb]


def device_data_train_step(cfg: Config, dsteps: int, gsteps: int,
                           steps_per_dispatch: int = 1, axis: Optional[DataAxis] = None
                           ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The counterpart of ``jit_train_step_device_data``: ``step(state,
    pool) -> (state, metrics)``, with ``pool`` the uint8 dataset (N, H, W,
    C) on the state's device.  Each of the k macro-steps gathers its
    (dsteps + gsteps, real_batch_size) batch there by ``batch_indices``
    from its ``data_stream``.  Over ranks, ``pool`` is the whole dataset
    (``device_data_sharding="replicated"``: the global gather, this rank
    taking its block of it) or this rank's equal slice (``"sharded"``:
    B / ranks rows gathered from the slice, from a stream of this rank's
    own; the index never leaves the rank)."""
    axis = check_ranks(cfg, axis)
    step = build_train_step(cfg, dsteps, gsteps, axis=axis)
    per_step = dsteps + gsteps
    sharded = axis is not None and cfg.device_data_sharding == "sharded"

    def data_step(state: TrainState, pool: Tensor):
        if pool.device != state.device:
            raise ValueError(f"the pool is on {pool.device}, the state on {state.device}")
        if sharded:
            g = data_stream(cfg, _POOL_TAG, state.step, state.device, rank=axis.index)
            idx = batch_indices(g, pool.shape[0], per_step,
                                cfg.real_batch_size // axis.size)
            return step(state, pool[idx])
        g = data_stream(cfg, _POOL_TAG, state.step, state.device)
        idx = batch_indices(g, pool.shape[0], per_step, cfg.real_batch_size)
        return step(state, pool[_block(idx, axis)])

    return _repeat(data_step, steps_per_dispatch)


def on_device_train_step(cfg: Config, dsteps: int, gsteps: int,
                         steps_per_dispatch: int = 1, axis: Optional[DataAxis] = None
                         ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The counterpart of ``jit_train_step_on_device``: ``step(state) ->
    (state, metrics)``; each of the k macro-steps draws a real batch
    uniform in [-1, 1] on the device from its ``data_stream`` (noise, not
    the dataset: a measurement and smoke-training mode).  Over ranks each
    rank draws the global batch and takes its block."""
    axis = check_ranks(cfg, axis)
    step = build_train_step(cfg, dsteps, gsteps, axis=axis)
    shape = (dsteps + gsteps, cfg.real_batch_size) + cfg.image_shape

    def synth_step(state: TrainState):
        g = data_stream(cfg, _SYNTH_TAG, state.step, state.device)
        real = torch.rand(shape, generator=g, device=state.device) * 2.0 - 1.0
        return step(state, _block(real, axis))

    return _repeat(synth_step, steps_per_dispatch)


# ---------------------------------------------------------------------------
# FLOP accounting (MFU)


class _FlopCounter(TorchDispatchMode):
    """Adds up ``torch.utils.flop_counter.flop_registry``'s formula of every
    aten op that reaches the dispatcher, by op name (``by_op``).  No module
    hooks: ``FlopCounterMode``'s module tracker raises inside the step's
    ``torch.autograd.grad`` calls (sigma, the penalties).  The mode is
    thread-local, so the backward passes must run on the calling thread,
    as ``build_train_step`` runs them."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = collections.Counter()

    def count(self, packet, args, kwargs, out) -> None:
        formula = flop_registry.get(packet)
        if formula is not None:
            self.by_op[packet.__name__] += formula(*args, **kwargs, out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count(func._overloadpacket, args, kwargs, out)
        return out


def _op_flops(fn: Callable, *args) -> float:
    """FLOPs of one call ``fn(*args)``, the counterpart of ``_ir_flops``:
    the call runs once under ``_FlopCounter``.  The formulas read shapes
    only, so the count is the same on the CPU and on the card."""
    counter = _FlopCounter()
    with counter:
        fn(*args)
    return float(sum(counter.by_op.values()))


def macro_step_flops(cfg: Config, dsteps: int, gsteps: int, device="cuda") -> float:
    """FLOPs of ONE macro-step (``dsteps`` critic + ``gsteps`` generator
    updates of ``build_train_step``) for MFU accounting.

    It counts one eager macro-step on a fresh ``create_state`` and all-zero
    uint8 batches, never a caller's state.  The fused CUDA ops match no
    formula and would count as 0, so the dense path runs
    (``use_pallas="off"``, as in the JAX package): it computes the same math
    through ``mm``.

    Basis: the registry's formulas, 2 FLOPs per multiply-add of ``mm``,
    ``addmm``, ``bmm``, ``convolution`` and ``convolution_backward``.  A
    convolution counts every tap, padding included, which is what cuDNN's
    implicit GEMM multiplies; XLA counts only the taps inside the input, so
    one 3x3 SAME convolution (N 8, C 16) counts 1.44x XLA's at 4x4, 1.19x at
    8x8, 1.089x at 16x16 and 1.043x at 32x32.  Elementwise work is not
    counted.  Against JAX's ``macro_step_flops`` (both dense, bf16,
    hutchinson; gf / df 16, B 8, dof 8): mmd 1d+1g 1.052x, sn-smmd 1d+1g
    1.111x, 5d+1g 1.165x; the flagship (5d+1g, B 64, gf / df 64, dof 16)
    3.8557e12 against 3.3003e12, 1.168x.  Padding is ~5 points of it.  The
    rest is the sigma term, which adds 41% more than in JAX (2.216e9
    against 1.570e9 at 1d+1g): 5.43e8 of it is ``convolution_backward`` on
    all-zero gradients (the outer backward of sigma's create-graph pass
    reaches the critic's forward graph through ``threshold_backward``,
    whose derivative in its input is a zero tensor, and autograd runs the
    convolutions' backward on it; JAX's symbolic zeros skip it), and the
    remainder is padding.  That work runs on the card too.  The count on
    the card equals the CPU's (``chip_smoke.py`` phase 13)."""
    cfg = cfg.replace(use_pallas="off")
    state = create_state(cfg, device=device)
    step = build_train_step(cfg, dsteps, gsteps)
    real = torch.zeros((dsteps + gsteps, cfg.real_batch_size) + cfg.image_shape,
                       dtype=torch.uint8, device=state.device)
    return _op_flops(step, state, real)


def sample_flops(cfg: Config, n: int, device="cuda") -> float:
    """FLOPs of ``sample(cfg, state, generator, n)``: one eval-mode
    generator chunk of ``batch_size``, times the ``ceil(n / batch_size)``
    chunks ``sample`` runs (the concatenation is free at this precision)."""
    dev = resolve_device(device)
    gen, _ = build_models(cfg, torch.Generator().manual_seed(0))
    gen.to(dev)
    z = torch.zeros((cfg.batch_size, cfg.z_dim), device=dev)
    with torch.no_grad():
        per_chunk = _op_flops(lambda zz: gen(zz, train=False), z)
    return per_chunk * (-(-n // cfg.batch_size))


# ---------------------------------------------------------------------------
# eval-mode generation


def eval_g_params(state: TrainState) -> Dict[str, Tensor]:
    """Generator weights for eval-mode generation: the EMA shadow when
    one is tracked, else the live weights."""
    if state.g_params_ema is not None:
        return state.g_params_ema
    return dict(state.gen.named_parameters())


def eval_g_stats(state: TrainState) -> Dict[str, Tensor]:
    """BN running averages matching ``eval_g_params`` (same epoch)."""
    if state.g_stats_ema is not None:
        return state.g_stats_ema
    return dict(state.gen.named_buffers())


def _eval_weights(state: TrainState, use_ema: bool) -> Dict[str, Tensor]:
    if use_ema:
        return {**eval_g_params(state), **eval_g_stats(state)}
    return {**dict(state.gen.named_parameters()), **dict(state.gen.named_buffers())}


def _own_generator(state: TrainState, generator: torch.Generator) -> None:
    if generator is state.generator:
        raise ValueError("sampling needs its own torch.Generator: drawing "
                         "from state.generator would shift the train step's noise")


def sample(cfg: Config, state: TrainState, generator: torch.Generator, n: int,
           use_ema: bool = True, rows: Optional[Tuple[int, int]] = None) -> Tensor:
    """n images (n, H, W, C) in eval mode, batch_size at a time, from the
    EMA weights and statistics when tracked (unless ``use_ema=False``).
    Latents come from ``generator`` (on the state's device), never from
    the train step's ``state.generator``: sampling leaves training as it
    was.  ``rows=(lo, hi)``, ``lo`` a multiple of batch_size: only images
    [lo, hi) of the n, decoded from the same latents (every latent of the
    n is drawn), so ranks that split the rows make the one-device set."""
    _own_generator(state, generator)
    weights = _eval_weights(state, use_ema)
    bs = cfg.batch_size
    lo, hi = (0, n) if rows is None else rows
    if lo % bs or not 0 <= lo <= hi <= n:
        raise ValueError(f"rows {rows} of {n} samples in batches of {bs}")
    with tracing.span("train.sample"):
        zs = [torch.rand((bs, cfg.z_dim), generator=generator, device=state.device) * 2.0 - 1.0
              for _ in range(-(-n // bs))]
        chunks = [torch.empty((0,) + cfg.image_shape, device=state.device)]
        with torch.no_grad():
            for z in zs[lo // bs:-(-hi // bs)]:
                chunks.append(torch.func.functional_call(
                    state.gen, weights, (z,), {"train": False}))
        return torch.cat(chunks)[:hi - lo]


def interpolate(cfg: Config, state: TrainState, generator: torch.Generator,
                rows: int = 8, cols: int = 8, use_ema: bool = True) -> Tensor:
    """Latent interpolation grid (rows * cols, H, W, C): each row walks z
    linearly between two endpoints uniform in [-1, 1], decoded in eval
    mode from the EMA weights when tracked (unless ``use_ema=False``).
    The endpoints come from ``generator``, as in ``sample``."""
    _own_generator(state, generator)
    dev = state.device
    z0 = torch.rand((rows, cfg.z_dim), generator=generator, device=dev) * 2.0 - 1.0
    z1 = torch.rand((rows, cfg.z_dim), generator=generator, device=dev) * 2.0 - 1.0
    t = torch.linspace(0.0, 1.0, cols, device=dev)[None, :, None]
    z = (z0[:, None, :] * (1.0 - t) + z1[:, None, :] * t).reshape(rows * cols, cfg.z_dim)
    with torch.no_grad():
        return torch.func.functional_call(state.gen, _eval_weights(state, use_ema),
                                          (z,), {"train": False})
