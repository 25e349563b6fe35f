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

Data parallelism is the counterpart of ``jit_train_step(mode="shard_map")``:
one process per rank runs the per-rank program ``build_train_step(...,
axis=axis)`` on its block of the batch, with its own noise stream
(``create_state(..., rank=...)``), the global-batch losses of
``smmdax_torch.losses`` (ring or gathered), and the gradients and the
generator's BN running averages pmean'd over the ranks, so the state
stays identical on every rank.  Each rank normalises with the batch
statistics of its own block (no synced BN).  ``data_parallel_train_step``
takes the global macro-batch and hands each rank its block.

``dispatch_train_step`` is the single-device counterpart of JAX's
``jit_train_step``: k macro-steps per call on a (k, ...) batch stack, as
the trainer dispatches them.  ``sample`` and ``interpolate`` generate in
eval mode from the EMA weights, with their own ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

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


def _generate(gen: nn.Module, z: Tensor, update_stats: bool) -> Tensor:
    return gen(z, train=True, update_stats=update_stats)


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
    """shadow <- decay * shadow + (1 - decay) * live, in place."""
    keys = list(shadow)
    ema = [shadow[k] for k in keys]
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul([live[k] for k in keys],
                                                    1.0 - decay))


def _d_update(cfg: Config, state: TrainState, real: Tensor, z: Tensor,
              probe: Optional[Tensor], eps: Optional[Tensor],
              axis: Optional[DataAxis] = None) -> LossAux:
    with torch.no_grad():
        fake = _generate(state.gen, z, update_stats=False)
    _refresh_spectral(cfg, state.disc, real.device)
    loss, aux = critic_loss(cfg, state.disc, real, fake, probe=probe, eps=eps,
                            axis=axis)
    grads = torch.autograd.grad(loss, list(state.disc.parameters()))
    _pmean_(grads, axis)
    _apply_update(cfg, state.disc, grads, state.d_opt, state.lr_d)
    return aux


def _g_update(cfg: Config, state: TrainState, real: Tensor, z: Tensor,
              probe: Optional[Tensor], axis: Optional[DataAxis] = None) -> LossAux:
    with _frozen(state.disc):
        fake = _generate(state.gen, z, update_stats=True)
        loss, aux = generator_loss(cfg, state.disc, real, fake, probe=probe,
                                   axis=axis)
        grads = torch.autograd.grad(loss, list(state.gen.parameters()))
    _pmean_(grads, axis)
    # each rank normalised with its own block's statistics; the running
    # averages are pmean'd so the state stays replicated
    _pmean_([b for _, b in state.gen.named_buffers()], axis)
    _apply_update(cfg, state.gen, grads, state.g_opt, state.lr_g)
    if cfg.ema_decay > 0:
        if state.g_params_ema is None or state.g_stats_ema is None:
            raise ValueError(
                f"cfg.ema_decay={cfg.ema_decay} but the TrainState EMA "
                "shadows are missing: build the state with create_state(cfg)")
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


def _pick(noise: Noise, key: str, i: int) -> Optional[Tensor]:
    return noise[key][i] if key in noise else None


def build_train_step(cfg: Config, dsteps: int, gsteps: int,
                     axis: Optional[DataAxis] = None
                     ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """``train_step(state, real, noise=None) -> (state, metrics)``.

    ``real``: (dsteps + gsteps, B, H, W, C), uint8 (normalized here) or
    float in [-1, 1], numpy or torch; with ``axis``, this rank's block of
    the global batch (the per-rank program of JAX's ``shard_map`` mode).
    ``noise``: every draw of the macro-step (keys as ``draw_noise``), e.g.
    to replay another implementation's draws; drawn from
    ``state.generator`` when None.  Metrics are 0-d device tensors with
    the JAX package's keys, global over the ranks.

    The backward passes run on the calling thread.  On a CUDA device
    PyTorch's autograd engine otherwise runs them on a worker thread, and
    the sigma term's create-graph backward then builds its nodes there: the
    engine orders ready nodes by sequence numbers counted per thread, so the
    order in which a parameter's gradient contributions are summed (and so
    its float32 value) would depend on how many nodes each thread has made
    before in the process, and a run resumed in a new process would leave
    the uninterrupted trajectory."""

    def train_step(state: TrainState, real, noise: Optional[Noise] = None):
        with torch.autograd.set_multithreading_enabled(False):
            return _macro_step(state, real, noise)

    def _macro_step(state: TrainState, real, noise: Optional[Noise]):
        dev = state.device
        real = torch.as_tensor(real).to(dev)
        if real.dtype == torch.uint8:
            real = normalize_uint8(real)
        if real.shape[0] != dsteps + gsteps:
            raise ValueError(f"real carries {real.shape[0]} updates' batches, "
                             f"the step runs {dsteps} + {gsteps}")
        if noise is None:
            noise = draw_noise(cfg, state, dsteps, gsteps, axis)
        else:
            noise = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                     for k, v in noise.items()}

        for i in range(dsteps):
            d_aux = _d_update(cfg, state, real[i], noise["d_z"][i],
                              _pick(noise, "d_probe", i), _pick(noise, "d_eps", i),
                              axis)
        for j in range(gsteps):
            g_aux = _g_update(cfg, state, real[dsteps + j], noise["g_z"][j],
                              _pick(noise, "g_probe", j), axis)
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
    """The counterpart of ``jit_train_step(mode="shard_map")``:
    ``train_step(state, real, noise=None)`` with ``real`` the GLOBAL
    macro-batch (dsteps + gsteps, B, ...), of which this rank takes its
    contiguous block along dim 1.  ``cfg.num_data_shards`` is pinned to
    the axis size; a one-rank axis (or none) runs the single-device
    program.  ``noise`` is this rank's."""
    if axis is None or axis.size == 1:
        return build_train_step(cfg.replace(num_data_shards=1), dsteps, gsteps)
    n = axis.size
    if cfg.batch_size % n or cfg.real_batch_size % n:
        raise ValueError(
            f"data-parallel training needs batch sizes divisible by the ranks "
            f"({cfg.batch_size}/{cfg.real_batch_size} vs {n} ranks)")
    step = build_train_step(cfg.replace(num_data_shards=n), dsteps, gsteps,
                            axis=axis)

    def train_step(state: TrainState, real, noise: Optional[Noise] = None):
        real = torch.as_tensor(real)
        if real.shape[1] % n:
            raise ValueError(f"a global batch of {real.shape[1]} does not "
                             f"split over {n} ranks")
        b = real.shape[1] // n
        return step(state, real[:, axis.index * b:(axis.index + 1) * b], noise)

    return train_step


def check_single_device(cfg: Config) -> None:
    """Raise for the execution modes of the JAX trainer that the port has
    not ported yet."""
    if cfg.num_data_shards > 1:
        raise NotImplementedError(
            f"num_data_shards={cfg.num_data_shards}: the trainer over several "
            "ranks and the GSPMD-mode program are not ported yet (ROADMAP "
            "A.12); data_parallel_train_step is the per-rank step")
    if cfg.on_device_data:
        raise NotImplementedError(
            "on_device_data: batches drawn in the program are not ported yet "
            "(ROADMAP A.7)")
    if cfg.data_placement == "device":
        raise NotImplementedError(
            "data_placement='device': the device-resident dataset is not "
            "ported yet (ROADMAP A.7)")


def dispatch_train_step(cfg: Config, dsteps: int, gsteps: int,
                        steps_per_dispatch: int = 1
                        ) -> Callable[..., Tuple[TrainState, Dict[str, Tensor]]]:
    """The single-device counterpart of ``jit_train_step``: ``step(state,
    real) -> (state, metrics)`` running ``steps_per_dispatch`` (k)
    macro-steps per call.  With k > 1, ``real`` is the (k, dsteps + gsteps,
    B, H, W, C) stack, copied to the device once, and the metrics are the
    last macro-step's.  The macro-steps run one after another, so the
    state is bit-identical to k calls of ``build_train_step``."""
    check_single_device(cfg)
    step = build_train_step(cfg, dsteps, gsteps)
    k = steps_per_dispatch
    if k == 1:
        return step

    def multi(state: TrainState, reals):
        reals = torch.as_tensor(reals).to(state.device)
        if reals.shape[0] != k:
            raise ValueError(f"a dispatch of {k} macro-steps got {reals.shape[0]} batches")
        for real in reals:
            state, metrics = step(state, real)
        return state, metrics

    return multi


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
           use_ema: bool = True) -> Tensor:
    """n images (n, H, W, C) in eval mode, batch_size at a time, from the
    EMA weights and statistics when tracked (unless ``use_ema=False``).
    Latents come from ``generator`` (on the state's device), never from
    the train step's ``state.generator``: sampling leaves training as it
    was."""
    _own_generator(state, generator)
    weights = _eval_weights(state, use_ema)
    bs = cfg.batch_size
    chunks = []
    with torch.no_grad():
        for _ in range(-(-n // bs)):
            z = torch.rand((bs, cfg.z_dim), generator=generator,
                           device=state.device) * 2.0 - 1.0
            chunks.append(torch.func.functional_call(
                state.gen, weights, (z,), {"train": False}))
    return torch.cat(chunks)[:n]


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
