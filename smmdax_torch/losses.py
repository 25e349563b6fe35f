"""Loss dispatch: mmd | tmmd | smmd | sn-smmd | wgan-gp (port of
``smmdax/losses.py``).

Losses are functions of a critic callable ``critic(x) -> (B, dof_dim)``
features, as in the JAX package.  Noise enters as arguments: the
Rademacher ``probe`` of the hutchinson sigma estimator and the per-sample
interpolation weights ``eps`` of the gradient penalties.  Both returned
losses are minimized.

Estimators of sigma (``Config.scaling_grad_estimator``):
``exact`` is ``torch.func.vmap(jacrev(...))`` over single samples, or,
with ``cfg.remat`` (a critic under ``torch.utils.checkpoint``, which
``torch.func`` transforms refuse), one ``torch.autograd.grad`` per
feature; ``sum`` and ``hutchinson`` are one ``torch.autograd.grad`` each.  With
``create_graph=True`` (the critic step) sigma stays differentiable in the
critic's parameters: double backprop, as in the JAX package.

Data parallelism: with ``axis`` (a ``DataAxis``) ``real``/``fake`` are
this rank's blocks and every statistic is over the global batch: the ring
estimators (``use_ring_mmd``) or gathered features for the kernel terms,
``pmean`` for per-sample means, sigma and the penalties.  So the loss
value, and the pmean of the ranks' gradients, are those of the
single-device global-batch computation.  The GSPMD-mode step calls these
with ``global_batch_mmd`` on and the ring off, which gives the JAX GSPMD
program's global-batch losses.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from smmdax_torch import tracing
from smmdax_torch.configs import Config
from smmdax_torch.cuda.dispatch import should_use_pallas
from smmdax_torch.cuda.mmd_kernel import fused_mmd2
from smmdax_torch.kernels import (kernel_cross, kernel_matrices, mmd2,
                                  mmd2_and_ratio)
from smmdax_torch.kernels.kernels import KernelBlocks
from smmdax_torch.kernels.smmd import smmd_scale
from smmdax_torch.parallel.collectives import DataAxis
from smmdax_torch.parallel.ring import (RING_KERNELS, ring_mmd2,
                                        ring_mmd2_and_ratio)

Tensor = torch.Tensor
Critic = Callable[[Tensor], Tensor]

class LossAux(NamedTuple):
    """Diagnostics reported every step."""

    mmd2: Tensor
    sigma: Tensor         # SMMD normalizer (1.0 when scaling off)
    gp: Tensor            # gradient penalty value (0.0 when off)
    ratio: Tensor         # the objective (mmd2 / sigma for smmd)
    critic_real: Tensor   # mean scalar critic on real
    critic_fake: Tensor


def _blocks(cfg: Config, f_fake: Tensor, f_real: Tensor) -> KernelBlocks:
    return kernel_matrices(cfg.kernel, f_fake, f_real,
                           rbf_sigmas=cfg.rbf_sigmas, rq_alphas=cfg.rq_alphas,
                           add_dot=cfg.kernel_add_dot)


def _kernel_params(cfg: Config):
    return cfg.rbf_sigmas if cfg.kernel == "gaussian" else cfg.rq_alphas


def _add_dot(cfg: Config) -> float:
    """Effective mix_rq_dot weight: rq only, as kernel_matrices reads it."""
    return cfg.kernel_add_dot if cfg.kernel == "rq" else 0.0


def _fused(cfg: Config, f_a: Tensor, f_b: Tensor,
           axis: Optional[DataAxis] = None) -> bool:
    """Fused-vs-dense decision for the Gram blocks of these features.  A
    multi-shard config without an axis never fuses, as in the JAX package.
    There the guard keeps a ``pallas_call`` out of a GSPMD program, which
    XLA would partition around an opaque call.  The port's GSPMD mode is
    an explicit per-rank program with an axis: the kernels run on the
    all-gathered rows (64 per rank, gathered to 64 * ranks) of every rank,
    and the guard does not apply to it."""
    if axis is None and cfg.num_data_shards > 1:
        return False
    return should_use_pallas(cfg.use_pallas, cfg.kernel, f_a.shape[0],
                             f_b.shape[0], min_rows=cfg.pallas_min_rows,
                             platform=f_a.device.type)


def _ring_eligible(cfg: Config, axis: Optional[DataAxis]) -> bool:
    """The ring estimators serve every loss-surface kernel per rank."""
    return axis is not None and cfg.use_ring_mmd and cfg.kernel in RING_KERNELS


def _critic_features(cfg: Config, critic: Critic, real: Tensor,
                     fake: Tensor) -> Tuple[Tensor, Tensor]:
    """critic(real), critic(fake); one application on the concatenated
    batch under ``fuse_critic_batches`` (the critic has no BatchNorm)."""
    if cfg.fuse_critic_batches and real.shape[1:] == fake.shape[1:]:
        f = critic(torch.cat([real, fake], dim=0))
        return f[:real.shape[0]], f[real.shape[0]:]
    return critic(real), critic(fake)


def _gather(f: Tensor, axis: Optional[DataAxis]) -> Tensor:
    """This rank's (b, d) features -> the global (B_g, d) on every rank."""
    return f if axis is None else axis.all_gather(f)


def _pmean(v: Tensor, axis: Optional[DataAxis]) -> Tensor:
    return v if axis is None else axis.pmean(v)


def mmd2_objective(cfg: Config, f_fake: Tensor, f_real: Tensor,
                   axis: Optional[DataAxis] = None) -> Tensor:
    """Global-batch MMD^2 over the configured path:

    * ``global_batch_mmd=False`` with an axis: each rank's local estimator,
      averaged over ranks;
    * ``use_ring_mmd`` with an axis: the block-row ring over this rank's
      features;
    * otherwise the gathered features through the fused CUDA pair sums
      when dispatched (``use_pallas``), else the dense Gram blocks (the
      oracle path)."""
    with tracing.span("losses.mmd"):
        return _mmd2_objective(cfg, f_fake, f_real, axis)


def _mmd2_objective(cfg: Config, f_fake: Tensor, f_real: Tensor,
                    axis: Optional[DataAxis]) -> Tensor:
    if axis is not None and not cfg.global_batch_mmd:
        if _fused(cfg, f_fake, f_real, axis):
            local = fused_mmd2(f_fake, f_real, cfg.kernel, _kernel_params(cfg),
                               add_dot=_add_dot(cfg))
        else:
            local = mmd2(_blocks(cfg, f_fake, f_real))
        return axis.pmean(local)
    if _ring_eligible(cfg, axis):
        # the ring's pair sums see (local b, local b) blocks
        return ring_mmd2(f_fake, f_real, axis, cfg.kernel,
                         rbf_sigmas=cfg.rbf_sigmas, rq_alphas=cfg.rq_alphas,
                         use_pallas=_fused(cfg, f_fake, f_real, axis),
                         add_dot=_add_dot(cfg))
    f_fake = _gather(f_fake, axis)
    f_real = _gather(f_real, axis)
    if _fused(cfg, f_fake, f_real, axis):
        return fused_mmd2(f_fake, f_real, cfg.kernel, _kernel_params(cfg),
                          add_dot=_add_dot(cfg))
    return mmd2(_blocks(cfg, f_fake, f_real))


def _scalar_critic(features: Tensor) -> Tensor:
    """WGAN view of the critic: the sum of the feature head."""
    return torch.sum(features, dim=-1)


def _input(x: Tensor) -> Tensor:
    """``x`` as a variable to differentiate against."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def _sum_except_batch(t: Tensor) -> Tensor:
    return torch.sum(t * t, dim=tuple(range(1, t.ndim)))


# ---------------------------------------------------------------------------
# SMMD normalizer


def sobolev_scale(cfg: Config, critic: Critic, real: Tensor,
                  probe: Optional[Tensor] = None,
                  create_graph: bool = True) -> Tensor:
    """sigma = lambda + E_real ||J_phi(x)||_F^2 (+ E||phi||^2).

    ``probe``: the (dof_dim,) Rademacher vector of the hutchinson
    estimator.  ``create_graph=False`` gives a constant sigma (the
    generator step's stop-gradient)."""
    with tracing.span("losses.sigma"):
        return _sobolev_scale(cfg, critic, real, probe, create_graph)


def _sobolev_scale(cfg: Config, critic: Critic, real: Tensor, probe: Optional[Tensor],
                   create_graph: bool) -> Tensor:
    est = cfg.scaling_grad_estimator
    if est == "exact" and cfg.remat:
        # row k of every sample's Jacobian is d(sum_b f_b[k])/dx: the
        # critic has no BatchNorm, so sample b's features depend on x_b only
        x = _input(real)
        f = critic(x)
        grad_sq = 0.0
        for k in range(f.shape[-1]):
            g, = torch.autograd.grad(torch.sum(f[:, k]), x, create_graph=create_graph,
                                     retain_graph=True)
            grad_sq = grad_sq + _sum_except_batch(g)
    elif est == "exact":
        def phi_single(x: Tensor) -> Tensor:
            return critic(x[None])[0]                   # (dof_dim,)

        jac = torch.func.vmap(torch.func.jacrev(phi_single))(real)
        grad_sq = _sum_except_batch(jac)
        if not create_graph:
            grad_sq = grad_sq.detach()
    else:
        if est == "hutchinson" and probe is None:
            raise ValueError("hutchinson estimator needs a probe")
        x = _input(real)
        f = critic(x)
        out = torch.sum(f if est == "sum" else f * probe)
        grads, = torch.autograd.grad(out, x, create_graph=create_graph)
        grad_sq = _sum_except_batch(grads)
    value_sq = None
    if cfg.scaling_variant == "value_and_grad":
        feats = critic(real)
        value_sq = torch.sum(feats * feats, dim=-1)
    return smmd_scale(grad_sq, value_sq, cfg.scaling_coeff, cfg.scaling_variant)


# ---------------------------------------------------------------------------
# Gradient penalties


def _grad_norms(f: Callable[[Tensor], Tensor], x: Tensor) -> Tensor:
    """Per-sample L2 norms of d f_i / d x_i for a batchwise-diagonal f,
    differentiable (double backprop)."""
    x = _input(x)
    grads, = torch.autograd.grad(torch.sum(f(x)), x, create_graph=True)
    return torch.sqrt(_sum_except_batch(grads) + 1e-12)


def _penalize(norms: Tensor, variant: str) -> Tensor:
    if variant == "one_sided":
        return torch.mean(torch.square(torch.clamp_min(norms - 1.0, 0.0)))
    return torch.mean(torch.square(norms - 1.0))


def _interpolates(real: Tensor, fake: Tensor, eps: Tensor) -> Tensor:
    b = min(real.shape[0], fake.shape[0])
    if eps is None:
        raise ValueError("the gradient penalty needs eps")
    return eps * real[:b] + (1.0 - eps) * fake[:b]


def witness_gradient_penalty(cfg: Config, critic: Critic, real: Tensor,
                             fake: Tensor, f_real: Tensor, f_fake: Tensor,
                             eps: Tensor) -> Tensor:
    """MMD-witness analog of WGAN-GP at x' = eps*real + (1-eps)*fake;
    ``eps`` is (b, 1, 1, 1)."""
    xhat = _interpolates(real, fake, eps)
    if cfg.gp_detach_sets:
        f_real, f_fake = f_real.detach(), f_fake.detach()
    kw = dict(rbf_sigmas=cfg.rbf_sigmas, rq_alphas=cfg.rq_alphas,
              add_dot=cfg.kernel_add_dot)

    def witness(x: Tensor) -> Tensor:
        fx = critic(x)
        k_fake = kernel_cross(cfg.kernel, fx, f_fake, **kw)
        k_real = kernel_cross(cfg.kernel, fx, f_real, **kw)
        return torch.mean(k_fake, dim=1) - torch.mean(k_real, dim=1)

    return _penalize(_grad_norms(witness, xhat), cfg.gp_variant)


def wgan_gradient_penalty(cfg: Config, critic: Critic, real: Tensor,
                          fake: Tensor, eps: Tensor) -> Tensor:
    xhat = _interpolates(real, fake, eps)
    norms = _grad_norms(lambda x: _scalar_critic(critic(x)), xhat)
    return _penalize(norms, cfg.gp_variant)


# ---------------------------------------------------------------------------
# Critic / generator losses


def _zero(like: Tensor, value: float = 0.0) -> Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def critic_loss(cfg: Config, critic: Critic, real: Tensor, fake: Tensor,
                probe: Optional[Tensor] = None, eps: Optional[Tensor] = None,
                axis: Optional[DataAxis] = None,
                pairs: Optional[Tuple[Tensor, Tensor]] = None
                ) -> Tuple[Tensor, LossAux]:
    """The critic-step objective (minimized).  With ``axis``, ``real`` and
    ``fake`` are this rank's blocks and the loss is the global one.
    ``pairs``: the (real, fake) rows the penalty interpolates with
    ``eps``, by default ``real`` and ``fake`` themselves."""
    f_real, f_fake = _critic_features(cfg, critic, real, fake)
    gp_real, gp_fake = (real, fake) if pairs is None else pairs

    if cfg.model == "wgan-gp":
        h_real = _pmean(torch.mean(_scalar_critic(f_real)), axis)
        h_fake = _pmean(torch.mean(_scalar_critic(f_fake)), axis)
        gp = _pmean(wgan_gradient_penalty(cfg, critic, gp_real, gp_fake, eps), axis)
        loss = h_fake - h_real + cfg.gradient_penalty * gp
        if cfg.L2_discriminator_penalty > 0:
            loss = loss + cfg.L2_discriminator_penalty * 0.5 * _pmean(
                torch.mean(f_real ** 2) + torch.mean(f_fake ** 2), axis)
        aux = LossAux(mmd2=_zero(loss), sigma=_zero(loss, 1.0), gp=gp,
                      ratio=_zero(loss), critic_real=h_real, critic_fake=h_fake)
        return loss, aux

    if cfg.model == "tmmd":
        if _ring_eligible(cfg, axis):
            # the Sutherland variance is all row sums and squared sums,
            # psum-able over row blocks: no global Gram block
            mmd2_val, objective = ring_mmd2_and_ratio(
                f_fake, f_real, axis, cfg.kernel,
                rbf_sigmas=cfg.rbf_sigmas, rq_alphas=cfg.rq_alphas,
                use_pallas=_fused(cfg, f_fake, f_real, axis),
                add_dot=_add_dot(cfg))
        else:
            # dense: the variance estimator over full (gathered) Gram blocks
            mmd2_val, objective = mmd2_and_ratio(
                _blocks(cfg, _gather(f_fake, axis), _gather(f_real, axis)))
    else:
        mmd2_val = mmd2_objective(cfg, f_fake, f_real, axis)
        objective = mmd2_val

    sigma = _zero(mmd2_val, 1.0)
    if cfg.with_scaling:
        sigma = _pmean(sobolev_scale(cfg, critic, real, probe), axis)
        objective = objective / sigma

    loss = -objective
    gp = _zero(mmd2_val)
    if cfg.gradient_penalty > 0:
        gp = _pmean(witness_gradient_penalty(
            cfg, critic, gp_real, gp_fake, _gather(f_real, axis),
            _gather(f_fake, axis), eps), axis)
        loss = loss + cfg.gradient_penalty * gp
    if cfg.L2_discriminator_penalty > 0:
        loss = loss + cfg.L2_discriminator_penalty * 0.5 * _pmean(
            torch.mean(f_real ** 2) + torch.mean(f_fake ** 2), axis)

    aux = LossAux(mmd2=mmd2_val, sigma=sigma, gp=gp, ratio=objective,
                  critic_real=_pmean(torch.mean(_scalar_critic(f_real)), axis),
                  critic_fake=_pmean(torch.mean(_scalar_critic(f_fake)), axis))
    return loss, aux


def generator_loss(cfg: Config, critic: Critic, real: Tensor, fake: Tensor,
                   scale_g_loss: bool = True, probe: Optional[Tensor] = None,
                   axis: Optional[DataAxis] = None) -> Tuple[Tensor, LossAux]:
    """The generator-step objective (minimized).  sigma, when applied, is
    a constant for the generator (stop-gradient).  The tmmd generator
    minimizes MMD^2, as in the JAX package."""
    f_real, f_fake = _critic_features(cfg, critic, real, fake)

    if cfg.model == "wgan-gp":
        h_real = _pmean(torch.mean(_scalar_critic(f_real)), axis)
        h_fake = _pmean(torch.mean(_scalar_critic(f_fake)), axis)
        aux = LossAux(mmd2=_zero(h_fake), sigma=_zero(h_fake, 1.0),
                      gp=_zero(h_fake), ratio=_zero(h_fake),
                      critic_real=h_real, critic_fake=h_fake)
        return -h_fake, aux

    mmd2_val = mmd2_objective(cfg, f_fake, f_real, axis)
    loss = mmd2_val
    sigma = _zero(mmd2_val, 1.0)
    if cfg.with_scaling and scale_g_loss:
        sigma = _pmean(sobolev_scale(cfg, critic, real, probe,
                                     create_graph=False), axis).detach()
        loss = loss / sigma
    aux = LossAux(mmd2=mmd2_val, sigma=sigma, gp=_zero(mmd2_val),
                  ratio=mmd2_val,
                  critic_real=_pmean(torch.mean(_scalar_critic(f_real)), axis),
                  critic_fake=_pmean(torch.mean(_scalar_critic(f_fake)), axis))
    return loss, aux
