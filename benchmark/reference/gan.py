"""Plain reference of the Scaled-MMD GAN training macro-step.

Functional PyTorch, written from the model's equations (Arbel et al. 2018,
arXiv:1805.11565) in the layout the port documents: parameters and
buffers in one flat dict keyed by the port's state-dict names, NHWC
images outside the networks.  It imports nothing of the program and takes
nothing the program made: the initial weights are drawn again from the
seed by the configuration's architecture (``arch/<architecture>.py``),
the step's noise from a device generator seeded with seed + 1, and the
real batches from the dataset with ``default_rng((seed, step))``.

The networks are the architecture's file, found by the configuration's
``"architecture"`` (``arch/__init__.py`` states what such a file
defines); ``init_weights``, ``generator`` and ``critic`` here only look
it up.  The step is this file's, and it implements one objective: the
``sn-smmd`` ratio of the rq mixture's unbiased MMD^2 to the Hutchinson
sigma (``OBJECTIVE``).  ``macro_step`` refuses a configuration that asks
for any other, rather than hold it to this one.

``cast`` is applied to both operands of every convolution and dense
product that the configuration runs in its compute dtype: the identity
cast to bfloat16 for the reference, a coarser one for the control
(``layers.py``).
"""

from __future__ import annotations

import importlib
import os
import re
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .layers import Cast, Params, Tensor, is_buffer, to_bf16, to_fp8_scaled  # noqa: F401

ADAM_EPS = 1e-8

# what ``macro_step`` computes: each key's value, or the port's default
# where a configuration file leaves the key out
OBJECTIVE = {"model": ("sn-smmd", "mmd"), "kernel": ("rq", "rq"),
             "scaling_grad_estimator": ("hutchinson", "exact"),
             "scaling_variant": ("grad", "grad"), "gradient_penalty": (0, 0),
             "L2_discriminator_penalty": (0, 0), "kernel_add_dot": (0, 0)}

ARCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "arch")


# ---------------------------------------------------------------------------
# the networks, by architecture


def arch(c: dict) -> ModuleType:
    """``arch/<c["architecture"]>.py``, the configuration's networks."""
    name = c["architecture"]
    path = os.path.join(ARCH_DIR, f"{name}.py")
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", name) or not os.path.isfile(path):
        raise ValueError(f"architecture {name!r} has no plain reference networks: "
                         f"no file benchmark/reference/arch/{name}.py")
    return importlib.import_module(f"{__package__}.arch.{name}")


def init_weights(c: dict, seed: int) -> Tuple[Params, Params]:
    """(generator, critic) initial weights and buffers, from the seed."""
    return arch(c).init_weights(c, seed)


def generator(c: dict, p: Params, z: Tensor, train: bool, cast: Optional[Cast],
              update: Optional[Params] = None) -> Tensor:
    """z (B, z_dim) -> images (B, H, W, C) float32 in [-1, 1]."""
    return arch(c).generator(c, p, z, train, cast, update)


def critic(c: dict, p: Params, x: Tensor, cast: Optional[Cast],
           new_u: Optional[Params] = None) -> Tensor:
    """images (B, H, W, C) -> features (B, dof_dim) float32."""
    return arch(c).critic(c, p, x, cast, new_u)


def check_objective(c: dict) -> None:
    """Refuse a configuration whose objective is not ``OBJECTIVE``'s."""
    for key, (want, default) in OBJECTIVE.items():
        got = c.get(key, default)
        if got != want:
            raise ValueError(f"the reference step implements {key} {want!r}, and the "
                             f"configuration asks for {got!r}")


# ---------------------------------------------------------------------------
# losses


def rq_gram(x: Tensor, y: Tensor, alphas) -> Tensor:
    """sum_a (1 + ||x_i - y_j||^2 / (2a))^-a, float32."""
    d2 = torch.clamp_min((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
                         - 2.0 * (x @ y.T), 0.0)
    k = torch.zeros_like(d2)
    for a in alphas:
        k = k + torch.exp(-a * torch.log1p(d2 / (2.0 * a)))
    return k


def mmd2_unbiased(fx: Tensor, fy: Tensor, alphas) -> Tensor:
    """Unbiased MMD^2 of the rq mixture between fakes ``fx`` and reals ``fy``."""
    m, n = fx.shape[0], fy.shape[0]
    diag = float(len(alphas))
    sxx = rq_gram(fx, fx, alphas).sum() - m * diag
    syy = rq_gram(fy, fy, alphas).sum() - n * diag
    sxy = rq_gram(fx, fy, alphas).sum()
    return sxx / (m * (m - 1.0)) + syy / (n * (n - 1.0)) - 2.0 * sxy / (m * n)


def sigma_hutchinson(c: dict, dp: Params, real: Tensor, probe: Tensor,
                     cast: Optional[Cast], create_graph: bool) -> Tensor:
    """lambda + mean_i ||d <phi(x_i), probe> / d x_i||^2."""
    x = real.detach().requires_grad_(True)
    f = critic(c, dp, x, cast)
    g, = torch.autograd.grad(torch.sum(f * probe), x, create_graph=create_graph)
    return c["scaling_coeff"] + torch.mean(torch.sum(g * g, dim=(1, 2, 3)))


# ---------------------------------------------------------------------------
# the macro-step


class State:
    """Weights, Adam moments, EMA shadows and the noise stream."""

    def __init__(self, c: dict, seed: int, device):
        gp, dp = init_weights(c, seed)
        self.gen = {k: v.to(device) for k, v in gp.items()}
        self.disc = {k: v.to(device) for k, v in dp.items()}
        self.adam = {"gen": self._moments(self.gen), "disc": self._moments(self.disc)}
        self.count = {"gen": 0, "disc": 0}
        self.ema = ({k: v.clone() for k, v in self.gen.items()}
                    if c.get("ema_decay", 0.0) > 0 else None)
        self.device = torch.device(device)
        # a meta state (FLOP counting) draws without a generator
        self.noise = (None if self.device.type == "meta" else
                      torch.Generator(device=device).manual_seed(seed + 1))

    @staticmethod
    def _moments(p: Params):
        return ({k: torch.zeros_like(v) for k, v in p.items() if not is_buffer(k)},
                {k: torch.zeros_like(v) for k, v in p.items() if not is_buffer(k)})


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def adam(c: dict, st: State, which: str, grads: Params) -> None:
    p = st.gen if which == "gen" else st.disc
    mu, nu = st.adam[which]
    st.count[which] += 1
    b1, b2, lr = c["beta1"], c["beta2"], c["learning_rate"]
    bc1 = _bias_correction(b1, st.count[which])
    bc2 = _bias_correction(b2, st.count[which])
    with torch.no_grad():
        for k, g in grads.items():
            mu[k].mul_(b1).add_(g * (1.0 - b1))
            nu[k].mul_(b2).add_(g * g * (1.0 - b2))
            den = torch.sqrt(nu[k] / bc2) + ADAM_EPS
            p[k].add_((mu[k] / bc1) / den * (-lr))


def draw_noise(c: dict, st: State, dsteps: int, gsteps: int) -> Dict[str, Tensor]:
    """One macro-step's draws, in the port's documented order."""
    g, dev, b = st.noise, st.device, c["batch_size"]

    def uniform(shape):
        return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0

    def rademacher(shape):
        return torch.randint(0, 2, shape, generator=g, device=dev).float() * 2.0 - 1.0

    return {"d_z": uniform((dsteps, b, c["z_dim"])), "g_z": uniform((gsteps, b, c["z_dim"])),
            "d_probe": rademacher((dsteps, c["dof_dim"])),
            "g_probe": rademacher((gsteps, c["dof_dim"]))}


def _trainable(p: Params) -> List[str]:
    return [k for k in p if not is_buffer(k)]


def macro_step(c: dict, st: State, real_u8: Tensor, dsteps: int, gsteps: int,
               cast: Optional[Cast], rows: Optional[int] = None) -> Dict[str, Tensor]:
    """``dsteps`` critic updates, then ``gsteps`` generator updates with
    the EMA; returns the last updates' losses as 0-d tensors.  ``rows``:
    only the first ``rows`` of every real and fake batch take part (a
    planted fault: half of the batch left out)."""
    check_objective(c)
    alphas = c["rq_alphas"]
    real = (real_u8.to(st.device).float() - 127.5) / 127.5
    noise = draw_noise(c, st, dsteps, gsteps)
    if rows is not None:
        real = real[:, :rows]
        noise = {k: (v[:, :rows] if k.endswith("_z") else v) for k, v in noise.items()}
    out: Dict[str, Tensor] = {}
    for i in range(dsteps):
        with torch.no_grad():
            fake = generator(c, st.gen, noise["d_z"][i], True, cast)
            # one power-iteration step for every spectrally normalised layer
            new_u: Params = {}
            zeros = torch.zeros((1,) + tuple(real.shape[2:]), device=st.device)
            critic(c, st.disc, zeros, cast, new_u)
            st.disc.update(new_u)
        names = _trainable(st.disc)
        leaves = [st.disc[k].requires_grad_(True) for k in names]
        f_real = critic(c, st.disc, real[i], cast)
        f_fake = critic(c, st.disc, fake, cast)
        mmd2 = mmd2_unbiased(f_fake, f_real, alphas)
        sigma = sigma_hutchinson(c, st.disc, real[i], noise["d_probe"][i], cast, True)
        ratio = mmd2 / sigma
        grads = torch.autograd.grad(-ratio, leaves)
        for k in names:
            st.disc[k] = st.disc[k].detach()
        adam(c, st, "disc", dict(zip(names, grads)))
        out.update(d_ratio=ratio.detach(), d_mmd2=mmd2.detach(), d_sigma=sigma.detach())
    for j in range(gsteps):
        names = _trainable(st.gen)
        leaves = [st.gen[k].requires_grad_(True) for k in names]
        stats: Params = {}
        fake = generator(c, st.gen, noise["g_z"][j], True, cast, stats)
        f_real = critic(c, st.disc, real[dsteps + j], cast)
        f_fake = critic(c, st.disc, fake, cast)
        mmd2 = mmd2_unbiased(f_fake, f_real, alphas)
        sigma = sigma_hutchinson(c, st.disc, real[dsteps + j], noise["g_probe"][j], cast,
                                 False).detach()
        grads = torch.autograd.grad(mmd2 / sigma, leaves)
        for k in names:
            st.gen[k] = st.gen[k].detach()
        st.gen.update(stats)
        adam(c, st, "gen", dict(zip(names, grads)))
        if st.ema is not None:
            d = c["ema_decay"]
            with torch.no_grad():
                for k in st.ema:
                    st.ema[k] = d * st.ema[k] + (1.0 - d) * st.gen[k]
        out.update(g_loss=mmd2.detach())
    return out


def real_images(data: np.ndarray, seed: int, key: int, n: int) -> np.ndarray:
    """The ``n`` images of the set keyed ``key`` (the scoring events' real
    set) in [-1, 1], float32: rows drawn with ``default_rng((seed, key))``,
    (x - 127.5) * (1 / 127.5)."""
    idx = np.random.default_rng((seed, key)).integers(0, len(data), size=n)
    return (data[idx].astype(np.float32) - np.float32(127.5)) * (np.float32(1.0)
                                                                 / np.float32(127.5))


def real_batches(data: np.ndarray, seed: int, step: int, per_step: int,
                 batch: int) -> np.ndarray:
    """Macro-step ``step``'s (per_step, batch, H, W, C) uint8 real batch:
    rows drawn with ``default_rng((seed, step))`` from the dataset."""
    idx = np.random.default_rng((seed, step)).integers(0, len(data), size=per_step * batch)
    return data[idx].reshape((per_step, batch) + data.shape[1:])
