"""Plain reference of the SN-SMMD ResNet training macro-step.

Functional PyTorch, written from the model's equations (Arbel et al. 2018,
arXiv:1805.11565; SN-GAN ResNet blocks) in the layout the port documents:
parameters and buffers in one flat dict keyed by the port's state-dict
names, NCHW inside the networks, NHWC images outside.  It imports nothing
of the program and takes nothing the program made: the initial weights are
drawn again from the seed in the port's documented order (flax's
``glorot_uniform`` on a CPU ``torch.Generator`` seeded with the seed,
generator first, then the critic, each spectral-norm ``u`` after its
kernel), the step's noise from a device generator seeded with seed + 1,
and the real batches from the dataset with ``default_rng((seed, step))``.

``cast`` is applied to both operands of every convolution and dense
product that the configuration runs in its compute dtype: the identity
cast to bfloat16 for the reference, a coarser one for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]
Cast = Callable[[Tensor], Tensor]

ADAM_EPS = 1e-8
BN_MOMENTUM = 0.99
BN_EPS = 1e-5
SN_EPS = 1e-12


def to_bf16(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16)


def _fp8(t: Tensor, dtype: torch.dtype, top: float) -> Tensor:
    """``t`` rounded to the float8 ``dtype`` with one scale per tensor
    (its largest magnitude to ``top``), back in float32."""
    t32 = t.float()
    scale = torch.clamp_min(t32.abs().amax(), 1e-30) / top
    return (t32 / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """The operand of an fp8 product: float8 e4m3 forward, and its
    gradient in float8 e5m2, each scaled per tensor (the usual fp8
    training recipe); held in bfloat16."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0).to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0).to(g.dtype)


def to_fp8_scaled(t: Tensor) -> Tensor:
    """What an fp8 convolution or product would multiply (the control)."""
    return _Fp8.apply(t)


def base_and_blocks(output_size: int) -> Tuple[int, int]:
    """(base grid, number of 2x resamplings): output_size = base * 2^k."""
    for base in (4, 5, 3, 6, 7):
        n = output_size / base
        k = int(round(math.log2(n))) if n > 1 else 0
        if base * (2 ** k) == output_size and k >= 1:
            return base, k
    raise ValueError(f"output_size {output_size} not reachable from a 3..7 base grid")


def gen_widths(gf_dim: int, n_up: int) -> List[int]:
    if n_up <= 3:
        return [4 * gf_dim] * n_up
    return [gf_dim * (2 ** (n_up - 1 - i)) for i in range(n_up)]


def disc_blocks(df_dim: int, c_dim: int, n_down: int) -> List[Tuple[int, int, bool, bool]]:
    """(in, out, downsample, first) of every critic block."""
    if n_down <= 3:
        w = 2 * df_dim
        return [(c_dim, w, True, True), (w, w, True, False),
                (w, w, False, False), (w, w, False, False)]
    out, cin = [], c_dim
    for i in range(n_down):
        w = df_dim * (2 ** i)
        out.append((cin, w, True, i == 0))
        cin = w
    return out


# ---------------------------------------------------------------------------
# initial weights


def _glorot(shape, fan_in: int, fan_out: int, g: torch.Generator) -> Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=g)


def _l2n(v: Tensor) -> Tensor:
    return v * torch.rsqrt(torch.sum(v * v) + SN_EPS)


def init_weights(c: dict, seed: int) -> Tuple[Params, Params]:
    """(generator, critic) weights and buffers for config ``c``, drawn on
    the CPU from ``seed`` in the order described in the module docstring."""
    g = torch.Generator().manual_seed(seed)
    base, n = base_and_blocks(c["output_size"])
    gp: Params = {}
    widths = gen_widths(c["gf_dim"], n)
    gp["project.weight"] = _glorot((base * base * widths[0], c["z_dim"]), c["z_dim"],
                                   base * base * widths[0], g)
    gp["project.bias"] = torch.zeros(base * base * widths[0])

    def bn(p: Params, name: str, ch: int) -> None:
        p[f"{name}.scale"] = torch.ones(ch)
        p[f"{name}.bias"] = torch.zeros(ch)
        p[f"{name}.mean"] = torch.zeros(ch)
        p[f"{name}.var"] = torch.ones(ch)

    def conv(p: Params, name: str, cin: int, cout: int, k: int, sn: bool) -> None:
        p[f"{name}.weight"] = _glorot((cout, cin, k, k), cin * k * k, cout * k * k, g)
        p[f"{name}.bias"] = torch.zeros(cout)
        if sn:
            p[f"{name}.u"] = _l2n(torch.randn(cout, generator=g))

    cin = widths[0]
    for i, w in enumerate(widths):
        bn(gp, f"block{i}.bn1", cin)
        conv(gp, f"block{i}.conv1", cin, w, 3, False)
        bn(gp, f"block{i}.bn2", w)
        conv(gp, f"block{i}.conv2", w, w, 3, False)
        if cin != w:
            conv(gp, f"block{i}.conv_sc", cin, w, 1, False)
        cin = w
    bn(gp, "bn_out", cin)
    conv(gp, "conv_out", cin, c["c_dim"], 3, False)

    dp: Params = {}
    sn = c["model"] == "sn-smmd"
    for i, (ci, co, _, first) in enumerate(disc_blocks(c["df_dim"], c["c_dim"], n)):
        conv(dp, f"block{i}.conv1", ci, co, 3, sn)
        conv(dp, f"block{i}.conv2", co, co, 3, sn)
        if first or ci != co:
            conv(dp, f"block{i}.conv_sc", ci, co, 1, sn)
        cin = co
    dp["head.weight"] = _glorot((c["dof_dim"], cin), cin, c["dof_dim"], g)
    dp["head.bias"] = torch.zeros(c["dof_dim"])
    if sn:
        dp["head.u"] = _l2n(torch.randn(c["dof_dim"], generator=g))
    return gp, dp


BUFFER_SUFFIXES = (".mean", ".var", ".u")


def is_buffer(name: str) -> bool:
    return name.endswith(BUFFER_SUFFIXES)


# ---------------------------------------------------------------------------
# layers


def _same_pad(k: int, size: int) -> int:
    total = max((size - 1) + k - size, 0)
    return total // 2


def sn_weight(p: Params, name: str, iters: int, new_u: Optional[Params]) -> Tensor:
    """The kernel divided by its top singular value, from ``iters`` power
    iterations on the stored ``u`` (u, v held constant in the gradient);
    ``new_u`` receives the iterated ``u``."""
    w = p[f"{name}.weight"]
    u = p[f"{name}.u"]
    w_mat = w.reshape(w.shape[0], -1).T
    with torch.no_grad():
        for _ in range(iters):
            v = _l2n(w_mat @ u)
            u = _l2n(w_mat.T @ v)
        v = _l2n(w_mat @ u)
    if new_u is not None:
        new_u[f"{name}.u"] = u
    return w / (v @ (w_mat @ u))


def conv(p: Params, name: str, x: Tensor, cast: Optional[Cast], sn_iters: int = 0,
         new_u: Optional[Params] = None) -> Tensor:
    w = sn_weight(p, name, sn_iters, new_u) if sn_iters else p[f"{name}.weight"]
    b = p[f"{name}.bias"]
    if cast is not None:
        x, w, b = cast(x), cast(w), b.to(torch.bfloat16)
    k = w.shape[-1]
    pad = [_same_pad(k, s) for s in x.shape[2:]]
    return F.conv2d(x, w, padding=pad) + b[:, None, None]


def batch_norm(p: Params, name: str, x: Tensor, train: bool, update: Optional[Params],
               low: bool) -> Tensor:
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if update is not None:
            with torch.no_grad():
                update[f"{name}.mean"] = (BN_MOMENTUM * p[f"{name}.mean"]
                                          + (1 - BN_MOMENTUM) * mean)
                update[f"{name}.var"] = (BN_MOMENTUM * p[f"{name}.var"]
                                         + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    mul = torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"]
    y = (xf - mean[:, None, None]) * mul[:, None, None] + p[f"{name}.bias"][:, None, None]
    return y.to(torch.bfloat16) if low else y


def _up(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def generator(c: dict, p: Params, z: Tensor, train: bool, cast: Optional[Cast],
              update: Optional[Params] = None) -> Tensor:
    """z (B, z_dim) -> images (B, H, W, C) float32 in [-1, 1]; ``update``
    receives the new BN running averages."""
    base, n = base_and_blocks(c["output_size"])
    widths = gen_widths(c["gf_dim"], n)
    low = cast is not None
    w, b = p["project.weight"], p["project.bias"]
    if low:
        z, w, b = cast(z), cast(w), b.to(torch.bfloat16)
    x = (z @ w.T + b).reshape(-1, base, base, widths[0]).permute(0, 3, 1, 2)
    cin = widths[0]
    for i, wd in enumerate(widths):
        h = torch.relu(batch_norm(p, f"block{i}.bn1", x, train, update, low))
        h = conv(p, f"block{i}.conv1", _up(h), cast)
        h = torch.relu(batch_norm(p, f"block{i}.bn2", h, train, update, low))
        h = conv(p, f"block{i}.conv2", h, cast)
        sc = _up(x)
        if cin != wd:
            sc = conv(p, f"block{i}.conv_sc", sc, cast)
        x = h + sc
        cin = wd
    x = torch.relu(batch_norm(p, "bn_out", x, train, update, low))
    x = conv(p, "conv_out", x, cast)
    return torch.tanh(x.float()).permute(0, 2, 3, 1)


def critic(c: dict, p: Params, x: Tensor, cast: Optional[Cast],
           new_u: Optional[Params] = None) -> Tensor:
    """images (B, H, W, C) -> features (B, dof_dim) float32."""
    _, n = base_and_blocks(c["output_size"])
    it = c.get("sn_iters", 1) if c["model"] == "sn-smmd" else 0
    x = x.permute(0, 3, 1, 2)
    for i, (ci, co, down, first) in enumerate(disc_blocks(c["df_dim"], c["c_dim"], n)):
        h = x if first else torch.relu(x)
        h = conv(p, f"block{i}.conv1", h, cast, it, new_u)
        h = conv(p, f"block{i}.conv2", torch.relu(h), cast, it, new_u)
        if down:
            h = F.avg_pool2d(h, 2, 2)
        sc = x
        if first:
            if down:
                sc = F.avg_pool2d(sc, 2, 2)
            sc = conv(p, f"block{i}.conv_sc", sc, cast, it, new_u)
        else:
            if ci != co:
                sc = conv(p, f"block{i}.conv_sc", sc, cast, it, new_u)
            if down:
                sc = F.avg_pool2d(sc, 2, 2)
        x = h + sc
    x = torch.sum(torch.relu(x).float(), dim=(2, 3))
    w = sn_weight(p, "head", it, new_u) if it else p["head.weight"]
    return x @ w.T + p["head.bias"]


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
