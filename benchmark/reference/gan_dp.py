"""Plain reference of the data-parallel SN-SMMD macro-step in the port's
shard_map mode, computed in one process.

The port runs it as one process per rank, each on its block of the
global batch (``smmdax_torch/train.py``'s module docstring and
``losses.critic_loss``).  Written out for ``ranks`` blocks from those
documented semantics and the model's equations (``gan.py``, whose layers,
weights, Adam and EMA this reuses):

* rank r draws its noise from a device generator seeded with
  ``seed + 1 + (r << 32)``, in ``gan.draw_noise``'s order, for its
  ``batch_size / ranks`` fakes (its own Rademacher probes too);
* the generator normalises each rank's fakes with that block's own
  BatchNorm statistics;
* the critic's features are taken block by block, and the MMD^2 is the
  global-batch unbiased estimator on every rank's features together (the
  full Gram, where the port rotates blocks round a ring);
* sigma is the mean over the ranks of each rank's hutchinson sigma on its
  own real block with its own probe;
* the gradient is that of the global objective, which the mean of the
  ranks' gradients is under the port's convention (a ``psum``'s backward
  is a ``psum``);
* the generator's BN running averages are each rank's update from its own
  block, averaged over the ranks; then Adam and the EMA, as on one device.

Planted faults: ``local_mmd`` takes each rank's own MMD^2 and averages
them (the port's ``global_batch_mmd=False``); ``rows`` keeps only the
first ``rows`` of every rank's real and fake block (half of the batch
left out, the means over the rest).
"""

from __future__ import annotations

import types
from typing import Dict, List, Optional, Sequence

import torch

from . import gan

Tensor = torch.Tensor


class State(gan.State):
    """``gan.State`` with one noise stream per rank
    (``c["num_data_shards"]`` of them)."""

    def __init__(self, c: dict, seed: int, device):
        super().__init__(c, seed, device)
        self.ranks = c["num_data_shards"]
        self.noises = [None if self.device.type == "meta" else
                       torch.Generator(device=device).manual_seed(seed + 1 + (r << 32))
                       for r in range(self.ranks)]


def _mmd2(f_fake: List[Tensor], f_real: List[Tensor], alphas, local: bool) -> Tensor:
    if local:
        return torch.stack([gan.mmd2_unbiased(x, y, alphas)
                            for x, y in zip(f_fake, f_real)]).mean()
    return gan.mmd2_unbiased(torch.cat(f_fake), torch.cat(f_real), alphas)


def _features(c: dict, dp, xs: Sequence[Tensor], cast) -> List[Tensor]:
    return [gan.critic(c, dp, x, cast) for x in xs]


def _sigma(c: dict, dp, reals: Sequence[Tensor], probes: Sequence[Tensor], cast,
           create_graph: bool) -> Tensor:
    return torch.stack([gan.sigma_hutchinson(c, dp, x, p, cast, create_graph)
                        for x, p in zip(reals, probes)]).mean()


def macro_step(c: dict, st: State, real_u8: Tensor, dsteps: int, gsteps: int,
               cast, local_mmd: bool = False, rows: Optional[int] = None
               ) -> Dict[str, Tensor]:
    """``dsteps`` critic updates, then ``gsteps`` generator updates with
    the EMA, over ``st.ranks`` blocks of the GLOBAL ``real_u8`` (per_step,
    B, H, W, C); returns the last updates' losses as 0-d tensors."""
    gan.check_objective(c)
    n, alphas = st.ranks, c["rq_alphas"]
    real = (real_u8.to(st.device).float() - 127.5) / 127.5
    b = real.shape[1] // n
    reals = [real[:, r * b:(r + 1) * b][:, :rows] for r in range(n)]
    per_rank = {**c, "batch_size": c["batch_size"] // n}
    noises = [gan.draw_noise(per_rank, types.SimpleNamespace(noise=g, device=st.device),
                             dsteps, gsteps) for g in st.noises]
    noises = [{k: (v[:, :rows] if k.endswith("_z") else v) for k, v in z.items()}
              for z in noises]
    out: Dict[str, Tensor] = {}
    for i in range(dsteps):
        with torch.no_grad():
            fakes = [gan.generator(c, st.gen, z["d_z"][i], True, cast) for z in noises]
            new_u: gan.Params = {}
            zeros = torch.zeros((1,) + tuple(real.shape[2:]), device=st.device)
            gan.critic(c, st.disc, zeros, cast, new_u)
            st.disc.update(new_u)
        names = gan._trainable(st.disc)
        leaves = [st.disc[k].requires_grad_(True) for k in names]
        xs = [x[i] for x in reals]
        mmd2 = _mmd2(_features(c, st.disc, fakes, cast), _features(c, st.disc, xs, cast),
                     alphas, local_mmd)
        sigma = _sigma(c, st.disc, xs, [z["d_probe"][i] for z in noises], cast, True)
        ratio = mmd2 / sigma
        grads = torch.autograd.grad(-ratio, leaves)
        for k in names:
            st.disc[k] = st.disc[k].detach()
        gan.adam(c, st, "disc", dict(zip(names, grads)))
        out.update(d_ratio=ratio.detach(), d_mmd2=mmd2.detach(), d_sigma=sigma.detach())
    for j in range(gsteps):
        names = gan._trainable(st.gen)
        leaves = [st.gen[k].requires_grad_(True) for k in names]
        stats: List[gan.Params] = [{} for _ in range(n)]
        fakes = [gan.generator(c, st.gen, z["g_z"][j], True, cast, s)
                 for z, s in zip(noises, stats)]
        xs = [x[dsteps + j] for x in reals]
        mmd2 = _mmd2(_features(c, st.disc, fakes, cast), _features(c, st.disc, xs, cast),
                     alphas, local_mmd)
        sigma = _sigma(c, st.disc, xs, [z["g_probe"][j] for z in noises], cast,
                       False).detach()
        grads = torch.autograd.grad(mmd2 / sigma, leaves)
        for k in names:
            st.gen[k] = st.gen[k].detach()
        st.gen.update({k: torch.stack([s[k] for s in stats]).mean(0) for k in stats[0]})
        gan.adam(c, st, "gen", dict(zip(names, grads)))
        if st.ema is not None:
            d = c["ema_decay"]
            with torch.no_grad():
                for k in st.ema:
                    st.ema[k] = d * st.ema[k] + (1.0 - d) * st.gen[k]
        out.update(g_loss=mmd2.detach())
    return out
