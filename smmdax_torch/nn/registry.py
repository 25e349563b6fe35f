"""Architecture registry: config -> (generator, critic) modules (port of
``smmdax/nn/registry.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from smmdax_torch.configs import Config
from smmdax_torch.nn.dcgan import DCGANDiscriminator, DCGANGenerator
from smmdax_torch.nn.mlp import MLPDiscriminator, MLPGenerator
from smmdax_torch.nn.resnet import ResNetDiscriminator, ResNetGenerator


def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def build_models(cfg: Config, generator: Optional[torch.Generator] = None
                 ) -> Tuple[nn.Module, nn.Module]:
    """Fresh (generator, critic) with initial weights drawn from
    ``generator`` (CPU modules; the caller moves them).  The MLP pair
    whenever the dataset is the gaussian_mix toy, as in the JAX package."""
    if cfg.architecture == "mlp" or cfg.dataset == "gaussian_mix":
        gen = MLPGenerator(out_dim=cfg.toy_dim, z_dim=cfg.z_dim, generator=generator)
        disc = MLPDiscriminator(in_dim=cfg.toy_dim, dof_dim=cfg.dof_dim,
                                use_sn=cfg.with_sn, sn_iters=cfg.sn_iters,
                                generator=generator)
        return gen, disc
    if cfg.architecture == "dcgan":
        gen_cls, disc_cls = DCGANGenerator, DCGANDiscriminator
    elif cfg.architecture == "resnet":
        gen_cls, disc_cls = ResNetGenerator, ResNetDiscriminator
    else:
        raise ValueError(f"unknown architecture {cfg.architecture!r}")
    dt = _dtype(cfg)
    gen = gen_cls(output_size=cfg.output_size, c_dim=cfg.c_dim, gf_dim=cfg.gf_dim,
                  z_dim=cfg.z_dim, dtype=dt, generator=generator)
    disc = disc_cls(output_size=cfg.output_size, df_dim=cfg.df_dim, dof_dim=cfg.dof_dim,
                    use_sn=cfg.with_sn, sn_iters=cfg.sn_iters, c_dim=cfg.c_dim,
                    dtype=dt, generator=generator)
    return gen, disc
