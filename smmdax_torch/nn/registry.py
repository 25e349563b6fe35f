"""Architecture registry: config -> (generator, critic) modules (port of
``smmdax/nn/registry.py``, resnet arm; dcgan and mlp come later)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from smmdax_torch.configs import Config
from smmdax_torch.nn.resnet import ResNetDiscriminator, ResNetGenerator


def _dtype(cfg: Config) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def build_models(cfg: Config, generator: Optional[torch.Generator] = None
                 ) -> Tuple[nn.Module, nn.Module]:
    """Fresh (generator, critic) with initial weights drawn from
    ``generator`` (CPU modules; the caller moves them)."""
    if cfg.architecture == "mlp" or cfg.dataset == "gaussian_mix":
        raise NotImplementedError("the mlp networks are not ported yet")
    if cfg.architecture == "dcgan":
        raise NotImplementedError("the dcgan networks are not ported yet")
    if cfg.architecture != "resnet":
        raise ValueError(f"unknown architecture {cfg.architecture!r}")
    dt = _dtype(cfg)
    gen = ResNetGenerator(output_size=cfg.output_size, c_dim=cfg.c_dim,
                          gf_dim=cfg.gf_dim, z_dim=cfg.z_dim, dtype=dt,
                          generator=generator)
    disc = ResNetDiscriminator(output_size=cfg.output_size, df_dim=cfg.df_dim,
                               dof_dim=cfg.dof_dim, use_sn=cfg.with_sn,
                               sn_iters=cfg.sn_iters, c_dim=cfg.c_dim,
                               dtype=dt, generator=generator)
    return gen, disc
