"""The Scaled-MMD normalizer (port of ``smmdax/kernels/smmd.py``;
Arbel et al. 2018, arXiv:1805.11565)."""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def smmd_scale(grad_sq_norms: Tensor,
               value_sq_norms: Optional[Tensor] = None,
               scaling_coeff: float = 10.0,
               variant: str = "grad") -> Tensor:
    """sigma = lambda + mean_i ||J_phi(x_i)||_F^2 (+ mean_i ||phi(x_i)||^2)."""
    sigma = scaling_coeff + torch.mean(grad_sq_norms)
    if variant == "value_and_grad":
        if value_sq_norms is None:
            raise ValueError("value_and_grad scaling needs value_sq_norms")
        sigma = sigma + torch.mean(value_sq_norms)
    return sigma
