"""On-device image transforms (port of ``smmdax/data/transforms.py``,
the part the train step uses)."""

from __future__ import annotations

import torch


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [-1, 1], exact at both endpoints."""
    return (x.float() - 127.5) / 127.5
