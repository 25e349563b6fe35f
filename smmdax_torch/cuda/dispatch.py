"""Dense-vs-fused dispatch of the MMD pair sums (port of
``smmdax/pallas/dispatch.py``).

``use_pallas`` keeps its JAX name and meaning over the CUDA kernels:
``on`` always fuses, ``off`` never does, ``auto`` is dense on the CPU
and fused on the card once ``max(m, n) >= pallas_min_rows``.  The
default threshold is 0 (always fused on the card): the JAX package's
4096 rows is a TPU crossover, and the H100's is not measured yet.
"""

from __future__ import annotations

from typing import Union

DEFAULT_MIN_ROWS = 0

_FUSED_KERNELS = ("gaussian", "rq", "distance", "dot")


def should_use_pallas(mode: Union[str, bool], kernel: str, m: int, n: int,
                      min_rows: int = DEFAULT_MIN_ROWS,
                      platform: str = "cpu") -> bool:
    """Decision for one pair-sum of an (m, n) Gram block.

    mode: "on" | "off" | "auto" (Config normalizes bools to on/off).
    platform: the device type of the features ("cpu" or "cuda")."""
    if kernel not in _FUSED_KERNELS:
        return False
    if mode in (True, "on"):
        return True
    if mode in (False, "off"):
        return False
    if mode != "auto":
        raise ValueError(f"use_pallas must be on/off/auto, got {mode!r}")
    if platform == "cpu":
        # the CPU runs the kernels' plain versions: never a win
        return False
    return max(m, n) >= min_rows
