"""The yardsticks of work: FLOP counts of the plain reference, and the
least time of the MMD pair sums on the card.

FLOPs are counted once by ``torch.utils.flop_counter.FlopCounterMode``
over the reference (``benchmark/reference``) in float32 on meta tensors
and frozen in each configuration's file, so a later change to the
program's kernels cannot move them.  Basis: 2 FLOPs per multiply-add of
every convolution (padding taps included) and matrix product, forward and
backward, as the counter's formulas give them; elementwise work is not
counted.  ``python3 -m benchmark.flops <config>`` prints the counts.

``bound_ms`` and ``mixture_ops`` are a frozen copy of ``chip_smoke.py``'s:
the least time of one pair-sum kernel call, max(bytes / HBM rate, float32
operations / FP32 rate), from its shapes alone.
"""

from __future__ import annotations

import sys
from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def macro_step_flops(c: dict) -> float:
    """One macro-step of ``c``'s dsteps + gsteps updates."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import gan
    st = gan.State(c, 0, "meta")
    per_step = c["dsteps"] + c["gsteps"]
    real = torch.zeros((per_step, c["real_batch_size"], c["output_size"], c["output_size"],
                        c["c_dim"]), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as fc:
        gan.macro_step(c, st, real, c["dsteps"], c["gsteps"], None)
    return float(fc.get_total_flops())


def sample_flops_per_image(c: dict) -> float:
    """One eval-mode generator image (a batch of ``batch_size``, divided)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import gan
    gp, _ = gan.init_weights(c, 0)
    gp = {k: v.to("meta") for k, v in gp.items()}
    z = torch.zeros((c["batch_size"], c["z_dim"]), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        gan.generator(c, gp, z, False, None)
    return float(fc.get_total_flops()) / c["batch_size"]


def inception_flops_per_image() -> float:
    """One 299 x 299 Inception-v3 forward to pool3 and the logits."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import inception
    params = inception.meta_params()
    x = torch.zeros((1, 299, 299, 3), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        inception.forward(params, x)
    return float(fc.get_total_flops())


def mixture_ops(kernel: str, params, add_dot: float) -> tuple:
    """float32 operations per pair of the mixture value and its g, each
    exp/log1p/sqrt counted as one."""
    if kernel == "gaussian":
        return 3 * len(params), 4 * len(params)
    if kernel == "rq":
        return 5 * len(params) + (2 if add_dot else 0), 6 * len(params)
    return 3, 3                                          # distance


def bound_ms(kind: str, m: int, n: int, d: int, exclude_diag: bool,
             kernel: str, params, add_dot: float = 0.0) -> float:
    """Least ms of one call: ``fwd`` (pair_sum), ``bwd`` (the gradient in
    a only) or ``bwd2`` (a and b from one sweep)."""
    pairs = m * n - (min(m, n) if exclude_diag else 0)
    k_ops, g_ops = mixture_ops(kernel, params, add_dot)
    in_bytes = 4 * (m + n) * d
    if kind == "fwd":
        ops = pairs * (2 * d + 4 + k_ops)
        out_bytes = 4
    elif kind == "bwd":
        ops = pairs * (2 * d + 4 + g_ops + 2 * d + 2) + 3 * m * d
        out_bytes = 4 * m * d
    elif kind == "bwd2":
        ops = pairs * (2 * d + 4 + g_ops + 4 * d + 3) + 3 * (m + n) * d
        in_bytes += 4
        out_bytes = 4 * (m + n) * d
    else:
        raise ValueError(kind)
    return max((in_bytes + out_bytes) / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def mmd2_bound_ms(rows: int, dof: int, kernel: str, params) -> float:
    """The unbiased MMD^2 of two (rows, dof) sets, forward and the
    gradients in both: three pair sums (two without their diagonal), the
    two self blocks' gradients and one sweep of the cross block's."""
    fwd = (2 * bound_ms("fwd", rows, rows, dof, True, kernel, params)
           + bound_ms("fwd", rows, rows, dof, False, kernel, params))
    bwd = (2 * bound_ms("bwd", rows, rows, dof, True, kernel, params)
           + bound_ms("bwd2", rows, rows, dof, False, kernel, params))
    return fwd + bwd


def counts(c: dict) -> Dict[str, float]:
    out = {"flops_per_macro_step": macro_step_flops(c)}
    if "no_of_samples" in c:
        out["sample_flops_per_image"] = sample_flops_per_image(c)
        out["inception_flops_per_image"] = inception_flops_per_image()
    return out


if __name__ == "__main__":
    from benchmark.common import load_config
    for name in sys.argv[1:]:
        print(name, counts(load_config(name)))
