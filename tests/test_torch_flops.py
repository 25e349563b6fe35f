"""FLOP accounting of the port (``smmdax_torch.train.macro_step_flops``,
``sample_flops``) held to the JAX package's (``smmdax.train``) on the CPU.

The two count on different bases, so the test holds each ratio to the
value measured when the port's counter was written, within 1%: both counts
are exact and depend on shapes alone.  The port counts every convolution
tap, padding included (torch's formulas); XLA counts only the taps inside
the input.  Over mmd, the sigma term counts 41% more in the port than in
JAX: ``convolution_backward`` on all-zero gradients (the outer backward of
sigma's create-graph pass through ``threshold_backward``) accounts for
all of that but the padding.

    python tests/test_torch_flops.py

prints the counts by op class that ROADMAP.md quotes.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from smmdax.configs import Config as JaxConfig
from smmdax.train import macro_step_flops as jax_macro_step_flops
from smmdax.train import sample_flops as jax_sample_flops
from smmdax_torch.configs import Config
from smmdax_torch.train import (_FlopCounter, _op_flops, build_train_step, create_state,
                                macro_step_flops, sample_flops)

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# port / JAX, measured on torch 2.13 CPU and jax 0.9.0 (exact, shape-only)
STEP_RATIOS = {"mmd": 1.05197, "sn-smmd": 1.11088}
SAMPLE_RATIO = 1.04996
# (sigma term in the port - its zero-gradient backward) / JAX's sigma term
SIGMA_RATIO = 1.06439


def _kw(model: str, dsteps: int, **kw) -> dict:
    """tests/test_flops_oracle.py::_cfg, with the model and SN free."""
    return dict(model=model, kernel="rq", architecture="resnet",
                dataset="synthetic", output_size=32, batch_size=8,
                real_batch_size=8, gf_dim=16, df_dim=16, dof_dim=8,
                dsteps=dsteps, gsteps=1, random_seed=0,
                compute_dtype="bfloat16",
                scaling_grad_estimator="hutchinson", **kw)


def _port(model: str, dsteps: int = 1, **kw) -> float:
    return macro_step_flops(Config(**_kw(model, dsteps, **kw)), dsteps, 1, device="cpu")


_JAX = {}


def _jax(model: str, **kw) -> float:
    """JAX's count at 1d+1g, once per config in the process."""
    key = (model,) + tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = jax_macro_step_flops(JaxConfig(**_kw(model, 1, **kw)), 1, 1)
    return _JAX[key]


class _ZeroGradSplit(_FlopCounter):
    """The port's counter, with ``convolution_backward`` on an all-zero
    incoming gradient tallied apart (``zero``)."""

    def __init__(self):
        super().__init__()
        self.zero = 0

    def count(self, packet, args, kwargs, out):
        super().count(packet, args, kwargs, out)
        if packet is torch.ops.aten.convolution_backward and not bool(args[0].any()):
            self.zero += flop_registry[packet](*args, **kwargs, out_val=out)


def _by_class(model: str, cfg=None, **kw) -> _ZeroGradSplit:
    """One macro-step (1d+1g of ``_kw`` unless ``cfg`` is given) counted by
    op, as ``macro_step_flops`` runs it."""
    cfg = (cfg or Config(**_kw(model, 1, **kw))).replace(use_pallas="off")
    state = create_state(cfg, device="cpu")
    real = torch.zeros((cfg.dsteps + cfg.gsteps, cfg.real_batch_size) + cfg.image_shape,
                       dtype=torch.uint8)
    counter = _ZeroGradSplit()
    with counter:
        build_train_step(cfg, cfg.dsteps, cfg.gsteps)(state, real)
    return counter


def test_count_runs_where_flop_counter_mode_raises():
    """FlopCounterMode's module hooks break on the step's autograd.grad
    calls; the port's counter has none."""
    cfg = Config(**_kw("sn-smmd", 1))
    state = create_state(cfg, device="cpu")
    real = torch.zeros((2, 8) + cfg.image_shape, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="autograd.grad"):
        with FlopCounterMode(display=False):
            build_train_step(cfg, 1, 1)(state, real)
    assert macro_step_flops(cfg, 1, 1, device="cpu") > 0


def test_padding_basis_against_xla():
    """One 3x3 SAME convolution at 4x4 (N 8, C 16 -> 16): the port counts
    all 9 taps of every output (2 * 8*4*4 * 16*16 * 9), XLA only those
    inside the input."""
    x = torch.zeros((8, 16, 4, 4))
    w = torch.zeros((16, 16, 3, 3))
    assert _op_flops(lambda a, b: F.conv2d(a, b, padding=1), x, w) == 589_824

    def conv(a, b):
        return jax.lax.conv_general_dilated(a, b, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    ca = jax.jit(conv).lower(jnp.zeros((8, 4, 4, 16)), jnp.zeros((3, 3, 16, 16))).cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    assert float(ca["flops"]) == 409_600


@pytest.mark.parametrize("model", sorted(STEP_RATIOS))
def test_macro_step_ratio_to_jax(model):
    ratio = _port(model) / _jax(model)
    assert abs(ratio / STEP_RATIOS[model] - 1) < 0.01, ratio


def test_sigma_excess_is_zero_gradient_backward():
    """The sigma term (sn-smmd over mmd + SN) counts 41% more in the port
    than in JAX.  Without the convolution backward on all-zero gradients,
    which only the sigma term runs, it is JAX's times the padding."""
    counts = {m: _by_class(m, **kw) for m, kw in
              (("mmd", dict(with_sn=True)), ("sn-smmd", {}))}
    assert counts["mmd"].zero == 0 < counts["sn-smmd"].zero
    port_sigma = sum(counts["sn-smmd"].by_op.values()) - sum(counts["mmd"].by_op.values())
    jax_sigma = _jax("sn-smmd") - _jax("mmd", with_sn=True)
    assert 1.35 < port_sigma / jax_sigma < 1.45
    ratio = (port_sigma - counts["sn-smmd"].zero) / jax_sigma
    assert abs(ratio / SIGMA_RATIO - 1) < 0.01, ratio


def test_more_critic_updates_count_more():
    ratio = _port("sn-smmd", 5) / _port("sn-smmd", 1)
    assert 2.0 < ratio < 5.0, ratio


def test_count_scales_with_batch():
    f8 = _port("sn-smmd", 2)
    f16 = macro_step_flops(Config(**_kw("sn-smmd", 2)).replace(batch_size=16, real_batch_size=16),
                           2, 1, device="cpu")
    assert 1.6 < f16 / f8 < 2.4


def test_count_charges_remat_recompute():
    ratio = _port("sn-smmd", 2, remat=True) / _port("sn-smmd", 2)
    assert ratio > 1.05, ratio


def test_count_takes_the_dense_path():
    """The fused ops match no formula; the count runs the dense path
    whatever ``use_pallas`` says."""
    assert _port("sn-smmd", use_pallas="auto") == _port("sn-smmd", use_pallas="off")


def test_sample_flops_chunks_and_ratio_to_jax():
    kw = _kw("sn-smmd", 1)
    one = sample_flops(Config(**kw), 8, device="cpu")
    assert sample_flops(Config(**kw), 20, device="cpu") == 3 * one
    ratio = sample_flops(Config(**kw), 20, device="cpu") / jax_sample_flops(JaxConfig(**kw), 20)
    assert abs(ratio / SAMPLE_RATIO - 1) < 0.01, ratio


if __name__ == "__main__":
    rows = {"mmd": {}, "mmd + SN": dict(with_sn=True), "smmd": {}, "sn-smmd": {}}
    port = {}
    for name, kw in rows.items():
        c = _by_class(name.split()[0], **kw)
        port[name] = sum(c.by_op.values())
        jax_n = _jax(name.split()[0], **kw)
        print(f"{name:9s} port {port[name]:.4e} JAX {jax_n:.4e} ratio {port[name] / jax_n:.5f}; "
              + ", ".join(f"{k} {v:.4e}" for k, v in sorted(c.by_op.items()))
              + f"; convolution_backward on zero gradients {c.zero:.4e}")
    for a, b in (("smmd", "mmd"), ("sn-smmd", "mmd + SN")):
        jax_d = _jax(a) - _jax(b.split()[0], **rows[b])
        print(f"{a} - {b}: port {port[a] - port[b]:.4e}, JAX {jax_d:.4e}, "
              f"ratio {(port[a] - port[b]) / jax_d:.4f}")
    from smmdax_torch.bench import _flagship_cfg
    c = _by_class("sn-smmd", cfg=_flagship_cfg())
    total = sum(c.by_op.values())
    print(f"flagship (bench, 5d+1g, B 64): port {total:.6e}; convolution_backward on zero "
          f"gradients {c.zero:.4e} ({100 * c.zero / total:.2f}%)")
