"""The port's loss gradients against ``smmdax.losses`` in float64, leaf
by leaf: the semantics with no float32 rounding in the way.

Both packages run their dense path on copies of the same converted
weights in float64; the JAX side through ``_torch_parity.jax_float64``.
Under x64 JAX draws other probes and eps from the same key, so both are
drawn there and handed to the port.  Each parameter leaf is held at rtol
1e-6 of its own largest entry (``check_grads_per_leaf``); measured, the
two lie about 2e-13 of it apart."""

import copy

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (check_grads_per_leaf, configs, jax_float64,
                           jax_state, port_state, to_float64)
from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)
from smmdax import losses as jlosses
from smmdax.nn import build_models as jax_build
from smmdax_torch import convert
from smmdax_torch import losses as tlosses
from test_torch_losses import (CASES, draws, inputs, port_generator_loss,
                               port_grads)

# "mmd-fused" is "mmd" on the dense path, where float64 runs
CASES64 = [c for c in CASES if c != "mmd-fused"]


@pytest.mark.parametrize("case", CASES64)
def test_critic_grads_float64_match(case):
    jcfg, tcfg = configs(**CASES[case])
    jcfg = jcfg.replace(use_pallas="off")
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    real, _, fake = inputs(jcfg, js)
    key = jax.random.PRNGKey(7)
    _, disc = jax_build(jcfg)
    with jax_float64():
        spectral = to_float64(js.d_spectral)
        real64, fake64 = to_float64(real), to_float64(fake)

        @jax.jit
        def jloss(d_params):
            critic = lambda x: disc.apply({"params": d_params, "spectral": spectral}, x)
            return jlosses.critic_loss(jcfg, critic, real64, fake64, key)[0]

        want = convert.flatten(jax.grad(jloss)(to_float64(js.d_params)))
        probe, eps = draws(jcfg, key, critic_side=True)
    disc64 = copy.deepcopy(ts.disc).double()
    val, _ = tlosses.critic_loss(
        tcfg.replace(use_pallas="off"), disc64, torch.from_numpy(real).double(),
        torch.from_numpy(fake).double(), probe=probe, eps=eps)
    check_grads_per_leaf(want, port_grads(val, disc64))


@pytest.mark.parametrize("case", ["mmd", "smmd-hutchinson", "sn-smmd", "wgan-gp"])
def test_generator_grads_float64_match(case):
    jcfg, tcfg = configs(**CASES[case])
    jcfg = jcfg.replace(use_pallas="off")
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    real, z, _ = inputs(jcfg, js)
    key = jax.random.PRNGKey(8)
    gen, disc = jax_build(jcfg)
    with jax_float64():
        g_stats, z64, real64 = to_float64(js.g_batch_stats), to_float64(z), to_float64(real)
        d_params, spectral = to_float64(js.d_params), to_float64(js.d_spectral)
        critic = lambda x: disc.apply({"params": d_params, "spectral": spectral}, x)

        @jax.jit
        def jloss(g_params):
            fake, _ = gen.apply({"params": g_params, "batch_stats": g_stats},
                                z64, train=True, mutable=["batch_stats"])
            return jlosses.generator_loss(jcfg, critic, real64, fake, rng=key)[0]

        want = convert.flatten(jax.grad(jloss)(to_float64(js.g_params)))
        probe, _ = draws(jcfg, key, critic_side=False)
    _, _, got = port_generator_loss(tcfg, ts, real, z, probe, torch.float64)
    check_grads_per_leaf(want, got)


def test_jax_float64_restores_the_package():
    """Leaving ``jax_float64`` puts every patched name back and x64 off."""
    from _torch_parity import _F32_MODULES
    from smmdax.kernels import kernels as jkernels
    before = [m.jnp for m in _F32_MODULES]
    with jax_float64():
        assert jax.numpy.zeros(1).dtype == np.float64
    assert [m.jnp for m in _F32_MODULES] == before
    assert jkernels._F32["preferred_element_type"] == jax.numpy.float32
    assert jax.numpy.zeros(1).dtype == np.float32
