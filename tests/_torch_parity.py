"""Shared helpers of the ``test_torch_*`` parity tests: the tiny flagship
config in both packages, a JAX state and its conversion to the port.

Inputs and noise are made with numpy and handed to both packages."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

from smmdax import losses as jlosses
from smmdax import train as jtrain
from smmdax.configs import Config as JConfig
from smmdax.kernels import kernels as jkernels
from smmdax.kernels import mmd as jmmd
from smmdax.kernels import smmd as jsmmd
from smmdax.nn import dcgan as jdcgan
from smmdax.nn import layers as jlayers
from smmdax.nn import resnet as jresnet
from smmdax_torch import convert
from smmdax_torch.configs import Config as TConfig

# the tiny flagship of __graft_entry__._flagship_cfg(tiny=True)
TINY = dict(model="sn-smmd", kernel="rq", architecture="resnet",
            dataset="synthetic", output_size=32, batch_size=16,
            real_batch_size=16, gf_dim=8, df_dim=8, dof_dim=4, z_dim=8,
            dsteps=1, gsteps=1, gradient_penalty=0.0)


def configs(**overrides):
    """(JAX Config, port Config) with the same fields."""
    jcfg = JConfig(**{**TINY, **overrides})
    tcfg = TConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(jcfg)})
    return jcfg, tcfg


@functools.lru_cache(maxsize=8)
def jax_state(jcfg: JConfig, seed: int = 0):
    """A JAX TrainState (numpy leaves) from create_state, jitted once."""
    state = jax.jit(lambda k: jtrain.create_state(jcfg, k))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, state)


def port_state(tcfg: TConfig, jstate):
    return convert.state_from_jax(tcfg, jstate, device="cpu")


class _Jnp64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


# the smmdax modules on the loss path that name jnp.float32
_F32_MODULES = (jlosses, jkernels, jmmd, jsmmd, jresnet, jdcgan, jlayers)


@contextlib.contextmanager
def jax_float64():
    """Run the JAX package's losses and networks in float64.

    Enables x64 and, for the duration, points the ``jnp`` of the modules
    above at a view whose ``float32`` is ``float64`` (their casts to
    float32 and the dots' preferred element type), so a float64 run stays
    float64 throughout.  The package's source is not touched."""
    saved = [(m, m.jnp) for m in _F32_MODULES]
    dot_type = jkernels._F32["preferred_element_type"]
    proxy = _Jnp64("jax.numpy.float64")
    with jax.enable_x64(True):
        try:
            for m, _ in saved:
                m.jnp = proxy
            jkernels._F32["preferred_element_type"] = jnp.float64
            yield
        finally:
            for m, orig in saved:
                m.jnp = orig
            jkernels._F32["preferred_element_type"] = dot_type


def to_float64(tree):
    """A pytree's leaves as float64 jax arrays (inside ``jax_float64``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def check_grads_per_leaf(want, got, rtol=1e-6):
    """{name: array} float64 gradients, each leaf held at ``rtol`` of its
    own largest entry.  Leaves that are exactly 0 in exact arithmetic (a
    conv bias ahead of BatchNorm) carry float64 rounding, about 1e-15 of
    the model's largest entry: the floor is 1e-10 of that."""
    assert set(want) == set(got)
    floor = 1e-10 * max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, rtol=rtol,
                                   atol=rtol * np.abs(want[name]).max() + floor)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)
