"""The port's ResNet generator and SN critic against the flax modules,
with converted weights, at f32 (rtol 1e-5 / atol 1e-5).

One exception, measured: the flax generator's own f32 output lies up to
1.4e-5 from a float64 evaluation of the same weights and inputs (the
port's f32 output lies within 3e-6 of it).  Its images are therefore
held to the float64 evaluation at 1e-5 and to flax at atol 3e-5."""

import copy

import numpy as np
import pytest
import torch

from _torch_parity import configs, jax_state, port_state, rng
from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)
from smmdax.nn import build_models as jax_build
from smmdax_torch import convert

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    js = jax_state(jcfg)
    return jcfg, tcfg, js, port_state(tcfg, js)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_generator_train_mode_and_bn_update(pair):
    jcfg, tcfg, js, _ = pair
    ts = port_state(tcfg, js)          # own copy: the BN update mutates it
    gen, _ = jax_build(jcfg)
    z = rng(1).uniform(-1, 1, (16, jcfg.z_dim)).astype(np.float32)
    want, upd = gen.apply({"params": js.g_params, "batch_stats": js.g_batch_stats},
                          z, train=True, mutable=["batch_stats"])
    gen64 = copy.deepcopy(ts.gen).double()
    got = ts.gen(torch.from_numpy(z), train=True, update_stats=True)
    exact = gen64(torch.from_numpy(z).double(), train=True)
    _close(got.detach(), exact.detach())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=3e-5)
    stats = convert.flatten(upd["batch_stats"])
    buffers = dict(ts.gen.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        _close(buffers[name], value)


def test_generator_eval_mode(pair):
    jcfg, _, js, ts = pair
    gen, _ = jax_build(jcfg)
    z = rng(2).uniform(-1, 1, (16, jcfg.z_dim)).astype(np.float32)
    want = gen.apply({"params": js.g_params, "batch_stats": js.g_batch_stats},
                     z, train=False)
    with torch.no_grad():
        got = ts.gen(torch.from_numpy(z), train=False)
    _close(got, want)


def test_critic_features_refresh_and_sigma(pair):
    """Features; one update_sn refresh keeps the new u; the sigma used
    after refresh + forward is two power iterations past the old u."""
    jcfg, tcfg, js, _ = pair
    ts = port_state(tcfg, js)          # own copy: the refresh mutates u
    _, disc = jax_build(jcfg)
    x = rng(3).uniform(-1, 1, (8,) + jcfg.image_shape).astype(np.float32)
    variables = {"params": js.d_params, "spectral": js.d_spectral}
    _close(ts.disc(torch.from_numpy(x)).detach(), disc.apply(variables, x))

    dummy = np.zeros((1,) + jcfg.image_shape, np.float32)
    _, upd = disc.apply(variables, dummy, update_sn=True, mutable=["spectral"])
    with torch.no_grad():
        ts.disc(torch.from_numpy(dummy), update_sn=True)
    for name, value in convert.flatten(upd["spectral"]).items():
        _close(dict(ts.disc.named_buffers())[name], value)

    refreshed = {"params": js.d_params, "spectral": upd["spectral"]}
    _close(ts.disc(torch.from_numpy(x)).detach(), disc.apply(refreshed, x))
    # sigma of one layer, as its forward computes it, against the JAX
    # power iteration from the refreshed u
    from smmdax.nn.layers import power_iteration as jax_pi
    from smmdax_torch.nn.layers import power_iteration
    kernel = np.asarray(js.d_params["block1"]["conv1"]["kernel"])
    u = np.asarray(upd["spectral"]["block1"]["conv1"]["u"])
    want, _ = jax_pi(kernel.reshape(-1, kernel.shape[-1]), u)
    w = ts.disc.block1.conv1.weight.detach()
    got, _ = power_iteration(w.reshape(w.shape[0], -1).T, ts.disc.block1.conv1.u)
    _close(got, want)


def test_critic_bf16_runs_f32_features():
    """Under bf16 compute the parameters stay f32 and features are f32."""
    _, tcfg = configs(compute_dtype="bfloat16")
    from smmdax_torch.nn import build_models
    gen, disc = build_models(tcfg, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in disc.parameters())
    z = torch.rand(4, tcfg.z_dim) * 2 - 1
    img = gen(z, train=True)
    feats = disc(img)
    assert img.dtype == feats.dtype == torch.float32
    assert feats.shape == (4, tcfg.dof_dim) and torch.isfinite(feats).all()
