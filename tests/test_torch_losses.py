"""The port's critic and generator losses against ``smmdax.losses``:
values and parameter gradients with the same probe and eps, from
converted weights.  The JAX side runs its dense path (the fused Pallas
path is held to it by tests/test_pallas.py); the port runs both.

Values: rtol 1e-4 / atol 1e-6.

Gradients are held in float32 here, against JAX float32 for the critic
and against the port's own float64 run for the generator, at rtol 1e-4 /
atol 1e-6 plus 3e-4 of the model's largest gradient entry; in float64,
leaf by leaf, against the JAX package in test_torch_losses64.py.  The
float32 gradients of these losses carry cancellation (the MMD gradient of
the head bias is exactly 0 in exact arithmetic, ~1e-6 in float32):
against float64, both packages' float32 critic gradients lie up to 9e-5
of that scale away.  Through the generator (BatchNorm on 16 samples,
tanh) the JAX package's float32 gradients lie up to 3.8e-3 of the scale
from its float64 ones, the port's within 6e-5, so the port's float32 run
is held to float64."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, jax_state, port_state, rng
from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)
from smmdax import losses as jlosses
from smmdax.nn import build_models as jax_build
from smmdax_torch import convert
from smmdax_torch import losses as tlosses

TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_SCALE_TOL = 3e-4

CASES = {
    "mmd": dict(model="mmd"),
    "mmd-fused": dict(model="mmd", use_pallas="on"),
    "smmd-exact": dict(model="smmd", scaling_grad_estimator="exact"),
    "smmd-sum": dict(model="smmd", scaling_grad_estimator="sum"),
    "smmd-hutchinson": dict(model="smmd", scaling_grad_estimator="hutchinson"),
    "sn-smmd": dict(model="sn-smmd", scaling_grad_estimator="hutchinson",
                    use_pallas="on"),
    "witness-gp": dict(model="mmd", gradient_penalty=1.0,
                       gp_variant="two_sided"),
    "wgan-gp": dict(model="wgan-gp", gradient_penalty=1.0, dof_dim=1),
}


def draws(jcfg, key, critic_side: bool):
    """The probe and eps the JAX losses draw from ``key``
    (losses.py:217-218, 262, 288, 348)."""
    probe = eps = None
    b = min(jcfg.batch_size, jcfg.real_batch_size)
    if critic_side and jcfg.model != "wgan-gp" and jcfg.with_scaling:
        key, k_scale = jax.random.split(key)
    else:
        k_scale = key
    if jcfg.with_scaling:
        probe = jax.random.rademacher(k_scale, (jcfg.dof_dim,), dtype=jnp.float32)
    if critic_side and (jcfg.gradient_penalty > 0 or jcfg.model == "wgan-gp"):
        eps = jax.random.uniform(key, (b, 1, 1, 1))
    to_t = (lambda a: None if a is None else torch.from_numpy(np.array(a)))
    return to_t(probe), to_t(eps)


def inputs(jcfg, js):
    r = rng(5)
    real = r.uniform(-1, 1, (16,) + jcfg.image_shape).astype(np.float32)
    z = r.uniform(-1, 1, (16, jcfg.z_dim)).astype(np.float32)
    gen, _ = jax_build(jcfg)
    fake, _ = gen.apply({"params": js.g_params, "batch_stats": js.g_batch_stats},
                        z, train=True, mutable=["batch_stats"])
    return real, z, np.asarray(fake)


def _check_grads(want, got):
    """{name: array} float32 gradients against {name: array} references."""
    assert set(want) == set(got)
    scale = max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   rtol=TOL["rtol"],
                                   atol=TOL["atol"] + GRAD_SCALE_TOL * scale)


def port_grads(loss, module):
    """{name: gradient} of ``loss`` over ``module``'s parameters."""
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return {n: g.numpy() for (n, _), g in zip(module.named_parameters(), grads)}


def port_generator_loss(tcfg, ts, real, z, probe, dtype):
    """(value, aux, gradients) of the port's generator loss; float64 runs
    copies of the modules on the dense path."""
    cfg, gen_m, disc_m = tcfg, ts.gen, ts.disc
    if dtype == torch.float64:
        cfg = tcfg.replace(use_pallas="off")
        gen_m, disc_m = copy.deepcopy(gen_m).double(), copy.deepcopy(disc_m).double()
    fake = gen_m(torch.from_numpy(z).to(dtype), train=True)
    val, aux = tlosses.generator_loss(
        cfg, disc_m, torch.from_numpy(real).to(dtype), fake,
        probe=None if probe is None else probe.to(dtype))
    return val, aux, port_grads(val, gen_m)


@pytest.mark.parametrize("case", list(CASES))
def test_critic_loss_matches(case):
    jcfg, tcfg = configs(**CASES[case])
    jcfg = jcfg.replace(use_pallas="off")
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    real, _, fake = inputs(jcfg, js)
    key = jax.random.PRNGKey(7)
    _, disc = jax_build(jcfg)

    @jax.jit
    def jloss(d_params):
        critic = lambda x: disc.apply({"params": d_params, "spectral": js.d_spectral}, x)
        return jlosses.critic_loss(jcfg, critic, real, fake, key)

    (jval, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(js.d_params)
    probe, eps = draws(jcfg, key, critic_side=True)
    tval, taux = tlosses.critic_loss(tcfg, ts.disc, torch.from_numpy(real),
                                     torch.from_numpy(fake), probe=probe, eps=eps)
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    for field in ("mmd2", "sigma", "gp", "ratio", "critic_real", "critic_fake"):
        np.testing.assert_allclose(float(getattr(taux, field)),
                                   float(getattr(jaux, field)), err_msg=field, **TOL)
    _check_grads(convert.flatten(jgrads),
                 {n: p.grad.numpy() for n, p in ts.disc.named_parameters()})


@pytest.mark.parametrize("case", ["mmd", "smmd-hutchinson", "sn-smmd", "wgan-gp"])
def test_generator_loss_matches(case):
    jcfg, tcfg = configs(**CASES[case])
    jcfg = jcfg.replace(use_pallas="off")
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    real, z, _ = inputs(jcfg, js)
    key = jax.random.PRNGKey(8)
    gen, disc = jax_build(jcfg)
    critic = lambda x: disc.apply({"params": js.d_params, "spectral": js.d_spectral}, x)

    @jax.jit
    def jloss(g_params):
        fake, _ = gen.apply({"params": g_params, "batch_stats": js.g_batch_stats},
                            z, train=True, mutable=["batch_stats"])
        return jlosses.generator_loss(jcfg, critic, real, fake, rng=key)

    (jval, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(js.g_params)
    probe, _ = draws(jcfg, key, critic_side=False)

    tval, taux, tgrads = port_generator_loss(tcfg, ts, real, z, probe, torch.float32)
    _, _, grads64 = port_generator_loss(tcfg, ts, real, z, probe, torch.float64)
    np.testing.assert_allclose(float(tval), float(jval), **TOL)
    np.testing.assert_allclose(float(taux.sigma), float(jaux.sigma), **TOL)
    _check_grads(grads64, tgrads)


def test_noise_is_required_not_invented():
    """hutchinson without a probe and a penalty without eps raise."""
    _, tcfg = configs(model="smmd", scaling_grad_estimator="hutchinson",
                      gradient_penalty=1.0)
    from smmdax_torch.nn import build_models
    _, disc = build_models(tcfg, torch.Generator().manual_seed(0))
    x = torch.rand((4,) + tcfg.image_shape) * 2 - 1
    with pytest.raises(ValueError, match="probe"):
        tlosses.critic_loss(tcfg, disc, x, x)
    with pytest.raises(ValueError, match="eps"):
        tlosses.critic_loss(tcfg, disc, x, x, probe=torch.ones(tcfg.dof_dim))
