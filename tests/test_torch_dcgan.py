"""The port's DCGAN networks (``smmdax_torch.nn.dcgan``) against the flax
modules, with converted weights, at f32 (rtol 1e-5 / atol 1e-5, as
``test_torch_nn.py``): the transposed convolution alone, the generator
and critic forwards and parameter gradients at 28 px (one channel, a 7x7
base) and 32 px, and one macro-step per loss family of the DCGAN
``exp/`` configs against ``smmdax.train`` with the JAX step's draws
replayed, at the tolerances of ``test_torch_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, gain_critic, jax_draws, jax_state, port_state, rng
from smmdax import train as jtrain
from smmdax.nn import build_models as jax_build
from smmdax.nn.layers import ConvTranspose as JConvTranspose
from smmdax_torch import convert
from smmdax_torch import train as ttrain
from smmdax_torch.nn import build_models
from smmdax_torch.nn.layers import ConvTranspose
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
DCGAN = dict(architecture="dcgan", gf_dim=8, df_dim=8)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("size, cin, cout", [(4, 3, 5), (7, 2, 1)])
def test_deconv_layer_matches_flax(size, cin, cout):
    """flax ConvTranspose (4x4, stride 2, SAME, unflipped kernel) against
    the port's layer holding the converted (flipped) kernel; the odd size
    is the 28 px generator's 7x7 base."""
    x = rng(1).standard_normal((2, size, size, cin)).astype(np.float32)
    layer = JConvTranspose(cout)
    params = layer.init(jax.random.PRNGKey(0), x)["params"]
    params = {"kernel": params["kernel"], "bias": jnp.asarray(
        rng(2).standard_normal(cout).astype(np.float32))}
    want = layer.apply({"params": params}, x)
    port = ConvTranspose(cin, cout)
    convert.load_module(port, params)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2 * size, 2 * size, cout)
    _close(got.detach(), want)


@pytest.fixture(scope="module", params=[dict(output_size=28, c_dim=1), dict(output_size=32)],
                ids=["28px", "32px"])
def pair(request):
    jcfg, tcfg = configs(**DCGAN, **request.param)
    js = jax_state(jcfg)
    return jcfg, tcfg, js


def _param_grads(module, loss):
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return {n: g.numpy() for (n, _), g in zip(module.named_parameters(), grads)}


def _check_grads(got, want):
    """Each gradient at rtol 1e-5 plus 1e-5 of the model's largest entry."""
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_generator_forward_and_gradients(pair):
    """Train mode with the BN update, and d<G(z), r>/d(params)."""
    jcfg, tcfg, js = pair
    ts = port_state(tcfg, js)
    gen, _ = jax_build(jcfg)
    z = rng(3).uniform(-1, 1, (16, jcfg.z_dim)).astype(np.float32)
    r = rng(4).standard_normal((16,) + jcfg.image_shape).astype(np.float32)

    def jloss(params):
        out, upd = gen.apply({"params": params, "batch_stats": js.g_batch_stats}, z,
                             train=True, mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd)

    (_, (want, upd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(js.g_params)
    got = ts.gen(torch.from_numpy(z), train=True, update_stats=True)
    _close(got.detach(), want)
    _check_grads(_param_grads(ts.gen, torch.sum(got * torch.from_numpy(r))),
                 convert.flatten(jgrads, ts.gen))
    buffers = dict(ts.gen.named_buffers())
    for name, value in convert.flatten(upd["batch_stats"]).items():
        _close(buffers[name], value)
    with torch.no_grad():
        _close(ts.gen(torch.from_numpy(z), train=False),
               gen.apply({"params": js.g_params, "batch_stats": upd["batch_stats"]}, z,
                         train=False))


def test_critic_forward_and_gradients(pair):
    """Features, d<D(x), r>/d(params) and d/dx, and the spectral refresh."""
    jcfg, tcfg, js = pair
    jcfg, tcfg = jcfg.replace(with_sn=True), tcfg.replace(with_sn=True)
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    _, disc = jax_build(jcfg)
    x = rng(5).uniform(-1, 1, (8,) + jcfg.image_shape).astype(np.float32)
    r = rng(6).standard_normal((8, jcfg.dof_dim)).astype(np.float32)
    variables = {"params": js.d_params, "spectral": js.d_spectral}

    def jloss(params, xx):
        return jnp.sum(disc.apply({"params": params, "spectral": js.d_spectral}, xx) * r)

    jgrads, jdx = jax.grad(jloss, argnums=(0, 1))(js.d_params, x)
    xt = torch.from_numpy(x).requires_grad_()
    feats = ts.disc(xt)
    _close(feats.detach(), disc.apply(variables, x))
    loss = torch.sum(feats * torch.from_numpy(r))
    _check_grads(_param_grads(ts.disc, loss), convert.flatten(jgrads, ts.disc))
    dx, = torch.autograd.grad(torch.sum(ts.disc(xt) * torch.from_numpy(r)), xt)
    _close(dx, jdx, rtol=1e-5, atol=1e-5 * float(np.abs(jdx).max()))

    dummy = np.zeros((1,) + jcfg.image_shape, np.float32)
    _, upd = disc.apply(variables, dummy, update_sn=True, mutable=["spectral"])
    with torch.no_grad():
        ts.disc(torch.from_numpy(dummy), update_sn=True)
    for name, value in convert.flatten(upd["spectral"]).items():
        _close(dict(ts.disc.named_buffers())[name], value)


def test_bf16_compute_keeps_f32_params_images_and_features():
    _, tcfg = configs(**DCGAN, compute_dtype="bfloat16")
    gen, disc = build_models(tcfg, torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in [*gen.parameters(), *disc.parameters()])
    img = gen(torch.rand(4, tcfg.z_dim) * 2 - 1, train=True)
    feats = disc(img)
    assert img.dtype == feats.dtype == torch.float32
    assert img.shape == (4, 32, 32, 3) and feats.shape == (4, tcfg.dof_dim)
    assert torch.isfinite(feats).all()


# one macro-step (1 critic + 1 generator update, B 8) per family of the
# DCGAN exp/ configs: cifar10_mmd_gp.sh, cifar10_smmd_dcgan.sh (exact
# sigma), cifar10_wgan_gp.sh
FAMILIES = {
    "mmd_gp": dict(model="mmd", gradient_penalty=1.0),
    "smmd_exact": dict(model="smmd", scaling_grad_estimator="exact", scaling_coeff=10.0),
    "wgan_gp": dict(model="wgan-gp", dof_dim=1, gradient_penalty=10.0,
                    gp_variant="two_sided"),
}


CRITIC_GAIN = 8.0     # see _torch_parity.gain_critic


@pytest.fixture(scope="module", params=list(FAMILIES))
def stepped(request):
    jcfg, tcfg = configs(**DCGAN, **FAMILIES[request.param], batch_size=8,
                         real_batch_size=8, dsteps=1, gsteps=1, use_pallas="off")
    js = gain_critic(jax_state(jcfg), CRITIC_GAIN)
    real = rng(9).integers(0, 256, (2, 8) + jcfg.image_shape, dtype=np.uint8)
    noise = jax_draws(jcfg, jnp.asarray(js.rng), 1, 1)
    js_next, jm = jax.jit(jtrain.build_train_step(jcfg, 1, 1))(
        jax.tree.map(jnp.asarray, js), real)
    ts, tm = ttrain.build_train_step(tcfg, 1, 1)(port_state(tcfg, js), real, noise=noise)
    return jcfg, jax.tree.map(np.asarray, js_next), jm, ts, tm


def test_macro_step_metrics_match(stepped):
    _, _, jm, _, tm = stepped
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_macro_step_state_matches(stepped):
    """Parameters within 2 lr per update (Adam's first step is about +-lr
    whatever the gradient), BN statistics at rtol 1e-4 / atol 1e-5."""
    jcfg, nxt, _, ts, _ = stepped
    for want, got, atol, rtol in (
            (nxt.d_params, dict(ts.disc.named_parameters()), 2 * jcfg.lr_d, 0.0),
            (nxt.g_params, dict(ts.gen.named_parameters()), 2 * jcfg.lr_g, 0.0),
            (nxt.g_batch_stats, dict(ts.gen.named_buffers()), 1e-5, 1e-4)):
        module = ts.disc if want is nxt.d_params else ts.gen
        want = convert.flatten(want, module)
        assert set(want) == set(got)
        for name in want:
            np.testing.assert_allclose(got[name].detach().numpy(), want[name], rtol=rtol,
                                       atol=atol, err_msg=name)
    assert ts.step == int(nxt.step) == 1
    assert ts.d_opt.count == ts.g_opt.count == 1
