"""The 1-D GaussianMix toy in the port: the MLP networks against flax
(forwards and parameter gradients at rtol 1e-5 / atol 1e-5, as
``test_torch_nn.py``), ``GaussianMix`` batches bit-identical to the JAX
package's, ``witness_fn`` against JAX's, a toy training run on the CPU
whose step receives the float32 samples unquantized, the frames with and
without matplotlib, and the command line's ``samples.npy``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, gain_critic, jax_state, port_state, rng
from smmdax.data.synthetic import GaussianMix as JGaussianMix
from smmdax.nn import build_models as jax_build
from smmdax.viz import witness_fn as jwitness_fn
from smmdax_torch import convert
from smmdax_torch.configs import Config
from smmdax_torch.data import GaussianMix, macro_batch_at, make_dataset
from smmdax_torch.main import main
from smmdax_torch.trainer import Trainer
from smmdax_torch.viz import assemble_toy_animation, plot_toy_frame, witness_fn
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
TOY = dict(dataset="gaussian_mix", architecture="mlp", model="mmd", kernel="gaussian",
           rbf_sigmas=(0.1, 0.25, 0.5, 1.0), z_dim=8, dof_dim=8)
# exp/toy_gaussian_mix.sh, cut to a few steps at a smaller batch
TOY_FLAGS = ["--dataset", "gaussian_mix", "--architecture", "mlp", "--model", "mmd",
             "--kernel", "gaussian", "--rbf_sigmas", "0.1", "0.25", "0.5", "1.0",
             "--batch_size", "64", "--z_dim", "8", "--dof_dim", "8",
             "--learning_rate", "3e-3", "--dsteps", "3", "--start_dsteps", "3",
             "--MMD_lr_scheduler", "false"]


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs(**TOY)
    js = jax_state(jcfg)
    return jcfg, tcfg, js, port_state(tcfg, js)


def _grads(module, loss):
    grads = torch.autograd.grad(loss, list(module.parameters()))
    return {n: g.numpy() for (n, _), g in zip(module.named_parameters(), grads)}


def _check(got: dict, want: dict):
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_mlp_generator_matches_flax(pair):
    jcfg, _, js, ts = pair
    gen, _ = jax_build(jcfg)
    z = rng(1).uniform(-1, 1, (16, jcfg.z_dim)).astype(np.float32)
    r = rng(2).standard_normal((16, 1)).astype(np.float32)
    jloss = lambda p: jnp.sum(gen.apply({"params": p, "batch_stats": {}}, z) * r)
    want = gen.apply({"params": js.g_params}, z)
    got = ts.gen(torch.from_numpy(z))
    assert got.shape == (16, 1) and not list(ts.gen.buffers())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _check(_grads(ts.gen, torch.sum(got * torch.from_numpy(r))),
           convert.flatten(jax.grad(jloss)(js.g_params)))


@pytest.mark.parametrize("with_sn", [False, True])
def test_mlp_critic_matches_flax(with_sn):
    jcfg, tcfg = configs(**TOY, with_sn=with_sn)
    js = jax_state(jcfg)
    ts = port_state(tcfg, js)
    _, disc = jax_build(jcfg)
    x = rng(3).uniform(-1, 1, (16, 1)).astype(np.float32)
    r = rng(4).standard_normal((16, jcfg.dof_dim)).astype(np.float32)
    jloss = lambda p: jnp.sum(disc.apply({"params": p, "spectral": js.d_spectral}, x) * r)
    want = disc.apply({"params": js.d_params, "spectral": js.d_spectral}, x)
    got = ts.disc(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    _check(_grads(ts.disc, torch.sum(got * torch.from_numpy(r))),
           convert.flatten(jax.grad(jloss)(js.d_params)))


def test_gaussian_mix_batches_bit_identical():
    cfg = Config(**TOY, random_seed=7)
    src, jsrc = make_dataset(cfg), JGaussianMix(seed=7)
    assert isinstance(src, GaussianMix) and src.sample_shape == (1,)
    for key in (None, None, 5, 2**31):
        a, b = src.batch(300, key=key), jsrc.batch(300, key=key)
        assert a.dtype == np.float32 and a.shape == (300, 1)
        assert a.tobytes() == b.tobytes()
    # toy_dim is ignored, as in the JAX package
    assert make_dataset(cfg.replace(toy_dim=3)).sample_shape == (1,)


@pytest.mark.parametrize("kernel", [dict(kernel="gaussian"),
                                    dict(kernel="rq", kernel_add_dot=0.5)])
def test_witness_fn_matches_jax(pair, kernel):
    jcfg, tcfg, js, _ = pair
    jcfg, tcfg = jcfg.replace(**kernel), tcfg.replace(**kernel)
    js = gain_critic(js, 8.0)
    ts = port_state(tcfg, js)
    _, disc = jax_build(jcfg)
    jcritic = lambda x: disc.apply({"params": js.d_params, "spectral": js.d_spectral},
                                   jnp.asarray(x))
    tcritic = lambda x: ts.disc(torch.as_tensor(x))
    real = rng(5).normal(-0.3, 0.1, (128, 1)).astype(np.float32)
    fake = rng(6).normal(0.4, 0.2, (96, 1)).astype(np.float32)
    grid = np.linspace(-1.3, 1.3, 301, dtype=np.float32)[:, None]
    want = jwitness_fn(jcfg, jcritic, grid, np.asarray(jcritic(real)),
                       np.asarray(jcritic(fake)))
    with torch.no_grad():
        got = witness_fn(tcfg, tcritic, grid, tcritic(real), tcritic(fake).numpy())
    assert got.shape == (301,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_toy_run_feeds_float32_batches(tmp_path):
    """A toy Trainer on the CPU: with uint8_transfer on (the default) each
    dispatch gets the GaussianMix macro-batch itself, float32; the samples
    are frames (matplotlib here), and the end of the run stitches them into
    the animation."""
    cfg = Config(**TOY, batch_size=32, real_batch_size=32, dsteps=2, start_dsteps=2,
                 max_iteration=4, steps_per_dispatch=2, log_every=2, sample_every=2,
                 checkpoint_every=0, MMD_lr_scheduler=False,
                 checkpoint_dir=str(tmp_path / "ck"), sample_dir=str(tmp_path / "s"),
                 log_dir=str(tmp_path / "l"))
    assert cfg.uint8_transfer
    t = Trainer(cfg, device="cpu")
    seen = []
    get_step = t._get_step

    def recording(dsteps, k):
        fn = get_step(dsteps, k)

        def step(state, batch):
            seen.append((state.step, batch))
            return fn(state, batch)
        return step

    t._get_step = recording
    state = t.train()
    assert state.step == 4 and [s for s, _ in seen] == [0, 2]
    for s, batch in seen:
        assert batch.dtype == np.float32 and batch.shape == (2, 3, 32, 1)
        want = np.stack([macro_batch_at(t.source, s + i, 3, 32) for i in range(2)])
        assert batch.tobytes() == want.tobytes()
    out = tmp_path / "s" / cfg.run_name()
    assert sorted(os.listdir(out)) == ["toy_0000002.png", "toy_0000004.png", "toy_animation.gif"]
    gif = (out / "toy_animation.gif").read_bytes()
    assert gif.startswith(b"GIF89a") and b"NETSCAPE2.0" in gif
    assert assemble_toy_animation(str(out)) == str(out / "toy_animation.gif")
    assert (out / "toy_animation.gif").read_bytes() == gif


def _frame_inputs():
    w = torch.full((1, 4), 0.5)
    critic = lambda x: torch.as_tensor(x).reshape(len(x), -1) @ w
    real = rng(7).normal(0, 0.3, (256, 1)).astype(np.float32)
    fake = rng(8).normal(0.2, 0.3, (256, 1)).astype(np.float32)
    return critic, real, fake


def test_plot_toy_frame_writes_png(tmp_path):
    critic, real, fake = _frame_inputs()
    path = plot_toy_frame(Config(**TOY), critic, real, fake, step=7, out_dir=str(tmp_path))
    assert path == str(tmp_path / "toy_0000007.png")
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_toy_frame_without_matplotlib(tmp_path, monkeypatch):
    """No matplotlib (as on the machine with the card): None, and nothing
    else is drawn in its place."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    critic, real, fake = _frame_inputs()
    assert plot_toy_frame(Config(**TOY), critic, real, fake, step=7,
                          out_dir=str(tmp_path / "frames")) is None
    assert not (tmp_path / "frames").exists()


def test_main_toy_writes_samples_npy(tmp_path, capsys):
    dirs = ["--checkpoint_dir", str(tmp_path / "ck"), "--sample_dir", str(tmp_path / "s"),
            "--log_dir", str(tmp_path / "l")]
    main(["--is_train", "true", "--device", "cpu", "--max_iteration", "2", "--log_every", "1",
          "--sample_every", "0"] + TOY_FLAGS + dirs)
    main(["--is_train", "false", "--device", "cpu", "--visualize", "true",
          "--no_of_samples", "100"] + TOY_FLAGS + dirs)
    out = tmp_path / "s" / "gaussian_mix_mlp_mmd_gaussian_b64"
    assert os.listdir(out) == ["samples.npy"]
    samples = np.load(out / "samples.npy")
    assert samples.shape == (64, 1) and samples.dtype == np.float32
    assert np.abs(samples).max() <= 1.0
    text = capsys.readouterr().out
    assert "sampling from random init" not in text and "samples.npy" in text
