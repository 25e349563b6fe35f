"""``cfg.remat``: the losses get the critic under activation checkpointing
(``smmdax_torch.train.critic_fn``), the counterpart of ``jax.checkpoint``
in ``smmdax.train._critic_fn``.  Rematerialisation changes memory, never
values: the critic's and the generator's gradients with it on equal those
with it off for every sigma estimator (``exact`` builds its Jacobian one
feature at a time under remat, since ``torch.func`` refuses checkpointed
functions) and for the witness and WGAN penalties, and a macro-step with
remat on leaves the same state, at rel 1e-6 of each tensor's largest
entry (the CPU gives them bit for bit)."""

import numpy as np
import pytest
import torch

from smmdax_torch import checkpoint
from smmdax_torch.configs import Config
from smmdax_torch.losses import critic_loss, generator_loss
from smmdax_torch.train import build_train_step, create_state, critic_fn
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(dataset="synthetic", architecture="dcgan", gf_dim=8, df_dim=8, dof_dim=4,
            z_dim=8, batch_size=8, real_batch_size=8, dsteps=1, gsteps=1)
CASES = {
    "smmd_hutchinson": dict(model="smmd", scaling_grad_estimator="hutchinson"),
    "smmd_sum": dict(model="smmd", scaling_grad_estimator="sum"),
    "smmd_exact": dict(model="smmd", scaling_grad_estimator="exact"),
    "sn_smmd_exact_value_and_grad": dict(model="sn-smmd", scaling_grad_estimator="exact",
                                         scaling_variant="value_and_grad"),
    "mmd_witness_gp": dict(model="mmd", gradient_penalty=1.0),
    "wgan_gp": dict(model="wgan-gp", dof_dim=1, gradient_penalty=10.0),
}


def _assert_close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), rtol=0,
                                   atol=1e-6 * float(y.detach().abs().max()))


def _inputs(cfg):
    g = np.random.default_rng(0)
    real = torch.from_numpy(g.uniform(-1, 1, (8,) + cfg.image_shape).astype(np.float32))
    z = torch.from_numpy(g.uniform(-1, 1, (8, cfg.z_dim)).astype(np.float32))
    probe = torch.from_numpy(g.choice([-1.0, 1.0], cfg.dof_dim).astype(np.float32))
    eps = torch.from_numpy(g.uniform(0, 1, (8, 1, 1, 1)).astype(np.float32))
    return real, z, probe, eps


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_equal_with_and_without_remat(case):
    cfg = Config(**{**BASE, **CASES[case]})
    state = create_state(cfg, seed=0, device="cpu")
    real, z, probe, eps = _inputs(cfg)
    fake = state.gen(z)
    d_params, g_params = list(state.disc.parameters()), list(state.gen.parameters())
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        critic = critic_fn(c, state.disc)
        assert (critic is state.disc) != remat
        loss, _ = critic_loss(c, critic, real, fake.detach(), probe=probe, eps=eps)
        d_grads = torch.autograd.grad(loss, d_params)
        g_loss, _ = generator_loss(c, critic, real, fake, probe=probe)
        g_grads = torch.autograd.grad(g_loss, g_params, retain_graph=True)
        out.append((loss, d_grads, g_loss, g_grads))
    (l0, d0, gl0, g0), (l1, d1, gl1, g1) = out
    _assert_close([l1, gl1], [l0, gl0])
    _assert_close(d1, d0)
    _assert_close(g1, g0)


def test_macro_step_state_equal_with_and_without_remat():
    cfg = Config(**BASE, **CASES["smmd_exact"])
    real = np.random.default_rng(1).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
    states = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state, _ = build_train_step(c, 1, 1)(create_state(c, seed=5, device="cpu"), real)
        states.append(checkpoint.state_dict(state))
    for part in ("gen", "disc"):
        names = sorted(states[0][part])
        _assert_close([states[1][part][n] for n in names], [states[0][part][n] for n in names])
