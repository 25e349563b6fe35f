"""One full macro-step (2 critic + 1 generator updates, EMA on) of the
port against ``smmdax.train`` from the same converted state, with the
JAX step's random draws replayed through ``train_step(..., noise=...)``.

Tolerances and their reasons:
* metrics: rtol 1e-4 / atol 1e-6;
* raw gradients of the first critic update: rtol 1e-4 plus 3e-4 of the
  largest entry (float32 cancellation, see test_torch_losses.py);
* parameters after the step: atol 2 * lr * updates.  Adam's first step
  is g / (|g| + eps), about +-lr whatever |g| is, so a parameter whose
  gradient is near 0 in both packages (the MMD gradient of the head bias
  is exactly 0 in exact arithmetic) may move by +lr in one and -lr in
  the other;
* the change each update makes (after - before), which that bound cannot
  see: 0.1 lr for the generator, 0.2 lr for the two critic steps and
  0.1 (1 - decay) lr for the EMA shadow, on the entries whose gradient is
  large enough for its sign to be fixed (constants below);
* BN running statistics: rtol 1e-4 / atol 1e-5 (no optimizer in their path);
* EMA shadows (decay 0.9): 0.1 of the parameter tolerance;
* spectral-norm u after two refreshes from weights that differ by the
  parameter tolerance: atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, jax_state, port_state, rng
from smmdax import losses as jlosses
from smmdax import train as jtrain
from smmdax_torch import convert
from smmdax_torch import losses as tlosses
from smmdax_torch import train as ttrain

DSTEPS, GSTEPS = 2, 1
OVERRIDES = dict(dsteps=DSTEPS, gsteps=GSTEPS, ema_decay=0.9,
                 scaling_grad_estimator="hutchinson")
# entries whose JAX gradient lies below these fractions of the largest are
# left out of the update checks: their sign is not fixed in float32.  The
# JAX package's float32 generator gradients lie up to 3.8e-3 of the scale
# from float64, and the two packages' critic gradients up to 1.0e-4 of it
# from each other (test_torch_losses.py).  At most MAX_LEFT_OUT of a
# model's entries may be left out (8.5% of G's and 6.1% of D's are).
G_SIGN_FRAC, D_SIGN_FRAC = 4e-3, 3e-4
MAX_LEFT_OUT = 0.1
# the change an update makes, in units of lr: one generator step moves an
# entry by about lr.  The critic's second step has the size of its
# moments' ratio, which a 1e-4 gradient difference moves by up to 0.1 lr
# at the smallest kept entries; a skipped step would still be 5x over.
G_CHANGE_TOL, D_CHANGE_TOL = 0.1, 0.2
STATS_CHANGE_ATOL = 1e-7


def jax_draws(jcfg, key, dsteps, gsteps):
    """Every draw of smmdax.train's macro-step from the state key
    (train.py:286, 189-191, 214-217; losses.py:348, 217-218, 262)."""
    _, *step_rngs = jax.random.split(key, 1 + dsteps + gsteps)
    b, dof = min(jcfg.batch_size, jcfg.real_batch_size), jcfg.dof_dim
    z_shape = (jcfg.batch_size, jcfg.z_dim)
    out = {"d_z": [], "d_probe": [], "d_eps": [], "g_z": [], "g_probe": []}
    for r in step_rngs[:dsteps]:
        rng_z, r = jax.random.split(r)
        out["d_z"].append(jax.random.uniform(rng_z, z_shape, minval=-1.0, maxval=1.0))
        if jcfg.with_scaling:
            r, r_scale = jax.random.split(r)
            out["d_probe"].append(jax.random.rademacher(r_scale, (dof,), dtype=jnp.float32))
        if jcfg.gradient_penalty > 0:
            out["d_eps"].append(jax.random.uniform(r, (b, 1, 1, 1)))
    for r in step_rngs[dsteps:]:
        rng_z, r_scale = jax.random.split(r)
        out["g_z"].append(jax.random.uniform(rng_z, z_shape, minval=-1.0, maxval=1.0))
        if jcfg.with_scaling:
            out["g_probe"].append(jax.random.rademacher(r_scale, (dof,), dtype=jnp.float32))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items() if v}


def _first_critic_grads(jcfg, js, real, z):
    """JAX gradient of the first critic update (train.py:186-208)."""
    gen, disc = jtrain.build_models(jcfg)
    fake, _ = gen.apply({"params": js.g_params, "batch_stats": js.g_batch_stats},
                        z, train=True, mutable=["batch_stats"])
    spectral = jtrain._refresh_spectral(disc, jcfg, js.d_params, js.d_spectral)
    key = jax.random.split(jax.random.split(jnp.asarray(js.rng), 1 + DSTEPS + GSTEPS)[1])[1]

    def jloss(d_params):
        critic = lambda x: disc.apply({"params": d_params, "spectral": spectral}, x)
        return jlosses.critic_loss(jcfg, critic, real, fake, key)[0]

    return convert.flatten(jax.jit(jax.grad(jloss))(js.d_params))


@pytest.fixture(scope="module")
def stepped():
    jcfg, tcfg = configs(**OVERRIDES, use_pallas="on")
    jcfg = jcfg.replace(use_pallas="off")       # the JAX side's dense path
    js = jax_state(jcfg)
    real = rng(9).integers(0, 256, (DSTEPS + GSTEPS, 16) + jcfg.image_shape,
                           dtype=np.uint8)
    noise = jax_draws(jcfg, jnp.asarray(js.rng), DSTEPS, GSTEPS)
    js_next, jmetrics = jax.jit(jtrain.build_train_step(jcfg, DSTEPS, GSTEPS))(
        jax.tree.map(jnp.asarray, js), real)
    ts = port_state(tcfg, js)
    ts, tmetrics = ttrain.build_train_step(tcfg, DSTEPS, GSTEPS)(ts, real, noise=noise)
    real0 = (real[0].astype(np.float32) - 127.5) / 127.5
    return dict(jcfg=jcfg, tcfg=tcfg, js=js, real=real, noise=noise,
                js_next=jax.tree.map(np.asarray, js_next), jm=jmetrics,
                ts=ts, tm=tmetrics,
                d_grad1=_first_critic_grads(jcfg, js, real0, noise["d_z"][0]))


def test_metrics_match(stepped):
    jm, tm = stepped["jm"], stepped["tm"]
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_first_critic_update_gradients_match(stepped):
    tcfg, js = stepped["tcfg"], stepped["js"]
    real = (stepped["real"][0].astype(np.float32) - 127.5) / 127.5
    z = stepped["noise"]["d_z"][0]
    probe = stepped["noise"]["d_probe"][0]
    want = stepped["d_grad1"]
    ts = port_state(tcfg, js)
    with torch.no_grad():
        tfake = ts.gen(torch.from_numpy(z), train=True)
    ttrain._refresh_spectral(tcfg, ts.disc, "cpu")
    loss, _ = tlosses.critic_loss(tcfg, ts.disc, torch.from_numpy(real), tfake,
                                  probe=torch.from_numpy(probe))
    grads = torch.autograd.grad(loss, list(ts.disc.parameters()))
    got = {n: g.numpy() for (n, _), g in zip(ts.disc.named_parameters(), grads)}
    scale = max(np.abs(w).max() for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-6 + 3e-4 * scale, err_msg=name)


def _check(want_tree, got, atol, rtol=0.0):
    want = convert.flatten(want_tree)
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name].detach()), want[name],
                                   rtol=rtol, atol=atol, err_msg=name)


def test_next_state_matches(stepped):
    jcfg, nxt, ts = stepped["jcfg"], stepped["js_next"], stepped["ts"]
    d_tol = 2 * jcfg.lr_d * DSTEPS
    g_tol = 2 * jcfg.lr_g * GSTEPS
    assert ts.step == int(nxt.step) == 1
    _check(nxt.d_params, dict(ts.disc.named_parameters()), d_tol)
    _check(nxt.g_params, dict(ts.gen.named_parameters()), g_tol)
    _check(nxt.g_batch_stats, dict(ts.gen.named_buffers()), 1e-5, rtol=1e-4)
    _check(nxt.g_params_ema, ts.g_params_ema, 0.1 * g_tol)
    _check(nxt.g_stats_ema, ts.g_stats_ema, 1e-5, rtol=1e-4)
    _check(nxt.d_spectral, dict(ts.disc.named_buffers()), 1e-3)
    assert ts.d_opt.count == int(nxt.d_opt_state.count) == DSTEPS
    assert ts.g_opt.count == int(nxt.g_opt_state.count) == GSTEPS


def _adam_grads(cfg, mu, first=None):
    """The gradients of each Adam update, recovered from JAX's first
    moment: mu_1 = (1 - b1) g_1, mu_2 = b1 mu_1 + (1 - b1) g_2."""
    b1 = cfg.beta1
    mu = convert.flatten(mu)
    if first is None:
        return [{k: v / (1 - b1) for k, v in mu.items()}]
    return [first, {k: (v - b1 * (1 - b1) * first[k]) / (1 - b1)
                    for k, v in mu.items()}]


def _sign_fixed(grads, frac):
    """{name: bool mask}: entries where every update's JAX gradient is at
    least ``frac`` of that update's largest entry, so each Adam step has
    the same sign in both packages."""
    masks = {}
    for g in grads:
        scale = max(np.abs(v).max() for v in g.values())
        for k, v in g.items():
            masks[k] = masks.get(k, True) & (np.abs(v) >= frac * scale)
    return masks


def _check_change(before, want_after, got_after, mask, atol):
    """(after - before) in the port against JAX's, on the ``mask`` entries;
    at most MAX_LEFT_OUT of all entries left out."""
    left_out = total = 0
    for name in before:
        want = want_after[name] - before[name]
        got = np.asarray(got_after[name].detach()) - before[name]
        keep = mask[name]
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=atol,
                                   err_msg=name)
        left_out += int((~keep).sum())
        total += keep.size
    assert left_out <= MAX_LEFT_OUT * total, (left_out, total)


@pytest.mark.parametrize("part", ["critic", "generator", "generator_ema"])
def test_update_matches(stepped, part):
    """The change each update makes, held to JAX's at a fraction of lr
    (G_CHANGE_TOL, D_CHANGE_TOL; the EMA shadow's at (1 - decay) of it),
    on the entries whose gradient sign is fixed (G_SIGN_FRAC, D_SIGN_FRAC)."""
    jcfg, js, nxt, ts = stepped["jcfg"], stepped["js"], stepped["js_next"], stepped["ts"]
    if part == "critic":
        grads = _adam_grads(jcfg, nxt.d_opt_state.mu, first=stepped["d_grad1"])
        _check_change(convert.flatten(js.d_params), convert.flatten(nxt.d_params),
                      dict(ts.disc.named_parameters()),
                      _sign_fixed(grads, D_SIGN_FRAC), D_CHANGE_TOL * jcfg.lr_d)
        return
    mask = _sign_fixed(_adam_grads(jcfg, nxt.g_opt_state.mu), G_SIGN_FRAC)
    if part == "generator":
        _check_change(convert.flatten(js.g_params), convert.flatten(nxt.g_params),
                      dict(ts.gen.named_parameters()), mask, G_CHANGE_TOL * jcfg.lr_g)
    else:
        # the shadow moves by (1 - decay) of the weights' change
        _check_change(convert.flatten(js.g_params_ema), convert.flatten(nxt.g_params_ema),
                      ts.g_params_ema, mask,
                      G_CHANGE_TOL * (1 - jcfg.ema_decay) * jcfg.lr_g)
        stats0 = convert.flatten(js.g_stats_ema)
        _check_change(stats0, convert.flatten(nxt.g_stats_ema), ts.g_stats_ema,
                      {k: np.ones(v.shape, bool) for k, v in stats0.items()},
                      STATS_CHANGE_ATOL)


def test_step_draws_its_own_noise_on_the_state_generator():
    """Without ``noise`` the step draws from state.generator: two states
    from one seed give the same step; the generator advances."""
    _, tcfg = configs(**OVERRIDES)
    real = rng(10).integers(0, 256, (DSTEPS + GSTEPS, 16) + tcfg.image_shape,
                            dtype=np.uint8)
    step = ttrain.build_train_step(tcfg, DSTEPS, GSTEPS)
    out = []
    for _ in range(2):
        state = ttrain.create_state(tcfg, seed=3, device="cpu")
        g0 = state.generator.get_state().clone()
        state, m = step(state, real)
        assert not torch.equal(state.generator.get_state(), g0)
        assert all(torch.isfinite(v).all() for v in m.values())
        out.append(m)
    for k in out[0]:
        assert float(out[0][k]) == float(out[1][k]), k
    g_train = state.generator.get_state().clone()
    imgs = ttrain.sample(tcfg, state, torch.Generator().manual_seed(4), n=20)
    assert imgs.shape == (20,) + tcfg.image_shape
    assert float(imgs.abs().max()) <= 1.0
    assert torch.equal(state.generator.get_state(), g_train)   # training's stream untouched
    with pytest.raises(ValueError, match="own torch.Generator"):
        ttrain.sample(tcfg, state, state.generator, n=4)


def test_step_runs_backward_on_calling_thread():
    """The step's backward passes run with the autograd engine's worker
    threads off, so every node's sequence number comes from the calling
    thread and the order in which gradient contributions are summed does
    not depend on what ran before in the process (on the card the sigma
    term's create-graph backward would otherwise build its nodes on the
    engine's CUDA thread)."""
    import threading
    _, tcfg = configs(**OVERRIDES)
    state = ttrain.create_state(tcfg, seed=1, device="cpu")
    seen = []
    for p in list(state.disc.parameters())[:1] + list(state.gen.parameters())[:1]:
        p.register_hook(lambda g: seen.append((threading.get_ident(),
                                               torch._C._is_multithreading_enabled())) or g)
    real = rng(11).integers(0, 256, (DSTEPS + GSTEPS, 16) + tcfg.image_shape, dtype=np.uint8)
    ttrain.build_train_step(tcfg, DSTEPS, GSTEPS)(state, real)
    assert len(seen) >= DSTEPS + GSTEPS
    assert all(s == (threading.get_ident(), False) for s in seen), seen
    assert torch._C._is_multithreading_enabled()        # restored after the step
