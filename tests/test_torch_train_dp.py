"""The port's data-parallel training (``losses`` with a ``DataAxis``,
``train.build_train_step(axis=...)``, ``train.data_parallel_train_step``)
against the JAX package's ``shard_map`` mode.

* the tmmd (and smmd) critic loss and its critic gradient under the ring
  and the gathered path on 2 gloo ranks equal the global loss (the port of
  tests/test_shardmap_mode.py:30-52, 151-192);
* ``global_batch_mmd=False`` (smmd dense, mmd through the fused arm's
  plain version): each rank's own MMD^2 pmean'd, against JAX's
  ``critic_loss`` with ``axis_name`` under ``shard_map`` on a 2-device mesh
  (smmdax/losses.py:141-150), which differs from the global loss;
* one tiny tmmd macro-step on 2 ranks, ring on, against
  ``jit_train_step(cfg, mesh=make_mesh(2), mode="shard_map")`` from the
  same state, with each rank's noise rebuilt from JAX's
  ``fold_in(rng, axis_index)`` draws (smmdax/train.py:189-191, 214-217):
  every parameter after the step, and the state bit-identical across ranks;
* a one-rank ring step (what chip_smoke.py runs on the card) against JAX's
  ``build_train_step(axis_name="data")`` under ``shard_map`` on one device.

The ranks run in one spawned group (``tests/_torch_dist.py``); the
one-rank step runs in this process.  The JAX step takes the ring's dense
arm, the port its fused arm (``use_pallas="on"``, plain versions on the
CPU), as tests/test_torch_train.py does.

Tolerances: losses as tests/test_shardmap_mode.py (loss and ratio rel
5e-4 / abs 1e-5, MMD^2 rel 2e-4 / abs 1e-6, sigma rel 2e-4, critic gradient
rtol 1e-3 / atol 2e-5); metrics rtol 1e-3 / atol 1e-6 (the ratio carries
the variance's float32 error); parameters after the step atol 2 lr per
update, BN statistics rtol 1e-4 / atol 1e-5, as tests/test_torch_train.py
explains; across ranks, equality.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist
from _torch_parity import configs, dp_draws, jax_state, port_state, rng
from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)
from smmdax import losses as jlosses
from smmdax import train as jtrain
from smmdax.configs import Config as JConfig
from smmdax_torch import convert
from smmdax_torch import train as ttrain
from smmdax_torch.parallel import init_data_axis

N = 2
DSTEPS, GSTEPS = 2, 1
STEP_OVERRIDES = dict(model="tmmd", use_ring_mmd=True, dsteps=DSTEPS, gsteps=GSTEPS,
                      ema_decay=0.9)
# (model, use_ring_mmd, use_pallas) of the critic-loss cases
LOSS_CASES = [("tmmd", True, "off"), ("tmmd", True, "on"), ("tmmd", False, "off"),
              ("smmd", True, "on"), ("smmd", False, "off")]
LOSS_IDS = [f"{m}-{'ring' if r else 'gathered'}-{'fused' if p == 'on' else 'dense'}"
            for m, r, p in LOSS_CASES]
# (model, use_pallas) of the per-rank cases: global_batch_mmd=False, each
# rank's own MMD estimator averaged over the ranks (smmdax/losses.py:141-150)
PER_RANK_CASES = [("smmd", "off"), ("mmd", "on")]
PER_RANK_IDS = [f"{m}-{'fused' if p == 'on' else 'dense'}" for m, p in PER_RANK_CASES]


def _loss_cfg(model, ring, use_pallas, global_batch=True):
    return dict(model=model, kernel="rq", dataset="synthetic", batch_size=16,
                output_size=32, gf_dim=8, df_dim=8, dof_dim=4, z_dim=8, dsteps=1,
                gsteps=1, num_data_shards=N, use_ring_mmd=ring, use_pallas=use_pallas,
                global_batch_mmd=global_batch)


def _per_rank_cfg(model, use_pallas):
    return _loss_cfg(model, False, use_pallas, global_batch=False)


def _loss_inputs():
    r = rng(5)
    real = (r.standard_normal((16, 4, 4, 2)) * 0.5).astype(np.float32)
    fake = (r.standard_normal((16, 4, 4, 2)) * 0.5 + 0.3).astype(np.float32)
    w = (r.standard_normal((32, 4)) * 0.3).astype(np.float32)
    return real, fake, w


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank gloo group: every critic-loss case, then the macro-step."""
    real, fake, w = _loss_inputs()
    jcfg, tcfg = configs(**STEP_OVERRIDES, num_data_shards=N, use_pallas="on")
    jcfg = jcfg.replace(use_pallas="off")       # the JAX side's dense ring arm
    js = jax_state(jcfg)
    batch = rng(11).integers(0, 256, (DSTEPS + GSTEPS, 16) + jcfg.image_shape,
                             dtype=np.uint8)
    noise = dp_draws(jcfg, jnp.asarray(js.rng), DSTEPS, GSTEPS, N)
    ts = port_state(tcfg, js)
    payload = dict(
        losses=[dict(cfg=cfg, real=real, fake=fake, w=w)
                for cfg in [_loss_cfg(*c) for c in LOSS_CASES]
                + [_per_rank_cfg(*c) for c in PER_RANK_CASES]],
        step=dict(cfg=dataclasses.asdict(tcfg), gen=ts.gen.state_dict(),
                  disc=ts.disc.state_dict(), noise=noise, real=batch))
    ranks = _torch_dist.run(N, "dp_suite", payload, tmp_path_factory.mktemp("dp"))
    step = jtrain.jit_train_step(jcfg, DSTEPS, GSTEPS, mesh=jtrain.make_mesh(N),
                                 mode="shard_map")
    js_next, jm = step(jax.tree.map(jnp.asarray, js), jnp.asarray(batch))
    return dict(ranks=ranks, jcfg=jcfg, js=js, js_next=jax.tree.map(np.asarray, js_next),
                jm={k: float(v) for k, v in jm.items()})


@pytest.mark.parametrize("case", range(len(LOSS_CASES)), ids=LOSS_IDS)
def test_sharded_critic_loss_matches_global(two_ranks, case):
    real, fake, w = _loss_inputs()
    jcfg = JConfig(**{**_loss_cfg(*LOSS_CASES[case]), "use_pallas": "off"})

    def jloss(wp):
        critic = lambda x: x.reshape(x.shape[0], -1) @ wp  # noqa: E731
        return jlosses.critic_loss(jcfg, critic, real, fake, jax.random.PRNGKey(1))

    (loss, aux), g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    for r in two_ranks["ranks"]:
        got = r["losses"][case]
        assert got["loss"] == pytest.approx(float(loss), rel=5e-4, abs=1e-5)
        assert got["ratio"] == pytest.approx(float(aux.ratio), rel=5e-4, abs=1e-5)
        assert got["mmd2"] == pytest.approx(float(aux.mmd2), rel=2e-4, abs=1e-6)
        if jcfg.with_scaling:
            assert got["sigma"] == pytest.approx(float(aux.sigma), rel=2e-4)
        np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("case", range(len(PER_RANK_CASES)), ids=PER_RANK_IDS)
def test_per_rank_critic_loss_matches_jax_shard_map(two_ranks, case):
    """global_batch_mmd=False: each rank's MMD^2 of its own blocks, pmean'd,
    against JAX's critic_loss with axis_name under shard_map on a 2-device
    mesh (not the global loss), and the pmean'd critic gradient."""
    real, fake, w = _loss_inputs()
    jcfg = JConfig(**{**_per_rank_cfg(*PER_RANK_CASES[case]), "use_pallas": "off"})
    mesh = Mesh(np.array(jax.devices()[:N]), ("data",))

    def shard(wp, r, f):
        def jloss(wp):
            critic = lambda x: x.reshape(x.shape[0], -1) @ wp  # noqa: E731
            return jlosses.critic_loss(jcfg, critic, r, f, jax.random.PRNGKey(1),
                                       axis_name="data")

        (loss, aux), g = jax.value_and_grad(jloss, has_aux=True)(wp)
        return loss, aux, jax.lax.pmean(g, "data")

    loss, aux, g = jax.jit(shard_map(shard, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                                     out_specs=P(), check_rep=False))(w, real, fake)
    # the global estimator differs: the case holds the per-rank one
    glob = jlosses.critic_loss(jcfg.replace(global_batch_mmd=True), lambda x: x.reshape(
        x.shape[0], -1) @ w, real, fake, jax.random.PRNGKey(1))[1]
    assert abs(float(glob.mmd2) - float(aux.mmd2)) > 1e-3 * abs(float(glob.mmd2))
    for r in two_ranks["ranks"]:
        got = r["losses"][len(LOSS_CASES) + case]
        assert got["loss"] == pytest.approx(float(loss), rel=5e-4, abs=1e-5)
        assert got["ratio"] == pytest.approx(float(aux.ratio), rel=5e-4, abs=1e-5)
        assert got["mmd2"] == pytest.approx(float(aux.mmd2), rel=2e-4, abs=1e-6)
        if jcfg.with_scaling:
            assert got["sigma"] == pytest.approx(float(aux.sigma), rel=2e-4)
        np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=1e-3, atol=2e-5)


def _check(want_tree, got, atol, rtol=0.0):
    want = convert.flatten(want_tree)
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol,
                                   err_msg=name)


def test_two_rank_step_matches_jax_shard_map(two_ranks):
    jcfg, nxt, jm = two_ranks["jcfg"], two_ranks["js_next"], two_ranks["jm"]
    got = two_ranks["ranks"][0]["step"]
    d_tol, g_tol = 2 * jcfg.lr_d * DSTEPS, 2 * jcfg.lr_g * GSTEPS
    assert got["step"] == int(nxt.step) == 1
    assert got["d_count"] == DSTEPS and got["g_count"] == GSTEPS
    assert set(got["metrics"]) == set(jm)
    for k, v in jm.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-3, abs=1e-6), k
    _check(nxt.d_params, got["disc"], d_tol)
    _check(nxt.g_params, got["gen"], g_tol)
    _check(nxt.g_batch_stats, got["gen_stats"], 1e-5, rtol=1e-4)
    _check(nxt.g_params_ema, got["g_params_ema"], 0.1 * g_tol)
    _check(nxt.g_stats_ema, got["g_stats_ema"], 1e-5, rtol=1e-4)


def test_two_rank_step_keeps_the_state_identical_across_ranks(two_ranks):
    a, b = (r["step"] for r in two_ranks["ranks"])
    assert a["metrics"] == b["metrics"]
    for part in ("gen", "gen_stats", "disc", "disc_buffers", "g_params_ema", "g_stats_ema"):
        assert set(a[part]) == set(b[part])
        for name in a[part]:
            np.testing.assert_array_equal(a[part][name], b[part][name],
                                          err_msg=f"{part}.{name}")
    # the ranks drew their own noise: the metrics are global, the draws not
    noise = dp_draws(two_ranks["jcfg"], jnp.asarray(two_ranks["js"].rng), DSTEPS, GSTEPS, N)
    assert not np.array_equal(noise[0]["d_z"], noise[1]["d_z"])


def test_one_rank_ring_step_matches_jax_shard_map():
    """build_train_step(axis=...) on a one-rank group: the program
    chip_smoke.py runs, against JAX's per-shard program on a one-device
    mesh (fold_in(rng, 0) draws)."""
    jcfg, tcfg = configs(**STEP_OVERRIDES, use_pallas="on")
    jcfg = jcfg.replace(use_pallas="off")
    js = jax_state(jcfg)
    batch = rng(12).integers(0, 256, (DSTEPS + GSTEPS, 16) + jcfg.image_shape,
                             dtype=np.uint8)
    noise = dp_draws(jcfg, jnp.asarray(js.rng), DSTEPS, GSTEPS, 1)[0]
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep = jax.jit(shard_map(jtrain.build_train_step(jcfg, DSTEPS, GSTEPS, axis_name="data"),
                              mesh=mesh, in_specs=(P(), P(None, "data")),
                              out_specs=(P(), P()), check_rep=False))
    nxt, jm = jstep(jax.tree.map(jnp.asarray, js), jnp.asarray(batch))
    nxt = jax.tree.map(np.asarray, nxt)
    ts = port_state(tcfg, js)
    axis = init_data_axis("cpu")
    try:
        assert (axis.size, axis.index) == (1, 0)
        ts, tm = ttrain.build_train_step(tcfg, DSTEPS, GSTEPS, axis=axis)(ts, batch,
                                                                         noise=noise)
    finally:
        axis.close()
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-3, abs=1e-6), k
    d_tol, g_tol = 2 * jcfg.lr_d * DSTEPS, 2 * jcfg.lr_g * GSTEPS

    def named(items):
        return {n: t.detach().numpy() for n, t in items}

    _check(nxt.d_params, named(ts.disc.named_parameters()), d_tol)
    _check(nxt.g_params, named(ts.gen.named_parameters()), g_tol)
    _check(nxt.g_batch_stats, named(ts.gen.named_buffers()), 1e-5, rtol=1e-4)


def test_data_parallel_entry_checks_and_short_circuits(monkeypatch):
    """Divisibility is checked; a one-rank (or no) axis runs the
    single-device program with the shard count pinned to 1."""
    _, tcfg = configs(**STEP_OVERRIDES)

    class FakeAxis:
        size, index = 3, 0

    with pytest.raises(ValueError, match="divisible"):
        ttrain.data_parallel_train_step(tcfg, DSTEPS, GSTEPS, FakeAxis())
    built = []
    monkeypatch.setattr(ttrain, "build_train_step",
                        lambda cfg, d, g, axis=None: built.append((cfg, axis)))
    FakeAxis.size = 1
    for axis in (None, FakeAxis()):
        ttrain.data_parallel_train_step(tcfg.replace(num_data_shards=2), DSTEPS, GSTEPS, axis)
    assert [(cfg.num_data_shards, axis) for cfg, axis in built] == [(1, None), (1, None)]
