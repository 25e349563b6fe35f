"""The port's GSPMD-mode step over ranks (``data_parallel_train_step`` with
``dp_mode="gspmd"``) against the JAX package's GSPMD program and against
the port's own single-device step.

* two macro-steps on 2 gloo ranks, on the same global batches as
  ``jit_train_step(cfg, mesh=make_mesh(2), mode="gspmd")``, with the
  global draws rebuilt from JAX's key splits (``_torch_parity.jax_draws``:
  a GSPMD program draws what one device draws; JAX's runs, from its own
  ``create_state``, recorded by ``tests/fixtures/port_gspmd/make_fixtures.py``
  with their draws, metrics and final states), for mmd with and without
  the witness penalty, wgan-gp, smmd and sn-smmd, each with the ResNet
  generator's BatchNorm over the global batch, and the two penalties with
  fake and real batches of different sizes (the penalty pairs rows of the
  global batches that another rank holds);
* the same steps on one device of the port, and the two ranks' states
  equal bit for bit;
* ``BatchNorm`` with the axis against flax's over the concatenated batch,
  value, running statistics and input gradient;
* the EMA shadow replicated (tests/test_ema.py:335-365);
* the ranks drawing their own noise (the trainer's path): the global
  stream of one device.

Tolerances: metrics rtol 2e-3 / atol 2e-5 and parameters rtol 5e-3 /
atol 1e-4, as tests/test_train.py:87-92 holds 8 shards to one device;
the EMA shadow rtol 2e-4 / atol 2e-5 as tests/test_ema.py; BatchNorm
rtol 1e-5 / atol 1e-6 (one float32 reduction).  Two kinds of entries have
a gradient that is exactly 0 in exact arithmetic, and float32 rounding
in its place, which Adam's first steps turn into +-lr in a direction no
two summation orders share: the critic head's bias (every loss depends on
the features through differences between samples, or between the means
of the two sets) and the bias of every convolution in the generator's
blocks (a per-channel constant that the BatchNorm after it removes).
Those entries are held at the Adam bound of tests/test_torch_train.py, 2
lr per update; so is the generator against JAX, as there.
"""

import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from _torch_parity import configs, port_state, rng
from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)
from smmdax_torch import train as ttrain

N = 2
STEPS = 2
# (model, gradient_penalty) as tests/test_train.py:57-65, and sn-smmd; then
# (model, gradient_penalty, batch_size, real_batch_size) with B != Br
CASES = [("mmd", 0.0), ("mmd", 1.0), ("wgan-gp", 1.0), ("smmd", 1.0), ("sn-smmd", 0.0),
         ("mmd", 1.0, 8, 16), ("wgan-gp", 1.0, 16, 8)]
IDS = [f"{c[0]}-gp{c[1]:g}" + (f"-B{c[2]}-Br{c[3]}" if len(c) > 2 else "") for c in CASES]
METRIC_TOL = dict(rtol=2e-3, atol=2e-5)
PARAM_TOL = dict(rtol=5e-3, atol=1e-4)


def _cfgs(model, gp, batch=16, real=16):
    jcfg, tcfg = configs(model=model, gradient_penalty=gp, num_data_shards=N,
                         ema_decay=0.5, scaling_grad_estimator="hutchinson",
                         use_pallas="on", output_size=16, batch_size=batch,
                         real_batch_size=real)
    # the JAX side: a GSPMD program never takes the fused kernels
    return jcfg.replace(use_pallas="off"), tcfg


def _batches(jcfg, seed):
    return [rng(seed + i).integers(0, 256, (jcfg.dsteps + jcfg.gsteps, jcfg.real_batch_size)
                                   + jcfg.image_shape, dtype=np.uint8)
            for i in range(STEPS)]


def _reference():
    """JAX's GSPMD runs of every case, recorded by
    ``tests/fixtures/port_gspmd/make_fixtures.py`` (``load``)."""
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location(
        "make_gspmd_fixtures", os.path.join(os.path.dirname(__file__), "fixtures", "port_gspmd",
                                            "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.load(sys.modules[__name__])


def _port_one_device(tcfg, js, reals, noises):
    ts = port_state(tcfg.replace(num_data_shards=1), js)
    step = ttrain.build_train_step(tcfg.replace(num_data_shards=1), tcfg.dsteps, tcfg.gsteps)
    metrics = []
    for real, noise in zip(reals, noises):
        ts, m = step(ts, real, noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _torch_dist._np_state(ts)


def _bn_inputs():
    r = rng(21)
    x = (r.standard_normal((8, 3, 5, 4)) * 1.5 + 0.4).astype(np.float32)
    w = r.standard_normal((8, 3, 5, 4)).astype(np.float32)
    return x, w


SELF_DRAW = dict(model="sn-smmd", gp=0.0)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    rec, ref = _reference()
    cases, payload_cases = [], []
    for i, case in enumerate(CASES):
        jcfg, tcfg = _cfgs(*case)
        js = ref["initial"][rec._init_key(jcfg)]
        reals = _batches(jcfg, 30 + 10 * i)
        noises, jm, jnext = (ref["cases"][i][k] for k in ("noises", "metrics", "next"))
        ts = port_state(tcfg, js)
        payload_cases.append(dict(cfg=dataclasses.asdict(tcfg), gen=ts.gen.state_dict(),
                                  disc=ts.disc.state_dict(), reals=reals, noises=noises))
        one_m, one = _port_one_device(tcfg, js, reals, noises)
        cases.append(dict(jcfg=jcfg, jm=jm, jnext=jnext, one_m=one_m, one=one))
    # the ranks draw their own noise from a fresh state: no weights given
    _, tcfg = _cfgs(**SELF_DRAW)
    self_reals = _batches(tcfg, 90)
    payload_cases.append(dict(cfg=dataclasses.asdict(tcfg), self_draw=True,
                              reals=self_reals, noises=[None] * STEPS))
    x, w = _bn_inputs()
    ranks = _torch_dist.run(N, "gspmd_suite", dict(cases=payload_cases, bn=dict(x=x, w=w)),
                            tmp_path_factory.mktemp("gspmd"))
    # the same fresh state and batches on one device
    one = ttrain.create_state(tcfg.replace(num_data_shards=1), device="cpu")
    step = ttrain.build_train_step(tcfg.replace(num_data_shards=1), tcfg.dsteps, tcfg.gsteps)
    self_m = []
    for real in self_reals:
        one, m = step(one, real)
        self_m.append({k: float(v) for k, v in m.items()})
    return dict(cases=cases, ranks=ranks,
                self_draw=dict(metrics=self_m, state=_torch_dist._np_state(one)))


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def _zero_grad(part: str, name: str) -> bool:
    """Entries whose gradient is 0 in exact arithmetic (module docstring)."""
    if part.startswith("g"):
        return name.startswith("block") and name.endswith(".bias")
    return name == "head.bias"


def _close_params(part: str, got: dict, want: dict, bound: float, **tol):
    """``tol`` on every entry but those of ``_zero_grad``, which are held
    at ``bound``."""
    assert set(got) == set(want)
    for name in want:
        t = dict(rtol=0.0, atol=bound) if _zero_grad(part, name) else tol
        np.testing.assert_allclose(got[name], want[name], err_msg=f"{part}.{name}", **t)


def _bounds(cfg):
    """The Adam bound of each module after the test's steps."""
    return dict(disc=2 * cfg.lr_d * STEPS * cfg.dsteps, gen=2 * cfg.lr_g * STEPS * cfg.gsteps)


def _metrics_close(got, want):
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **METRIC_TOL)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gspmd_step_matches_jax_gspmd(suite, case):
    c, got = suite["cases"][case], suite["ranks"][0]["cases"][case]
    jcfg, nxt = c["jcfg"], c["jnext"]
    bound = _bounds(jcfg)
    _metrics_close(got["metrics"], c["jm"])
    _close_params("disc", got["disc"], nxt["d_params"], bound["disc"], **PARAM_TOL)
    _close(got["gen"], nxt["g_params"], rtol=0, atol=bound["gen"])
    _close(got["gen_stats"], nxt["g_batch_stats"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gspmd_step_matches_one_device(suite, case):
    c, got = suite["cases"][case], suite["ranks"][0]["cases"][case]
    bound = _bounds(c["jcfg"])
    _metrics_close(got["metrics"], c["one_m"])
    for part in ("disc", "gen"):
        _close_params(part, got[part], c["one"][part], bound[part], **PARAM_TOL)
    for part in ("gen_stats", "disc_buffers"):
        _close(got[part], c["one"][part], **PARAM_TOL)


@pytest.mark.parametrize("case", range(len(CASES) + 1), ids=IDS + ["self-draw"])
def test_gspmd_ranks_hold_identical_states(suite, case):
    a, b = (r["cases"][case] for r in suite["ranks"])
    assert a["metrics"] == b["metrics"]
    for part in ("gen", "gen_stats", "disc", "disc_buffers", "g_params_ema", "g_stats_ema"):
        assert set(a[part]) == set(b[part])
        for name in a[part]:
            np.testing.assert_array_equal(a[part][name], b[part][name],
                                          err_msg=f"{part}.{name}")


def test_gspmd_ema_shadow_replicated(suite):
    """The shadow over ranks equals the one-device recurrence
    (tests/test_ema.py:335-365, gspmd tolerance) in every case."""
    for c, got in zip(suite["cases"], suite["ranks"][0]["cases"]):
        _close_params("g_params_ema", got["g_params_ema"], c["one"]["g_params_ema"],
                      _bounds(c["jcfg"])["gen"], rtol=2e-4, atol=2e-5)
        _close(got["g_stats_ema"], c["one"]["g_stats_ema"], rtol=2e-4, atol=2e-5)
        assert all(np.isfinite(v).all() for v in got["g_params_ema"].values())


def test_gspmd_ranks_draw_the_one_device_stream(suite):
    """With no draws given, every rank draws the global noise from the
    shared stream (rank 0's): two ranks train as one device does."""
    got, want = suite["ranks"][0]["cases"][len(CASES)], suite["self_draw"]
    _metrics_close(got["metrics"], want["metrics"])
    _, cfg = _cfgs(**SELF_DRAW)
    bound = _bounds(cfg)
    for part in ("disc", "gen"):
        _close_params(part, got[part], want["state"][part], bound[part], **PARAM_TOL)
    _close(got["gen_stats"], want["state"]["gen_stats"], **PARAM_TOL)


def test_batchnorm_axis_matches_flax_over_the_global_batch(suite):
    x, w = _bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), nhwc)

    def loss(v):
        y, upd = bn.apply(variables, v, mutable=["batch_stats"])
        return jnp.sum(jnp.asarray(w.transpose(0, 2, 3, 1)) * y), (y, upd)

    (_, (y, upd)), g = jax.value_and_grad(loss, has_aux=True)(nhwc)
    y = np.asarray(y).transpose(0, 3, 1, 2)
    g = np.asarray(g).transpose(0, 3, 1, 2)
    ranks = [r["bn"] for r in suite["ranks"]]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), y, **tol)
    np.testing.assert_allclose(np.concatenate([r["grad"] for r in ranks]), g, **tol)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], np.asarray(upd["batch_stats"]["mean"]), **tol)
        np.testing.assert_allclose(r["var"], np.asarray(upd["batch_stats"]["var"]), **tol)


def test_rank_rows_split_the_global_draws():
    """Each rank's rows of the global draws: latent and penalty-weight
    blocks that concatenate to the whole, the probe whole."""
    _, tcfg = _cfgs("smmd", 1.0)
    r = rng(3)
    noise = {"d_z": r.random((2, 16, 8)), "g_z": r.random((1, 16, 8)),
             "d_probe": r.random((2, 4)), "g_probe": r.random((1, 4)),
             "d_eps": r.random((2, 16, 1, 1, 1))}

    class Axis:
        size = N

    parts = []
    for i in range(N):
        Axis.index = i
        parts.append(ttrain._rank_rows(tcfg, noise, Axis))
    for key in ("d_z", "g_z", "d_eps"):
        np.testing.assert_array_equal(np.concatenate([p[key] for p in parts], axis=1),
                                      noise[key])
    for key in ("d_probe", "g_probe"):
        assert all(p[key] is noise[key] for p in parts)
