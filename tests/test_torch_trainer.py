"""The port's training run (``smmdax_torch.trainer``).

The first part mirrors ``tests/test_trainer.py`` on the port alone
(model mmd, ResNet at gf/df 8, dof 4, B 8): the loop and warm-up, exact
resume (bit for bit, also with K-step dispatches), chunked scoring
generation, preemption, scheduler decisions across a resume, a fresh run
beside a stale best snapshot, disabled logging.

The second part holds the port's ``Trainer`` to the JAX package's on the
same config, with the step functions stubbed so that nothing compiles:
the dispatches (step, dsteps, k and a digest of the uint8 batch bytes)
and the steps of every log, sample, checkpoint, score and profiler edge;
the scheduler's decision rows and learning rates over four scoring events
with the same feature sets fed to both; and the command line's flags.
"""

import hashlib
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smmdax.trainer as jtrainer_mod
from smmdax.configs import Config as JConfig
from smmdax.configs import build_argparser as jbuild_argparser
from smmdax_torch import checkpoint
from smmdax_torch.configs import Config, build_argparser, config_from_args
from smmdax_torch.eval.features import extract_with_probs, get_feature_extractor
from smmdax_torch.train import (build_train_step, create_state, dispatch_train_step,
                                interpolate, sample)
from smmdax_torch.trainer import Trainer, _chunk_seed
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(dataset="synthetic", architecture="resnet", model="mmd", kernel="gaussian",
            gf_dim=8, df_dim=8, dof_dim=4, z_dim=8, batch_size=8, real_batch_size=8,
            max_iteration=6, dsteps=1, gsteps=1, start_dsteps=2, warmup_iterations=2,
            log_every=3, sample_every=0, checkpoint_every=3, MMD_lr_scheduler=False)
SCORING = dict(compute_scores=True, score_every=1, no_of_samples=64, score_subset_size=64,
               score_subsets=4, MMD_lr_scheduler=True)


def _dirs(tmp):
    return dict(checkpoint_dir=os.path.join(tmp, "ck"), sample_dir=os.path.join(tmp, "s"),
                log_dir=os.path.join(tmp, "l"))


def _cfg(tmp, **kw):
    return Config(**{**BASE, **_dirs(str(tmp)), **kw})


def _train(cfg):
    return Trainer(cfg, device="cpu").train()


def _assert_states_equal(a, b):
    sa, sb = checkpoint.state_dict(a), checkpoint.state_dict(b)
    bad = []

    def walk(x, y, where):
        if isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                walk(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                bad.append(where)
        elif x != y:
            bad.append(where)

    walk(sa, sb, "")
    assert not bad, bad


# ---------------------------------------------------------------------------
# the port alone


def test_train_loop_and_warmup(tmp_path):
    cfg = _cfg(tmp_path)
    t = Trainer(cfg, device="cpu")
    seen = []
    get_step = t._get_step
    t._get_step = lambda d, k: (seen.append((d, k)), get_step(d, k))[1]
    state = t.train()
    assert state.step == 6
    assert seen == [(2, 1), (2, 1), (1, 1), (1, 1), (1, 1), (1, 1)]
    rows = [r for r in open(t.writer.path)]
    assert len(os.listdir(cfg.log_dir)) == 1 and len(rows) == 2
    assert sorted(os.listdir(t.ckpt.directory)) == ["3.pt", "6.pt"]


def test_checkpoint_exact_resume(tmp_path):
    cfg = _cfg(tmp_path, max_iteration=4, checkpoint_every=2)
    state_a = _train(cfg)
    t2 = Trainer(cfg.replace(max_iteration=6), device="cpu")
    assert t2.state.step == 4 and t2._resumed
    _assert_states_equal(state_a, t2.state)
    assert t2.train().step == 6


@pytest.mark.parametrize("k", [1, 2])
def test_resume_continues_like_uninterrupted(tmp_path, k):
    """ckpt at 3, resume to 6 == straight to 6, bit for bit (noise stream,
    Adam, BN statistics, spectral u, EMA all carried), with K-step
    dispatches clipped at the checkpoint too."""
    full = _train(_cfg(tmp_path / "full", checkpoint_every=100, steps_per_dispatch=k,
                       ema_decay=0.5))
    half = _cfg(tmp_path / "half", max_iteration=3, checkpoint_every=3,
                steps_per_dispatch=k, ema_decay=0.5)
    _train(half)
    _assert_states_equal(full, _train(half.replace(max_iteration=6)))


def test_steps_per_dispatch_trainer_parity(tmp_path):
    """K=3 against awkward boundaries (warm-up switch at 2, logs and
    checkpoints every 3, end at 7) gives the K=1 state bit for bit."""
    s1 = _train(_cfg(tmp_path / "k1", max_iteration=7))
    sk = _train(_cfg(tmp_path / "k3", max_iteration=7, steps_per_dispatch=3))
    assert sk.step == 7
    _assert_states_equal(s1, sk)


def test_dispatch_is_k_single_steps():
    cfg = Config(**BASE)
    reals = np.random.default_rng(0).integers(0, 256, (3, 2, 8, 32, 32, 3), dtype=np.uint8)
    a = create_state(cfg, seed=4, device="cpu")
    a, ma = dispatch_train_step(cfg, 1, 1, steps_per_dispatch=3)(a, reals)
    b = create_state(cfg, seed=4, device="cpu")
    step = build_train_step(cfg, 1, 1)
    for r in reals:
        b, mb = step(b, r)
    _assert_states_equal(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    with pytest.raises(ValueError, match="3 macro-steps"):
        dispatch_train_step(cfg, 1, 1, steps_per_dispatch=3)(a, reals[:2])


@pytest.mark.parametrize("bad, roadmap", [(dict(num_data_shards=2), "A.12"),
                                          (dict(on_device_data=True), "A.7"),
                                          (dict(data_placement="device"), "A.7")])
def test_unported_modes_raise(tmp_path, bad, roadmap):
    with pytest.raises(NotImplementedError, match=roadmap):
        Trainer(_cfg(tmp_path, **bad), device="cpu")


def test_gen_feats_chunked_is_deterministic(tmp_path):
    """Chunked generation gives the full (n, d) set, fixed by the seed; one
    chunk is exactly sample -> extract."""
    cfg = _cfg(tmp_path, max_iteration=1, no_of_samples=64, checkpoint_every=0)
    t = Trainer(cfg, device="cpu")
    t._extractor = get_feature_extractor(cfg.data_dir, device="cpu")
    t.SCORE_CHUNK_IMAGE_BYTES = cfg.batch_size * int(np.prod(cfg.image_shape)) * 4
    n = 3 * cfg.batch_size + 7
    f1, _ = t._gen_feats(t.state, 42, n)
    f2, _ = t._gen_feats(t.state, 42, n)
    assert f1.shape == (n, 256) and np.all(np.isfinite(f1))
    np.testing.assert_array_equal(f1, f2)
    assert not np.allclose(f1, t._gen_feats(t.state, 43, n)[0])
    assert _chunk_seed(42, 0) != _chunk_seed(42, 1) != _chunk_seed(43, 1)
    t.SCORE_CHUNK_IMAGE_BYTES = Trainer.SCORE_CHUNK_IMAGE_BYTES
    direct, _ = extract_with_probs(
        t._extractor, sample(cfg, t.state, torch.Generator().manual_seed(42), n))
    np.testing.assert_array_equal(direct, t._gen_feats(t.state, 42, n)[0])


def test_scoring_rows_and_samples(tmp_path):
    cfg = _cfg(tmp_path, max_iteration=2, sample_every=2, checkpoint_every=0,
               ema_decay=0.5, ema_eval_compare=True, **SCORING)
    t = Trainer(cfg, device="cpu")
    t.train()
    rows = [json.loads(r) for r in open(t.writer.path)]
    scores = [r for r in rows if "kid" in r]
    assert [r["step"] for r in scores] == [1, 2]
    for r in scores:
        assert all(np.isfinite(r[k]) for k in ("fid", "kid", "kid_std", "fid_live", "kid_live"))
        assert r["fid_live"] != r["fid"]
    assert t._best_feats is not None and np.isfinite(t._best_kid)
    assert os.path.exists(os.path.join(cfg.sample_dir, cfg.run_name(), "sample_0000002.png"))


def test_preemption_checkpoints_and_resumes(tmp_path):
    cfg = _cfg(tmp_path, max_iteration=2000, checkpoint_every=0, log_every=10_000)
    t = Trainer(cfg, device="cpu")
    timer = threading.Timer(1.5, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    state = t.train()
    timer.cancel()
    assert 0 < state.step < 2000
    assert Trainer(cfg, device="cpu").state.step == state.step


def test_scheduler_resume_parity(tmp_path):
    """Interrupted == uninterrupted scheduler decisions: the best snapshot
    is rebuilt from its meta with the step-keyed seed."""
    kw = dict(SCORING, scheduler_patience=1, reload_best_on_decay=True)
    t_full = Trainer(_cfg(tmp_path / "full", max_iteration=4, checkpoint_every=100, **kw),
                     device="cpu")
    full = t_full.train()
    half = _cfg(tmp_path / "half", max_iteration=2, checkpoint_every=2, **kw)
    _train(half)
    t_res = Trainer(half.replace(max_iteration=4), device="cpu")
    resumed = t_res.train()
    _assert_states_equal(full, resumed)
    assert t_res._best_kid == t_full._best_kid
    np.testing.assert_array_equal(t_res._best_feats, t_full._best_feats)


def test_fresh_run_ignores_stale_best_checkpoint(tmp_path):
    cfg = _cfg(tmp_path, max_iteration=1, checkpoint_every=0, **SCORING)
    dead = Trainer(cfg, device="cpu")
    dead.state.step = 2000
    dead.ckpt.save_best(dead.state, meta={"best_kid": 1e-9, "best_step": 2000})
    t = Trainer(cfg, device="cpu")
    assert not t._resumed
    t.train()
    assert t.ckpt.best_meta()["best_step"] <= 1
    assert np.isfinite(t._best_kid) and t._best_kid > 1e-9


def test_log_every_zero_disables_logging(tmp_path):
    assert _train(_cfg(tmp_path, log_every=0, max_iteration=4)).step == 4


def test_debug_nans_raises_at_the_first_bad_dispatch(tmp_path):
    t = Trainer(_cfg(tmp_path, debug_nans=True), device="cpu")

    def bad_step(d, k):
        def fn(state, batch):
            state.step += k
            return state, {"d_loss_mmd2": torch.tensor(float("nan"))}
        return fn

    t._get_step = bad_step
    with pytest.raises(FloatingPointError, match="after step 1"):
        t.train()


def test_profiler_window_writes_trace(tmp_path):
    cfg = _cfg(tmp_path, max_iteration=4, profile_steps=2, profile_start=1, checkpoint_every=0)
    _train(cfg)
    prof = os.path.join(cfg.log_dir, "profile", cfg.run_name())
    assert [f for f in os.listdir(prof) if f.endswith(".json")]


def test_interpolate_walks_between_two_latents():
    cfg = Config(**BASE, ema_decay=0.5)
    state = create_state(cfg, seed=1, device="cpu")
    grid = interpolate(cfg, state, torch.Generator().manual_seed(3), rows=2, cols=3)
    assert grid.shape == (6,) + cfg.image_shape
    g = torch.Generator().manual_seed(3)
    z0 = torch.rand((2, cfg.z_dim), generator=g) * 2 - 1
    z1 = torch.rand((2, cfg.z_dim), generator=g) * 2 - 1
    z = torch.stack([z0, (z0 + z1) / 2, z1], dim=1).reshape(6, cfg.z_dim)
    weights = {**state.g_params_ema, **state.g_stats_ema}
    with torch.no_grad():
        want = torch.func.functional_call(state.gen, weights, (z,), {"train": False})
    torch.testing.assert_close(grid, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="own torch.Generator"):
        interpolate(cfg, state, state.generator)


# ---------------------------------------------------------------------------
# held to the JAX package's Trainer


AWKWARD = dict(max_iteration=19, warmup_iterations=3, steps_per_dispatch=3, log_every=8,
               sample_every=5, checkpoint_every=11, compute_scores=True, score_every=7,
               lr_decay_steps=9, profile_steps=3, profile_start=1)


def _digest(batch):
    arr = np.ascontiguousarray(np.asarray(batch))
    return arr.shape, arr.dtype.str, hashlib.sha1(arr.tobytes()).hexdigest()


def _recording(t, events, is_jax):
    """Stub every piece of work of trainer ``t`` by a recorder."""
    def get_step(dsteps, k):
        def fn(state, batch):
            events.append(("dispatch", int(state.step), dsteps, k, _digest(batch)))
            if is_jax:
                return state.replace(step=state.step + k), {"d_loss_mmd2": jnp.zeros(())}
            state.step += k
            return state, {"d_loss_mmd2": torch.zeros(())}
        return fn

    t._get_step = get_step
    t._save_samples = lambda step: events.append(("sample", step))
    t._score = lambda step: (events.append(("score", step)), {})[1]
    t.ckpt.save = lambda step, state, wait=False: events.append(("checkpoint", int(step)))
    t.writer.write = lambda step, m: events.append(("log", int(step), sorted(m)))


def test_dispatch_and_event_sequence_matches_jax(tmp_path, monkeypatch):
    j_events, t_events = [], []
    jt = jtrainer_mod.Trainer(JConfig(**{**BASE, **AWKWARD, **_dirs(str(tmp_path / "j"))}))
    _recording(jt, j_events, is_jax=True)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda path: j_events.append(("profile",)))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: j_events.append(("profile_end",)))
    tt = Trainer(Config(**{**BASE, **AWKWARD, **_dirs(str(tmp_path / "t"))}), device="cpu")
    _recording(tt, t_events, is_jax=False)

    def start():
        t_events.append(("profile",))
        tt._profiler = True

    def stop():
        t_events.append(("profile_end",))
        tt._profiler = None

    tt._start_profiler, tt._stop_profiler = start, stop
    jt.train()
    tt.train()
    assert t_events == j_events
    kinds = {e[0] for e in t_events}
    assert kinds == {"dispatch", "sample", "score", "checkpoint", "log", "profile", "profile_end"}
    assert {e[3] for e in t_events if e[0] == "dispatch"} == {1, 2, 3}
    assert float(tt.state.lr_d) == float(jt.state.lr_d) < 1e-4
    assert float(tt.state.lr_g) == float(jt.state.lr_g)


_frng = np.random.default_rng(11)
SCHED_REAL = _frng.normal(size=(200, 16)).astype(np.float32)
# KID against the real set: best, worse, worse, better
SCHED_EVENTS = [(_frng.normal(size=(200, 16)) + shift).astype(np.float32)
                for shift in (0.2, 0.35, 0.3, 0.1)]


@pytest.mark.parametrize("patience", [1, 2])
@pytest.mark.parametrize("test_arm", ["pvalue", "vote"])
def test_scheduler_decisions_match_jax(tmp_path, test_arm, patience):
    kw = dict(BASE, compute_scores=True, MMD_lr_scheduler=True, no_of_samples=200,
              score_subset_size=100, score_subsets=5, scheduler_test_size=150,
              three_sample_test=test_arm, scheduler_patience=patience,
              reload_best_on_decay=True)
    trainers = [jtrainer_mod.Trainer(JConfig(**kw, **_dirs(str(tmp_path / "j")))),
                Trainer(Config(**kw, **_dirs(str(tmp_path / "t"))), device="cpu")]
    for t in trainers:
        t._extractor = object()
        t._real_feats = SCHED_REAL
        calls = iter(SCHED_EVENTS)
        t._gen_feats = lambda *a, _calls=calls, **k: (next(_calls), None)
    jt, tt = trainers
    best_gen, rows = None, []
    for step, _ in enumerate(SCHED_EVENTS, start=1):
        jt.state = jt.state.replace(step=step)
        tt.state.step = step
        jrow, trow = jt._score(step), tt._score(step)
        rows.append(trow)
        assert sorted(jrow) == sorted(trow), (step, jrow, trow)
        for key in jrow:
            assert trow[key] == pytest.approx(jrow[key], rel=1e-10), (step, key)
        assert float(tt.state.lr_d) == float(jt.state.lr_d)
        assert float(tt.state.lr_g) == float(jt.state.lr_g)
        assert tt.state.sched_fails == int(jt.state.sched_fails)
        assert tt.state.step == int(jt.state.step) == step
        if trow.get("lr_decayed") == 0.0 and "sched_fails" not in trow:
            best_gen = [p.detach().clone() for p in tt.state.gen.parameters()]
        if trow.get("reloaded_best"):
            assert all(torch.equal(p, q) for p, q in zip(tt.state.gen.parameters(), best_gen))
    # every branch ran: promote on KID, a failed test, a decay with reload
    assert [r["lr_decayed"] for r in rows].count(1.0) == (2 if patience == 1 else 1)
    assert sum("reloaded_best" in r for r in rows) >= 1
    assert all(("three_sample_p" in r) == (test_arm == "pvalue") for r in rows[1:3])
    assert rows[3]["lr_decayed"] == 0.0 and "sched_fails" not in rows[3]


def _flags(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_argparser_matches_jax():
    """Flag for flag: names, defaults, nargs and types.  The one default
    that differs is pallas_min_rows (0 on the card, 4096 a TPU crossover)."""
    jflags, tflags = _flags(jbuild_argparser()), _flags(build_argparser())
    assert set(jflags) == set(tflags)
    for name, ja in jflags.items():
        ta = tflags[name]
        assert ta.option_strings == ja.option_strings and ta.nargs == ja.nargs, name
        if name == "pallas_min_rows":
            assert (ja.default, ta.default) == (4096, 0)
        else:
            assert ta.default == ja.default, name
        if ja.type in (int, float, str, None):
            assert ta.type is ja.type, name
        else:                                            # the bool parser
            for s in ("true", "True", "1", "yes", "false", "0", "no"):
                assert ta.type(s) == ja.type(s), (name, s)
    argv = ["--model", "sn-smmd", "--use_pallas", "true", "--rq_alphas", "0.5", "1",
            "--ema_decay", "0.9999", "--compute_scores", "yes"]
    from smmdax.configs import config_from_args as jconfig_from_args
    jc, tc = jconfig_from_args(argv), config_from_args(argv)
    for name in Config.__dataclass_fields__:
        if name != "pallas_min_rows":
            assert getattr(tc, name) == getattr(jc, name), name
    assert tc.run_name() == jc.run_name()
