"""The port's checkpoints (``smmdax_torch.checkpoint``): every field of the
training state round-trips bit for bit, the manager keeps its newest
``max_to_keep``, the best snapshot's swap survives a crash, the EMA can
be toggled across a resume (the JAX package's semantics), and
``restore_best`` never touches the live state."""

import os

import numpy as np
import pytest
import torch

from smmdax_torch import checkpoint
from smmdax_torch.checkpoint import CheckpointManager
from smmdax_torch.configs import Config
from smmdax_torch.train import build_train_step, create_state
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = Config(model="mmd", architecture="resnet", dataset="synthetic", gf_dim=8, df_dim=8,
             dof_dim=4, z_dim=8, batch_size=8, real_batch_size=8, dsteps=1, gsteps=1,
             ema_decay=0.9)


def _batch(step):
    return np.random.default_rng(step).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)


def _trained(cfg=CFG, seed=0, steps=2):
    """A state with non-trivial Adam moments, EMA shadows, lr and counters."""
    state = create_state(cfg, seed=seed, device="cpu")
    step = build_train_step(cfg, 1, 1)
    for s in range(steps):
        state, _ = step(state, _batch(s))
    state.lr_d = state.lr_d * 0.8
    state.sched_fails = 2
    return state


def _assert_equal(a, b):
    diffs = []

    def walk(x, y, where):
        if isinstance(x, dict):
            assert isinstance(y, dict) and set(x) == set(y), where
            for k in x:
                walk(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and torch.equal(x, y)):
                diffs.append(where)
        elif x != y:
            diffs.append(where)

    walk(checkpoint.state_dict(a), checkpoint.state_dict(b), "")
    assert not diffs, diffs


def test_save_restore_bit_exact(tmp_path):
    state = _trained()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    fresh = create_state(CFG, seed=1, device="cpu")
    assert mgr.restore(fresh) is fresh
    _assert_equal(state, fresh)
    assert fresh.step == 2 and fresh.sched_fails == 2 and fresh.g_opt.count == 2
    # the noise stream continues where it was: the next step is the same
    step = build_train_step(CFG, 1, 1)
    a, ma = step(state, _batch(7))
    b, mb = step(fresh, _batch(7))
    _assert_equal(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_restore_without_checkpoint_leaves_state(tmp_path):
    state = create_state(CFG, seed=0, device="cpu")
    before = checkpoint.state_dict(state)
    assert CheckpointManager(str(tmp_path)).restore(state) is None
    after = checkpoint.state_dict(state)
    assert all(torch.equal(before["gen"][k], after["gen"][k]) for k in before["gen"])


def test_max_to_keep(tmp_path):
    state = create_state(CFG, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    for s in range(1, 6):
        state.step = s
        mgr.save(s, state)
    assert sorted(os.listdir(tmp_path)) == ["4.pt", "5.pt"]
    assert mgr.latest_step() == 5
    assert mgr.restore(create_state(CFG, seed=0, device="cpu"), step=4).step == 4
    mgr.close()


def test_save_best_recovers_from_orphaned_old_state(tmp_path):
    """A crash between the two renames leaves only best/state.old: it is
    found, and the next save_best promotes it before deleting anything."""
    state = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path / "ckbest"))
    mgr.save_best(state, meta={"best_kid": 1.0, "best_step": 1})
    best_dir = tmp_path / "ckbest" / "best"
    os.rename(best_dir / "state", best_dir / "state.old")
    assert mgr.restore_best(state) is not None
    assert mgr.best_meta()["best_step"] == 1
    state2 = create_state(CFG, seed=1, device="cpu")
    mgr.save_best(state2, meta={"best_kid": 0.5, "best_step": 2})
    assert sorted(os.listdir(best_dir)) == ["state"]
    restored = mgr.restore_best(state)
    assert torch.equal(next(restored.disc.parameters()), next(state2.disc.parameters()))
    assert mgr.best_meta() == {"best_kid": 0.5, "best_step": 2}


@pytest.mark.parametrize("direction", ["ema_on_to_off", "ema_off_to_on"])
def test_ema_toggled_across_resume(tmp_path, direction):
    on, off = CFG, CFG.replace(ema_decay=0.0)
    saved_cfg, now_cfg = (on, off) if direction == "ema_on_to_off" else (off, on)
    state = _trained(saved_cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    restored = mgr.restore(create_state(now_cfg, seed=3, device="cpu"))
    assert all(torch.equal(p, q) for p, q in zip(restored.gen.parameters(),
                                                  state.gen.parameters()))
    if now_cfg.ema_decay == 0:
        assert restored.g_params_ema is None and restored.g_stats_ema is None
    else:
        # the shadows start from the restored live weights and BN statistics
        for name, p in restored.gen.named_parameters():
            assert torch.equal(restored.g_params_ema[name], p)
            assert restored.g_params_ema[name].data_ptr() != p.data_ptr()
        for name, b in restored.gen.named_buffers():
            assert torch.equal(restored.g_stats_ema[name], b)
        build_train_step(now_cfg, 1, 1)(restored, _batch(9))   # trains on


def test_restore_best_leaves_live_state_untouched(tmp_path):
    state = _trained(steps=1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(state, meta={"best_kid": 0.1, "best_step": 1})
    snapshot = checkpoint.state_dict(state)
    state, _ = build_train_step(CFG, 1, 1)(state, _batch(5))       # the live run goes on
    live = checkpoint.state_dict(state)
    best = mgr.restore_best(state)
    assert best is not state and best.generator is not state.generator
    got = checkpoint.state_dict(best)
    for part in ("gen", "disc"):
        assert all(torch.equal(got[part][k], snapshot[part][k]) for k in snapshot[part])
    assert got["step"] == 1 and got["g_opt"]["count"] == 1
    # nothing of the live state changed, and the two share no storage
    after = checkpoint.state_dict(state)
    for part in ("gen", "disc", "g_params_ema"):
        assert all(torch.equal(after[part][k], live[part][k]) for k in live[part])
    live_ptrs = {t.data_ptr() for t in list(state.gen.parameters()) + list(state.disc.parameters())}
    assert not live_ptrs & {t.data_ptr() for t in
                            list(best.gen.parameters()) + list(best.disc.parameters())}
