"""In-program data on one device (``data_placement="device"`` and
``on_device_data``), as ``tests/test_device_data.py`` holds the JAX
package's: the gather equals JAX's on the same indices, the index draw
keeps every batch row free of duplicates in its three regimes, the stream
is the same at any dispatch size and across a resume, it leaves the
step's noise stream alone, and two shards without their ranks are
refused while a sharded pool on one device takes the whole pool.
JAX's threefry index stream cannot be matched, so the indices are held
to these properties, not to JAX's draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmdax_torch import checkpoint
from smmdax_torch import train as ttrain
from smmdax_torch.configs import Config
from smmdax_torch.train import (batch_indices, build_train_step, create_state, data_stream,
                                device_data_train_step, on_device_train_step)
from smmdax_torch.trainer import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(dataset="synthetic", architecture="dcgan", model="mmd", kernel="gaussian",
            gf_dim=8, df_dim=8, dof_dim=4, z_dim=8, batch_size=8, real_batch_size=8,
            dsteps=1, gsteps=1, MMD_lr_scheduler=False)


def _pool(n=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _equal_states(a, b):
    sa, sb = checkpoint.state_dict(a), checkpoint.state_dict(b)

    def walk(x, y, where):
        if isinstance(x, dict):
            assert set(x) == set(y), where
            for k in x:
                walk(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), where
        else:
            assert x == y, where

    walk(sa, sb, "")


def test_gather_matches_jax_on_injected_indices(monkeypatch):
    """pool[idx] equals JAX's ``data[idx]``, and the device-data step with
    those indices is the host step on that batch, bit for bit."""
    cfg = Config(**BASE)
    pool = _pool()
    idx = np.random.default_rng(1).integers(0, len(pool), (2, 8))
    want = np.array(jnp.asarray(pool)[jnp.asarray(idx)])
    got = torch.from_numpy(pool)[torch.from_numpy(idx)]
    assert got.numpy().tobytes() == want.tobytes()

    monkeypatch.setattr(ttrain, "batch_indices", lambda *a: torch.from_numpy(idx))
    a, ma = device_data_train_step(cfg, 1, 1)(create_state(cfg, seed=3, device="cpu"),
                                              torch.from_numpy(pool))
    b, mb = build_train_step(cfg, 1, 1)(create_state(cfg, seed=3, device="cpu"), want)
    _equal_states(a, b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("pool_n, per_step, nb", [(100, 3, 20), (50, 3, 20), (10, 2, 16)],
                         ids=["permutation", "rows_without_replacement", "with_replacement"])
def test_batch_indices_regimes(pool_n, per_step, nb):
    cfg = Config(**BASE)
    draw = lambda step: batch_indices(data_stream(cfg, 1, step, "cpu"), pool_n, per_step, nb)
    idx = draw(5)
    assert idx.shape == (per_step, nb) and idx.dtype == torch.int64
    assert 0 <= int(idx.min()) and int(idx.max()) < pool_n
    assert torch.equal(idx, draw(5)) and not torch.equal(idx, draw(6))
    if pool_n >= nb:
        # no duplicate within a row; one permutation: none in the macro-step
        assert all(len(set(row.tolist())) == nb for row in idx)
        if per_step * nb <= pool_n:
            assert len(set(idx.flatten().tolist())) == per_step * nb
    else:
        assert len(set(idx.flatten().tolist())) < per_step * nb


@pytest.mark.parametrize("mode", ["device", "on_device"])
def test_stream_is_dispatch_invariant(mode):
    """Four macro-steps as 4 x K=1 and 2 x K=2: bit-identical states."""
    cfg = Config(**BASE)
    pool = torch.from_numpy(_pool())
    args = (pool,) if mode == "device" else ()
    build = device_data_train_step if mode == "device" else on_device_train_step
    states = []
    for k in (1, 2):
        step = build(cfg, 1, 1, steps_per_dispatch=k)
        state = create_state(cfg, seed=2, device="cpu")
        for _ in range(4 // k):
            state, _ = step(state, *args)
        assert state.step == 4
        states.append(state)
    _equal_states(*states)


def test_stream_leaves_the_step_noise_alone():
    """The gather draws from its own stream: after a macro-step the train
    noise generator is where a host-fed step leaves it."""
    cfg = Config(**BASE)
    a, _ = device_data_train_step(cfg, 1, 1)(create_state(cfg, seed=4, device="cpu"),
                                             torch.from_numpy(_pool()))
    b, _ = build_train_step(cfg, 1, 1)(create_state(cfg, seed=4, device="cpu"),
                                       _pool(2 * 8)[:16].reshape(2, 8, 32, 32, 3))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _cfg(tmp, **kw):
    return Config(**{**BASE, "checkpoint_dir": str(tmp / "ck"), "sample_dir": str(tmp / "s"),
                     "log_dir": str(tmp / "l"), "log_every": 2, "sample_every": 0,
                     "start_dsteps": 2, "warmup_iterations": 1, **kw})


@pytest.mark.parametrize("mode", [dict(data_placement="device", device_data_pool=64),
                                  dict(on_device_data=True)], ids=["device", "on_device"])
def test_trainer_resumes_exactly(tmp_path, mode, capsys):
    """Through the Trainer (warm-up step, then K=2 dispatches): stopped at 3
    and resumed to 5 equals the straight run to 5, bit for bit; no producer
    thread runs."""
    import threading
    before = threading.active_count()
    full = Trainer(_cfg(tmp_path / "full", max_iteration=5, checkpoint_every=0,
                        steps_per_dispatch=2, **mode), device="cpu")
    full_state = full.train()
    assert threading.active_count() == before
    half = _cfg(tmp_path / "half", max_iteration=3, checkpoint_every=3,
                steps_per_dispatch=2, **mode)
    Trainer(half, device="cpu").train()
    resumed = Trainer(half.replace(max_iteration=5), device="cpu")
    assert resumed.state.step == 3
    _equal_states(full_state, resumed.train())
    if "data_placement" in mode:
        assert "device-resident dataset: 64 samples" in capsys.readouterr().out


@pytest.mark.parametrize("bad", [dict(num_data_shards=2, data_placement="device"),
                                 dict(data_placement="device", device_data_sharding="sharded")],
                         ids=["several_ranks", "sharded_pool"])
def test_modes_over_several_ranks_still_raise(bad):
    """Two shards without their ranks are refused (the step runs on one
    rank); a sharded pool on one device builds, and gathers from the whole
    pool as the replicated layout does, as in the JAX package, whose
    single-device program ignores the layout."""
    cfg = Config(**BASE, **bad)
    if cfg.num_data_shards > 1:
        with pytest.raises(ValueError, match="start one process per rank"):
            device_data_train_step(cfg, 1, 1)
        return
    pool = torch.from_numpy(_pool())
    a, _ = device_data_train_step(cfg, 1, 1)(create_state(cfg, seed=3, device="cpu"), pool)
    replicated = cfg.replace(device_data_sharding="replicated")
    b, _ = device_data_train_step(replicated, 1, 1)(create_state(cfg, seed=3, device="cpu"),
                                                     pool)
    _equal_states(a, b)
