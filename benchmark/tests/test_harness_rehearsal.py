"""The harness's CPU rehearsal: each kind of cell driven end to end at
tiny shapes (``run.drive(..., device="cpu")``), and with its timed path
broken underneath, where ``correct`` has to come out false.  The command
itself never runs without a card."""

import pytest
import torch

from benchmark import run
from benchmark.tests._tiny import SCORE_CELL, TRAIN_CELL, score_config, threads, train_config

SEED = 2_147_483_659 * 3


@pytest.fixture(autouse=True)
def _few_threads():
    with threads():
        yield


def _drive(cell, config):
    return run.drive(cell, SEED, 0.5, False, device="cpu", config=config)


def _dcgan_config():
    """The train cell's configuration with the DCGAN pair: an
    architecture that no cell runs, taken by its reference networks
    (``benchmark/reference/arch/dcgan.py``) alone."""
    return train_config(architecture="dcgan")


@pytest.mark.parametrize("cell,config", [(TRAIN_CELL, train_config), (SCORE_CELL, score_config),
                                         (TRAIN_CELL, _dcgan_config)],
                         ids=["train", "score", "train_dcgan"])
def test_rehearsal(cell, config):
    out = _drive(cell, config())
    r = out["result"]
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device"}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    # a CPU run: no device metric, and it says where it ran
    assert r["device"]["platform"] == "cpu"
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())


def test_the_command_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", TRAIN_CELL, "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0


# -- faults planted under the timed path ----------------------------------


def _unchanged(real):
    """A dispatch that returns its state unchanged (the losses computed)."""
    def build(*a, **kw):
        step = real(*a, **kw)

        def broken(state, batch):
            keep = {k: v.clone() for k, v in _leaves(state).items()}
            counts = state.g_opt.count, state.d_opt.count
            state, m = step(state, batch)
            for k, v in _leaves(state).items():
                v.data.copy_(keep[k])
            state.g_opt.count, state.d_opt.count = counts
            return state, m
        return broken
    return build


def _leaves(state):
    out = {}
    for name, mod in (("gen", state.gen), ("disc", state.disc)):
        for k, v in list(mod.named_parameters()) + list(mod.named_buffers()):
            out[f"{name}.{k}"] = v
    for name, d in (("mu_g", state.g_opt.mu), ("nu_g", state.g_opt.nu), ("mu_d", state.d_opt.mu),
                    ("nu_d", state.d_opt.nu), ("ema_p", state.g_params_ema),
                    ("ema_s", state.g_stats_ema)):
        for k, v in d.items():
            out[f"{name}.{k}"] = v
    return out


def _half_batch(real):
    """A dispatch that leaves half of the real batch out: the batch axis
    of a macro-step's (per_step, B, H, W, C) or a dispatch's (K, per_step,
    B, H, W, C)."""
    def build(*a, **kw):
        step = real(*a, **kw)
        return lambda state, batch: step(state, batch[..., : batch.shape[-4] // 2, :, :, :])
    return build


def _k_fault(broken_multi):
    """A dispatch whose K-macro-step form alone is broken: the dispatch of
    one, which the checked steps read, stays sound."""
    def fault(real):
        def build(cfg, dsteps, gsteps, steps_per_dispatch=1, **kw):
            step = real(cfg, dsteps, gsteps, steps_per_dispatch=1, **kw)
            if steps_per_dispatch == 1:
                return step
            return lambda state, batch: broken_multi(step, state, batch)
        return build
    return fault


def _stale_batch(step, state, batch):
    """Every macro-step of the dispatch on its first batch."""
    for _ in batch:
        state, m = step(state, batch[0])
    return state, m


def _dropped_update(step, state, batch):
    """The dispatch's last macro-step left out."""
    for real in batch[:-1]:
        state, m = step(state, real)
    return state, m


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _k_fault(_stale_batch),
                                   _k_fault(_dropped_update)],
                         ids=["unchanged", "half_batch", "stale_batch", "dropped_update"])
def test_train_faults_are_caught(monkeypatch, fault):
    import smmdax_torch.train as train
    monkeypatch.setattr(train, "dispatch_train_step", fault(train.dispatch_train_step))
    assert _drive(TRAIN_CELL, train_config())["result"]["correct"] is False


def _half_samples(module):
    real = module.gaussian_stats
    return "gaussian_stats", lambda f: real(f[: len(f) // 2])


def _altered_fid(module):
    real = module.frechet_distance
    return "frechet_distance", lambda *a: 1.01 * real(*a)


def _altered_image(module):
    real = module.sample

    def broken(*a, **kw):
        out = real(*a, **kw)
        out[0] = -out[0]
        return out
    return "sample", broken


def _live_weights(module):
    real = module.sample
    return "sample", lambda *a, **kw: real(*a, **{**kw, "use_ema": False})


@pytest.mark.parametrize("fault,where", [(_half_samples, "smmdax_torch.eval"),
                                         (_altered_fid, "smmdax_torch.eval"),
                                         (_altered_image, "smmdax_torch.train"),
                                         (_live_weights, "smmdax_torch.train")],
                         ids=["half_samples", "altered_fid", "altered_image", "live_weights"])
def test_score_faults_are_caught(monkeypatch, fault, where):
    import importlib
    module = importlib.import_module(where)
    name, broken = fault(module)
    monkeypatch.setattr(module, name, broken)
    assert _drive(SCORE_CELL, score_config())["result"]["correct"] is False
