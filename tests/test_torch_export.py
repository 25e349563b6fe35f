"""The port's generator export (``python -m smmdax_torch.export``) against
``tools/export_generator.py``: on the tiny flagship on the CPU the saved
and loaded program reproduces ``sample`` on the same z bit for bit (the
EMA pair as its weights), its metadata has JAX's keys and values, and the
CLI refuses what JAX's refuses."""

import json
import os
import sys

import pytest
import torch

from smmdax_torch import export as texport
from smmdax_torch.checkpoint import CheckpointManager
from smmdax_torch.configs import config_from_args
from smmdax_torch.train import create_state, sample
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = ["--model", "sn-smmd", "--kernel", "rq", "--architecture", "resnet",
        "--dataset", "synthetic", "--output_size", "32", "--gf_dim", "8", "--df_dim", "8",
        "--dof_dim", "4", "--z_dim", "8", "--batch_size", "8", "--real_batch_size", "8",
        "--ema_decay", "0.9"]


def _state(cfg, shift: float):
    """A state whose EMA pair differs from the live weights and statistics."""
    state = create_state(cfg, seed=cfg.random_seed, device="cpu")
    for i, t in enumerate(list(state.g_params_ema.values()) + list(state.g_stats_ema.values())):
        if t.is_floating_point():
            t.add_(shift * (1 + i % 3))
    return state


def _latents(cfg, n: int):
    g = torch.Generator().manual_seed(5)
    return g, torch.rand((n, cfg.z_dim), generator=torch.Generator().manual_seed(5)) * 2.0 - 1.0


def test_saved_program_reproduces_sample(tmp_path):
    cfg = config_from_args(TINY)
    state = _state(cfg, 0.01)
    path = str(tmp_path / "gen.pt2")
    torch.export.save(texport.export_generator(cfg, state, batch=8), path)
    gen = texport.load_generator(path)
    g, z = _latents(cfg, 8)
    want = sample(cfg, state, g, 8)
    got = gen(z)
    assert got.shape == (8, 32, 32, 3) and got.dtype == torch.float32
    assert torch.equal(got, want)
    # the EMA pair, not the live weights
    assert not torch.equal(got, sample(cfg, state, _latents(cfg, 8)[0], 8, use_ema=False))


def test_meta_equals_jax(tmp_path, capsys):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import export_generator as jexport
    flags = TINY + ["--checkpoint_dir", str(tmp_path / "missing"), "--allow_untrained",
                    "--batch", "4"]
    jexport.main(flags + ["--out", str(tmp_path / "jax.shlo")])
    texport.main(flags + ["--out", str(tmp_path / "gen.pt2"), "--device", "cpu"])
    assert "UNTRAINED" in capsys.readouterr().out
    with open(tmp_path / "jax.shlo.json") as f:
        want = json.load(f)
    with open(tmp_path / "gen.pt2.json") as f:
        got = json.load(f)
    assert got == want == dict(want, platforms=["cpu"], batch=4, step=None, z_dim=8)
    out = texport.load_generator(str(tmp_path / "gen.pt2"))(torch.zeros(4, 8))
    assert out.shape == (4, 32, 32, 3) and bool(torch.isfinite(out).all())


def test_cli_restores_latest_or_best_and_refuses(tmp_path, capsys):
    cfg = config_from_args(TINY)
    run = tmp_path / "ck" / cfg.run_name()
    latest, best = _state(cfg, 0.01), _state(cfg, -0.02)
    latest.step, best.step = 6, 3
    mgr = CheckpointManager(str(run))
    mgr.save(6, latest)
    mgr.save_best(best, {"best_kid": 0.1, "best_step": 3})
    g, z = _latents(cfg, 8)
    for flag, state, step in (([], latest, 6), (["--use_best"], best, 3)):
        out = str(tmp_path / f"gen{len(flag)}.pt2")
        texport.main(TINY + ["--checkpoint_dir", str(tmp_path / "ck"), "--out", out,
                             "--batch", "8", "--device", "cpu"] + flag)
        assert f"checkpoint at step {step}" in capsys.readouterr().out
        with open(out + ".json") as f:
            assert json.load(f)["step"] == step
        want = sample(cfg, state, _latents(cfg, 8)[0], 8)
        assert torch.equal(texport.load_generator(out)(z), want)
    with pytest.raises(SystemExit, match="checkpoint directory not found"):
        texport.main(TINY + ["--checkpoint_dir", str(tmp_path / "nowhere"),
                             "--out", str(tmp_path / "x.pt2"), "--device", "cpu"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint under"):
        texport.main(TINY + ["--checkpoint_dir", str(tmp_path / "empty"),
                             "--out", str(tmp_path / "x.pt2"), "--device", "cpu"])
    assert not (tmp_path / "x.pt2").exists()
