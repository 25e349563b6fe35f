"""The port's command line (``python -m smmdax_torch.main``): training and
resuming on the CPU with ``--device cpu``, sampling with the latent
interpolation grid and in-loop-style scores, and no fallback to the CPU
without a card."""

import os

import numpy as np
import pytest
import torch

from smmdax_torch.main import main
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = ["--dataset", "synthetic", "--architecture", "resnet", "--model", "mmd",
        "--gf_dim", "8", "--df_dim", "8", "--dof_dim", "4", "--z_dim", "8",
        "--batch_size", "8", "--real_batch_size", "8", "--dsteps", "1",
        "--warmup_iterations", "1", "--log_every", "2", "--sample_every", "0"]


def _dirs(tmp):
    return ["--checkpoint_dir", str(tmp / "ck"), "--sample_dir", str(tmp / "s"),
            "--log_dir", str(tmp / "l")]


def test_train_then_sample_and_visualize(tmp_path, capsys):
    main(["--is_train", "true", "--device", "cpu", "--max_iteration", "2",
          "--checkpoint_every", "2"] + TINY + _dirs(tmp_path))
    run = "synthetic_resnet_mmd_rq_b8"
    assert os.listdir(tmp_path / "ck" / run) == ["2.pt"]
    main(["--is_train", "false", "--visualize", "true", "--device", "cpu",
          "--compute_scores", "true", "--no_of_samples", "64"] + TINY + _dirs(tmp_path))
    out = tmp_path / "s" / run
    assert sorted(os.listdir(out)) == ["interpolation.png", "samples.npy", "samples.png"]
    imgs = np.load(out / "samples.npy")
    assert imgs.shape == (64, 32, 32, 3) and np.abs(imgs).max() <= 1.0
    for png in ("samples.png", "interpolation.png"):
        assert (out / png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    text = capsys.readouterr().out
    assert "sampling from random init" not in text
    assert "FID=" in text and "[extractor=random_conv]" in text


def test_sampling_without_checkpoint(tmp_path, capsys):
    main(["--is_train", "false", "--device", "cpu", "--no_of_samples", "20"]
         + TINY + _dirs(tmp_path))
    assert "sampling from random init" in capsys.readouterr().out
    assert np.load(tmp_path / "s" / "synthetic_resnet_mmd_rq_b8" / "samples.npy").shape[0] == 20


def test_no_cpu_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("true", "false"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--is_train", mode, "--max_iteration", "1"] + TINY + _dirs(tmp_path))
