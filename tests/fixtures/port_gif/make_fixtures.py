"""Write the toy frames of the port's GIF writer and its manifest.

    PYTHONPATH=. python tests/fixtures/port_gif/make_fixtures.py

Needs matplotlib.  Three frames of the GaussianMix toy (histograms of real
and generated samples with a witness curve), drawn by the port's
``plot_toy_frame`` with a fixed linear critic, so that a machine without
matplotlib (the one with the card) can stitch real frames.
``manifest.json`` records the SHA-256 of the GIF that the port's
``assemble_toy_animation`` makes of them; ``tests/test_torch_gif.py``
checks it here and ``chip_smoke.py`` on the card's host.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
STEPS = (100, 200, 300)


def draw(out_dir: str) -> list:
    """The frames, ``out_dir/toy_<step>.png``; their paths."""
    import torch
    from smmdax_torch.configs import Config
    from smmdax_torch.viz import plot_toy_frame
    cfg = Config(dataset="gaussian_mix", architecture="mlp", model="mmd", kernel="gaussian",
                 rbf_sigmas=(0.1, 0.25, 0.5, 1.0), z_dim=8, dof_dim=8)
    w = torch.full((1, 4), 0.5)
    critic = lambda x: torch.as_tensor(x).reshape(len(x), -1) @ w   # noqa: E731
    rng = np.random.default_rng(10)
    real = rng.normal(0, 0.3, (512, 1)).astype(np.float32)
    paths = []
    for i, step in enumerate(STEPS):
        fake = rng.normal(0.6 - 0.25 * i, 0.3, (512, 1)).astype(np.float32)
        paths.append(plot_toy_frame(cfg, critic, real, fake, step, out_dir))
    return paths


def gif_sha256(frames_dir: str) -> str:
    """SHA-256 of the port's GIF of the frames (made in a scratch copy)."""
    from smmdax_torch.viz import assemble_toy_animation
    with tempfile.TemporaryDirectory() as tmp:
        for f in os.listdir(frames_dir):
            if f.startswith("toy_") and f.endswith(".png"):
                shutil.copy(os.path.join(frames_dir, f), tmp)
        with open(assemble_toy_animation(tmp), "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()


def main() -> None:
    sys.path.insert(0, ROOT)
    for f in os.listdir(HERE):
        if f.endswith(".png"):
            os.remove(os.path.join(HERE, f))
    draw(HERE)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_gif/make_fixtures.py",
                   "frames": sorted(p for p in os.listdir(HERE) if p.endswith(".png")),
                   "duration_ms": 200, "gif_sha256": gif_sha256(HERE)}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
