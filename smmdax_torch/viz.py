"""GaussianMix toy visualisation (port of ``smmdax/viz.py``): per-interval
frames of the real and generated sample histograms with the critic's
witness function.

``witness_fn`` is numeric and equals the JAX package's.  ``plot_toy_frame``
keeps its contract: matplotlib is imported inside it, and without
matplotlib it draws nothing and returns None.  ``assemble_toy_animation``
stitches the frames into a GIF as the JAX package does with PIL, with the
port's own writer (``gif.py``: an adaptive palette per frame, LZW).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from smmdax_torch.configs import Config
from smmdax_torch.kernels import kernel_cross

Array = np.ndarray
Critic = Callable[[object], torch.Tensor]


def witness_fn(cfg: Config, critic: Critic, grid, f_real, f_fake) -> Array:
    """w(x) = E_fake k(phi(x), phi(fake)) - E_real k(phi(x), phi(real)) on
    the ``grid`` points.  ``critic`` maps samples (numpy or tensors) to
    features on its device; the feature sets are moved there."""
    with torch.no_grad():
        fx = critic(grid)
        kw = dict(rbf_sigmas=cfg.rbf_sigmas, rq_alphas=cfg.rq_alphas,
                  add_dot=cfg.kernel_add_dot)
        k_fake = kernel_cross(cfg.kernel, fx, torch.as_tensor(f_fake, device=fx.device), **kw)
        k_real = kernel_cross(cfg.kernel, fx, torch.as_tensor(f_real, device=fx.device), **kw)
        return (torch.mean(k_fake, dim=1) - torch.mean(k_real, dim=1)).cpu().numpy()


def plot_toy_frame(cfg: Config, critic: Critic, real, fake, step: int, out_dir: str,
                   lo: float = -1.3, hi: float = 1.3) -> Optional[str]:
    """One frame, ``out_dir/toy_<step>.png``: sample histograms and the
    witness curve.  Returns its path, or None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    real = np.asarray(real).reshape(len(real), -1)
    fake = np.asarray(fake).reshape(len(fake), -1)
    grid = np.linspace(lo, hi, 301, dtype=np.float32)[:, None]
    with torch.no_grad():
        w = witness_fn(cfg, critic, grid, critic(real), critic(fake))

    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.hist(real[:, 0], bins=60, range=(lo, hi), density=True, alpha=0.45,
             label="real")
    ax1.hist(fake[:, 0], bins=60, range=(lo, hi), density=True, alpha=0.45,
             label="generated")
    ax1.set_ylabel("density")
    ax1.legend(loc="upper left")
    ax2 = ax1.twinx()
    ax2.plot(grid[:, 0], w, lw=2, color="black", label="witness")
    ax2.set_ylabel("witness w(x)")
    ax2.legend(loc="upper right")
    ax1.set_title(f"{cfg.run_name()} — step {step}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"toy_{step:07d}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path


def assemble_toy_animation(out_dir: str, duration_ms: int = 200) -> Optional[str]:
    """Stitch the ``toy_*.png`` frames of ``out_dir``, in name order, into
    ``out_dir/toy_animation.gif`` (``duration_ms`` per frame, looping) and
    return its path; None when fewer than two frames exist.  The frames
    stay in ``out_dir``."""
    from smmdax_torch.gif import write_gif
    from smmdax_torch.utils import read_png
    if not os.path.isdir(out_dir):
        return None
    names = sorted(f for f in os.listdir(out_dir) if f.startswith("toy_") and f.endswith(".png"))
    if len(names) < 2:
        return None
    path = os.path.join(out_dir, "toy_animation.gif")
    write_gif(path, [read_png(os.path.join(out_dir, f)) for f in names], duration_ms)
    return path
