"""Command line of the port (counterpart of the JAX package's ``main.py``):
the same flags, plus ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU, and without a card nothing falls back to it).

  python -m smmdax_torch.main --is_train true --dataset cifar10 \\
      --architecture resnet --model sn-smmd --kernel rq ...
  python -m smmdax_torch.main --is_train false --visualize true ...   # sample

Training over several ranks is one command, as the JAX package's:
``--num_data_shards N`` starts N rank processes, one per card (``cuda:r``,
NCCL), joined over a FileStore in a directory the launcher makes; with
``--device cpu`` the ranks are gloo processes on the CPU.  It refuses more
ranks than cards.  If a rank fails, the launcher kills the others and
exits non-zero with that rank's traceback; if every rank exits with the
RSS watchdog's restart code, it starts the group again, which resumes
from the checkpoint just written.  SIGTERM / SIGINT to the launcher reach
every rank (each checkpoints at the same step and stops).
"""

from __future__ import annotations

import os
import signal
import sys
from typing import List

import numpy as np
import torch

from smmdax_torch.configs import Config, build_argparser, config_from_namespace


def main(argv=None) -> None:
    parser = build_argparser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fallback to the CPU")
    ns = parser.parse_args(argv)
    cfg = config_from_namespace(ns)

    if cfg.is_train:
        if cfg.num_data_shards > 1:
            code = launch(cfg, ns.device)
            if code:
                raise SystemExit(code)
            return
        from smmdax_torch.trainer import train
        train(cfg, device=ns.device)
        return

    # sampling / visualization path
    from smmdax_torch.checkpoint import CheckpointManager
    from smmdax_torch.train import create_state, interpolate, sample
    from smmdax_torch.utils import save_images

    state = create_state(cfg, seed=cfg.random_seed, device=ns.device)
    dev = state.device
    ckpt = CheckpointManager(os.path.join(cfg.checkpoint_dir, cfg.run_name()))
    if ckpt.restore(state) is None:
        print(f"[smmdax_torch] no checkpoint under {cfg.checkpoint_dir}; "
              "sampling from random init")

    n = 64 if cfg.visualize else min(cfg.no_of_samples, 1024)
    imgs = sample(cfg, state, torch.Generator(device=dev).manual_seed(cfg.random_seed), n)
    imgs_np = imgs.cpu().numpy()
    out = os.path.join(cfg.sample_dir, cfg.run_name())
    os.makedirs(out, exist_ok=True)
    if cfg.dataset == "gaussian_mix":
        # the toy's samples are 1-D points, not images
        np.save(os.path.join(out, "samples.npy"), imgs_np)
        print(f"[smmdax_torch] wrote {imgs_np.shape} samples to {out}/samples.npy")
    else:
        save_images(imgs_np[:64], os.path.join(out, "samples.png"))
        np.save(os.path.join(out, "samples.npy"), imgs_np)
        print(f"[smmdax_torch] wrote {n} samples to {out}")
        if cfg.visualize:
            # latent interpolation grid: each row walks z between two endpoints
            grid = interpolate(cfg, state,
                               torch.Generator(device=dev).manual_seed(cfg.random_seed + 1),
                               rows=8, cols=8)
            save_images(grid.cpu().numpy(), os.path.join(out, "interpolation.png"), nrow=8)
            print(f"[smmdax_torch] wrote latent interpolation grid to {out}")

    if cfg.compute_scores:
        from smmdax_torch.data import make_dataset
        from smmdax_torch.eval import (extract_features, extract_with_probs,
                                       fid_from_features, get_feature_extractor,
                                       inception_score, kid_from_features,
                                       use_device_scoring)
        extractor = get_feature_extractor(cfg.data_dir, device=dev)
        real = make_dataset(cfg).batch(min(cfg.no_of_samples, 5000))
        # on the card the features stay there (the torch arm scores them)
        fetch = not use_device_scoring(dev)
        fr = extract_features(extractor, real, fetch=fetch)
        ff, probs = extract_with_probs(extractor, imgs, fetch=fetch)
        fid = fid_from_features(fr, ff)
        kid, kid_std = kid_from_features(fr, ff, subset_size=min(1000, len(ff)))
        line = (f"[smmdax_torch] FID={fid:.3f} KID={kid:.5f} (+-{kid_std:.5f}) "
                f"[extractor={extractor.name}]")
        if probs is not None:
            is_mean, is_std = inception_score(probs)
            line += f" IS={is_mean:.3f} (+-{is_std:.3f})"
        print(line)


def launch(cfg: Config, device="cuda") -> int:
    """Train ``cfg`` on ``cfg.num_data_shards`` rank processes; returns the
    exit code of the group (0 when every rank finished)."""
    from smmdax_torch.train import check_devices
    from smmdax_torch.trainer import RESTART_EXIT_CODE
    check_devices(cfg, device)
    world = cfg.num_data_shards
    while True:
        codes = _run_group(cfg, device, world)
        if all(c == RESTART_EXIT_CODE for c in codes):
            print("[smmdax_torch] restarting the group of ranks", flush=True)
            continue
        if all(c == 0 for c in codes):
            return 0
        # a rank's own exit code, or 1 for one killed by a signal
        return next((c for c in codes if c not in (0, RESTART_EXIT_CODE) and c > 0), 1)


def _run_group(cfg: Config, device, world: int) -> List[int]:
    """One start of the group: the ranks' exit codes.  A rank that fails
    (any code but 0 or the restart code) has the others killed, and its
    traceback printed."""
    from smmdax_torch.parallel.launch import RankFailed, RankGroup
    from smmdax_torch.trainer import RESTART_EXIT_CODE
    with RankGroup(_train_rank, world, device, [(cfg,)] * world) as group:
        def forward(signum, frame):
            group.signal(signum)

        try:
            old = [signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)]
        except ValueError:           # not the main thread
            old = None
        try:
            group.start()
            return group.wait(ok_codes=(0, RESTART_EXIT_CODE))
        except RankFailed as e:
            print(f"[smmdax_torch] {e}", file=sys.stderr, flush=True)
            return e.codes
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old[0])
                signal.signal(signal.SIGINT, old[1])


def _train_rank(axis, cfg: Config) -> None:
    """One rank: train on its axis."""
    from smmdax_torch.trainer import Trainer
    Trainer(cfg, device=axis.device, axis=axis).train()


if __name__ == "__main__":
    main()
