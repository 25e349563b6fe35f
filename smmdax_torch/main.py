"""Command line of the port (counterpart of the JAX package's ``main.py``):
the same flags, plus ``--device`` (default ``cuda``; ``cpu`` runs on the
CPU, and without a card nothing falls back to it).

  python -m smmdax_torch.main --is_train true --dataset cifar10 \\
      --architecture resnet --model sn-smmd --kernel rq ...
  python -m smmdax_torch.main --is_train false --visualize true ...   # sample
"""

from __future__ import annotations

import os

import numpy as np
import torch

from smmdax_torch.configs import build_argparser, config_from_namespace


def main(argv=None) -> None:
    parser = build_argparser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fallback to the CPU")
    ns = parser.parse_args(argv)
    cfg = config_from_namespace(ns)

    if cfg.is_train:
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


if __name__ == "__main__":
    main()
