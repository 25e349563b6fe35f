"""Standalone scoring CLI (port of ``compute_scores.py``):

  python -m smmdax_torch.compute_scores REAL FAKE [--extractor random_conv|inception]
  python -m smmdax_torch.compute_scores REAL FAKE --compare OTHER_FAKE

REAL/FAKE are .npy/.npz files of images (N,H,W,C in [-1,1] or uint8) or
of precomputed features (N,d, ndim==2), or directories of PNG/JPEG images
(decoded without PIL, to PIL's bytes, whatever the name says: a webp file
named .jpg is read as PIL reads it; mixed sizes are resized to the
modal size with PIL's bilinear filter, as ``compute_scores.py`` does).
Prints FID, KID (mean +- std) and, when class probabilities are
available, IS.

``--compare OTHER_FAKE`` also runs the Bounliphone et al. relative-MMD
three-sample test (the scheduler's decision rule) between the two
candidate sets against REAL: small p means FAKE is significantly closer to
REAL than OTHER_FAKE.

The extractor runs on ``--device`` (default ``cuda``; nothing falls back
to the CPU).  ``--score_backend auto`` scores on that device when it is a
card (float32 Gram blocks, float64 finish) and with the float64 numpy
oracle on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import os
from collections import Counter

import numpy as np
import torch


def _load(path: str) -> np.ndarray:
    if os.path.isdir(path):
        from smmdax_torch.data.image import decode_image, resize_bilinear_pil
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not files:
            raise FileNotFoundError(f"no images in {path}")
        imgs = []
        for f in files:
            with open(f, "rb") as fh:
                imgs.append(decode_image(fh.read()))
        sizes = {(im.shape[1], im.shape[0]) for im in imgs}     # PIL's (w, h)
        if len(sizes) > 1:
            # mixed resolutions: bilinear-resize everything to the modal
            # size (the extractor resizes to its own input size anyway;
            # this just makes the batch stackable)
            target = Counter((im.shape[1], im.shape[0]) for im in imgs).most_common(1)[0][0]
            print(f"[compute_scores] {path}: {len(sizes)} distinct "
                  f"image sizes; resizing all to {target[0]}x{target[1]}")
            imgs = [im if (im.shape[1], im.shape[0]) == target
                    else resize_bilinear_pil(im, target) for im in imgs]
        return np.stack([np.asarray(im, np.float32) / 127.5 - 1.0 for im in imgs])
    if path.endswith(".npz"):
        with np.load(path) as z:
            arr = z[list(z.keys())[0]]
    else:
        arr = np.load(path)
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 127.5 - 1.0
    return arr


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("real")
    p.add_argument("fake")
    p.add_argument("--extractor", default="auto",
                   choices=["auto", "random_conv", "inception"])
    p.add_argument("--fid_semantics", default="auto",
                   choices=["auto", "on", "off"],
                   help="frozen-TF-FID-graph pooling semantics for the "
                        "Inception extractor; auto = detect from the fc "
                        "width (1008 = FID weight port)")
    p.add_argument("--compare", default=None,
                   help="second candidate set: run the relative-MMD "
                        "three-sample test (FAKE vs COMPARE, against REAL)")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--subset_size", type=int, default=1000)
    p.add_argument("--n_subsets", type=int, default=50)
    p.add_argument("--compare_test_size", type=int, default=5000,
                   help="sample size m of the single --compare "
                        "relative-MMD hypothesis test (clamped to the "
                        "available samples)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--score_backend", default="auto",
                   choices=("auto", "numpy", "torch"),
                   help="where the subset-sweep Gram blocks run: auto = "
                        "torch on --device when it is a card, else the "
                        "float64 numpy oracle")
    p.add_argument("--device", default="cuda",
                   help="device of the extractor and of the torch score arm")
    args = p.parse_args(argv)

    from smmdax_torch.eval import (fid_from_features, get_feature_extractor,
                                   inception_score, kid_from_features)
    from smmdax_torch.eval.features import (InceptionFeatures, RandomConvFeatures,
                                            extract_with_probs, find_inception_weights)
    from smmdax_torch.eval.scores import relative_mmd_test, use_device_scoring
    from smmdax_torch.train import resolve_device

    device = resolve_device(args.device)
    backend = args.score_backend
    if backend == "auto":
        backend = "torch" if use_device_scoring(device) else "numpy"
    fetch = backend == "numpy"
    real, fake = _load(args.real), _load(args.fake)
    fid_sem = {"auto": None, "on": True, "off": False}[args.fid_semantics]

    # lazily built: precomputed-feature inputs must not require the
    # Inception weights asset (and must not pay a pointless net load)
    @functools.cache
    def extractor():
        if args.extractor == "inception":
            path = find_inception_weights(args.data_dir)
            return InceptionFeatures(
                path or os.path.join(args.data_dir, "inception_v3.pt"),
                fid_semantics=fid_sem, device=device)
        if args.extractor == "random_conv":
            return RandomConvFeatures(device=device)
        return get_feature_extractor(args.data_dir, fid_semantics=fid_sem, device=device)

    used = "precomputed"
    fake_probs = None

    def to_features(arr: np.ndarray, want_probs: bool = False):
        """Features as numpy for the numpy arm, as tensors on the device for
        the torch arm."""
        nonlocal used, fake_probs
        if arr.ndim == 2:          # already features
            feats = arr.astype(np.float32)
            return feats if fetch else torch.from_numpy(feats).to(device)
        ext = extractor()
        used = ext.name
        if want_probs:
            feats, fake_probs = extract_with_probs(ext, arr, fetch=fetch)  # one sweep
            return feats
        return ext(arr, fetch=fetch)

    fr = to_features(real)
    ff = to_features(fake, want_probs=True)
    fid = fid_from_features(fr, ff)
    kid, kid_std = kid_from_features(fr, ff,
                                     subset_size=min(args.subset_size, len(fr), len(ff)),
                                     n_subsets=args.n_subsets, backend=backend)
    print(f"FID: {fid:.4f}")
    print(f"KID: {kid:.6f} +- {kid_std:.6f}")
    if fake_probs is not None:
        is_mean, is_std = inception_score(fake_probs)
        print(f"IS: {is_mean:.4f} +- {is_std:.4f}")
    if args.compare:
        fo = to_features(_load(args.compare))
        # ONE large-m test, as the trainer's scheduler: its single asymptotic
        # p-value is calibrated, and p > 0.95 is "COMPARE significantly
        # closer at 0.05"
        p_val, t_stat = relative_mmd_test(
            fr, ff, fo,
            subset_size=min(args.compare_test_size, len(fr), len(ff), len(fo)),
            n_subsets=1, seed=args.seed, backend=backend)
        verdict = ("FAKE significantly closer" if p_val < 0.05
                   else "COMPARE significantly closer" if p_val > 0.95
                   else "inconclusive")
        print(f"relative-MMD test (FAKE closer than COMPARE?): "
              f"p={p_val:.4f} t={t_stat:.3f} ({verdict})")
    print(f"(extractor: {used}, n_real={len(fr)}, n_fake={len(ff)})")


if __name__ == "__main__":
    main()
