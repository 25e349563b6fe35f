"""Write the manifest that the port's JPEG encoder and asset tool are held to.

    python tests/fixtures/port_jpeg_encode/make_fixtures.py [--cases_only]

Needs PIL and the JAX package's ``tools/make_assets.py``.  ``manifest.json``
holds hashes only, no images, so that a machine without PIL (the one with
the card) can hold the port to PIL's bytes:

* ``cases``: for each encoder case, an (H, W, 3) uint8 image made by
  ``case_image`` (a ``make_assets`` field ``_proc_image`` drawn from
  ``np.random.default_rng(seed)``, or a flat, saturated, 0/255
  checkerboard or uniform-noise field from that seed) and a quality, the
  SHA-256 of PIL's ``Image.fromarray(img).save(buf, format="JPEG",
  quality=quality)``;
* ``assets``: the JAX tool's per-format digests
  (``smmdax_torch.tools.make_assets.asset_digests``) at the counts that
  ``chip_smoke.py`` phase 14 uses: ``whole`` (the whole script: CIFAR-10 at
  its 50,000, the other formats cut) and ``defaults`` (``--only assets``:
  every default of the tool).

``case_image`` takes the ``_proc_image`` to use, so the port (on the card)
and the JAX tool (here) draw the same fields.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# (kind, seed, h, w, quality): the asset geometries first, then every
# quality-scaling branch (1-24 clamp to 255, 25, 50, 100 all ones), sizes
# off the 8 / 16 grid (dummy blocks right and below), extreme fields
CASES = [
    ("proc", 102, 218, 178, 88), ("proc", 103, 256, 256, 85),
    ("proc", 1, 1, 1, 75), ("proc", 2, 7, 9, 50), ("proc", 3, 17, 15, 95),
    ("proc", 4, 33, 31, 100), ("proc", 5, 64, 64, 10), ("proc", 6, 16, 16, 1),
    ("proc", 7, 8, 8, 24), ("proc", 8, 13, 40, 25), ("proc", 9, 32, 32, 88),
    ("proc", 10, 120, 90, 85), ("proc", 11, 28, 28, 75),
    ("flat", 12, 16, 16, 75), ("flat", 13, 33, 31, 100), ("flat", 14, 218, 178, 88),
    ("saturated", 15, 64, 64, 88), ("saturated", 16, 31, 33, 1),
    ("saturated", 17, 256, 256, 85),
    ("checker", 18, 16, 16, 100), ("checker", 19, 17, 15, 50),
    ("checker", 20, 218, 178, 88),
    ("noise", 21, 64, 64, 100), ("noise", 22, 9, 7, 85), ("noise", 23, 218, 178, 88),
    ("noise", 24, 256, 256, 85),
]

# make_assets counts of chip_smoke.py phase 14: the whole script, and --only
# assets; CelebA at a multiple of 2,500, so that the tool prints its last line
ASSET_COUNTS = {
    "whole": dict(cifar_n=50_000, celeba_n=2_500, lsun_n=512, imagenet_n=1_000, mnist_n=1_000),
    "defaults": dict(cifar_n=50_000, celeba_n=10_000, lsun_n=10_000, imagenet_n=50_000,
                     mnist_n=10_000),
}


def case_image(kind: str, seed: int, h: int, w: int, proc_image) -> np.ndarray:
    """The (h, w, 3) uint8 image of one encoder case."""
    rng = np.random.default_rng(seed)
    if kind == "proc":
        return proc_image(rng, h, w)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3).astype(np.uint8), (h, w, 3)).copy()
    if kind == "saturated":
        return (rng.integers(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    if kind == "checker":
        board = ((np.arange(h)[:, None] + np.arange(w)[None, :]) & 1) * 255
        return np.repeat(board[..., None], 3, axis=2).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    raise ValueError(kind)


def case_name(kind: str, seed: int, h: int, w: int, quality: int) -> str:
    return f"{kind}_{seed}_{w}x{h}_q{quality}"


def counts_argv(counts: dict) -> list:
    return [a for k, v in counts.items() for a in (f"--{k}", str(v))]


def pil_jpeg(img: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases_only", action="store_true",
                    help="keep the manifest's asset digests, recompute the cases")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_assets as jax_tool  # noqa: E402
    from PIL import __version__ as pil_version, features  # noqa: E402

    from smmdax_torch.tools.make_assets import asset_digests  # noqa: E402

    path = os.path.join(HERE, "manifest.json")
    cases = []
    for kind, seed, h, w, q in CASES:
        data = pil_jpeg(case_image(kind, seed, h, w, jax_tool._proc_image), q)
        cases.append(dict(name=case_name(kind, seed, h, w, q), kind=kind, seed=seed, h=h, w=w,
                          quality=q, bytes=len(data), sha256=hashlib.sha256(data).hexdigest()))
    if args.cases_only:
        with open(path) as f:
            assets = json.load(f)["assets"]
    else:
        assets = {}
        for label, counts in ASSET_COUNTS.items():
            with tempfile.TemporaryDirectory() as out:
                t0 = time.time()
                jax_tool.main(["--out", out] + counts_argv(counts))
                assets[label] = dict(counts=counts, digests=asset_digests(out))
                print(f"{label}: {time.time() - t0:.1f} s", flush=True)
    manifest = dict(generator=f"Pillow {pil_version}, libjpeg-turbo "
                              f"{features.version('libjpeg_turbo')}; tools/make_assets.py",
                    cases=cases, assets=assets)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(f"{len(cases)} cases, assets {sorted(assets)} -> {path}")


if __name__ == "__main__":
    main()
