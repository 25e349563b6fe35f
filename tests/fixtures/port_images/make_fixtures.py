"""Write the JPEG fixtures of the port's image decoder and their manifest.

    python tests/fixtures/port_images/make_fixtures.py

Needs PIL (and numpy).  The images are ``tools/make_assets.py``'s
procedural fields (``_proc_image``), encoded by PIL in the layouts the
port's decoder reads (CelebA's 178x218 at quality 75 4:2:0, LSUN's
256x256 at quality 85, 4:2:2, 4:4:4, grey, odd sizes, restart intervals,
optimized Huffman tables) and two it refuses (progressive, CMYK).
``manifest.json`` records, for each file, the SHA-256 of PIL's decoded
RGB bytes and of the JAX package's ``center_crop_resize`` of them at 160
(crop 160, CelebA's) and at 64 (the shorter side, LSUN's), so that a
machine without PIL can hold the port to PIL's bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

# name, (h, w), PIL save options, grey; "refuse" files must raise
FIXTURES = [
    ("celeba_0.jpg", (218, 178), dict(quality=75, subsampling=2), False),
    ("celeba_1.jpg", (218, 178), dict(quality=75, subsampling=2), False),
    ("celeba_2.jpg", (218, 178), dict(quality=75, subsampling=2), False),
    ("lsun_0.jpg", (256, 256), dict(quality=85), False),
    ("lsun_1.jpg", (256, 256), dict(quality=85), False),
    ("s422_61x47.jpg", (47, 61), dict(quality=90, subsampling=1), False),
    ("s444_53x37.jpg", (37, 53), dict(quality=95, subsampling=0), False),
    ("grey_45x33.jpg", (33, 45), dict(quality=80), True),
    ("odd_1x1.jpg", (1, 1), dict(quality=75), False),
    ("odd_13x7.jpg", (7, 13), dict(quality=60), False),
    ("odd_9x17.jpg", (17, 9), dict(quality=30, subsampling=1), False),
    ("restart_blocks_56x40.jpg", (40, 56), dict(quality=85, restart_marker_blocks=2), False),
    ("restart_rows_70x35.jpg", (35, 70), dict(quality=70, subsampling=1,
                                              restart_marker_rows=1), False),
    ("optimized_33x29.jpg", (29, 33), dict(quality=85, optimize=True), False),
    ("q100_24x24.jpg", (24, 24), dict(quality=100, subsampling=0), False),
    ("q10_30x30.jpg", (30, 30), dict(quality=10), False),
    ("refuse_progressive.jpg", (16, 16), dict(quality=75, progressive=True), False),
    ("refuse_cmyk.jpg", (16, 16), dict(quality=75), False),
]


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_hashes(data: bytes) -> dict:
    """PIL's decoded RGB bytes and the JAX package's crops of them."""
    from PIL import Image

    sys.path.insert(0, ROOT)
    from smmdax.data.pipeline import center_crop_resize
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return dict(width=img.size[0], height=img.size[1], rgb_sha256=sha(np.asarray(img)),
                crop160_sha256=sha(np.asarray(center_crop_resize(img, 160, crop=160))),
                crop64_sha256=sha(np.asarray(center_crop_resize(img, 64))))


def main() -> None:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from tools.make_assets import _proc_image
    rng = np.random.default_rng(909)
    entries = []
    for name, (h, w), opts, grey in FIXTURES:
        img = Image.fromarray(_proc_image(rng, h, w))
        if grey:
            img = img.convert("L")
        if name == "refuse_cmyk.jpg":
            img = img.convert("CMYK")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        entry = dict(name=name, options=opts)
        if name.startswith("refuse_"):
            entry["refuse"] = "NotImplementedError"
        else:
            entry.update(pil_hashes(data))
        entries.append(entry)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"generator": "tests/fixtures/port_images/make_fixtures.py",
                   "files": entries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
