"""Decode-once dataset packing (port of ``smmdax/data/convert.py``).

Decoding per batch (CelebA directories, LSUN LMDBs) costs host time on
every macro-step.  The answer is the one the packed CIFAR/ImageNet-64
formats embody: decode, crop and resize ONCE into a packed uint8 array,
then train through ``ArraySource`` (uint8 transfer, O(1) random access via
memmap).  The ``.npy`` files are byte-identical to the JAX tool's.

    python -m smmdax_torch.data.convert lsun data/lsun/bedroom_train_lmdb \
        data/lsun/packed_64.npy --size 64
    python -m smmdax_torch.data.convert images data/celeba \
        data/celeba/packed_160.npy --size 160 --crop 160

``make_dataset`` picks the packed file up automatically:
``data_dir/lsun/packed_<output_size>.npy`` / ``data_dir/celeba/...``
(``packed_<category>_<size>.npy`` with ``--lsun_category``), memmapped.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


def pack_lsun(lmdb_path: str, out_path: str, size: int,
              limit: Optional[int] = None, threads: int = 8,
              log_every: int = 10_000) -> str:
    """LSUN LMDB environment -> packed (N, size, size, 3) uint8 .npy."""
    from smmdax_torch.data.pipeline import LSUNSource
    src = LSUNSource(lmdb_path, output_size=size, decode_threads=threads)
    n = len(src.reader) if limit is None else min(limit, len(src.reader))
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.uint8,
                                    shape=(n, size, size, 3))
    # chunked submission: Executor.map makes one future per item up front,
    # which at LSUN scale (~3M records) is GBs of bookkeeping
    chunk = max(threads * 64, 512)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        src.pool.decode_into(src.decode_u8, range(start, stop), out[start:stop])
        if log_every and (stop % log_every < chunk or stop == n):
            print(f"[smmdax_torch.convert] {stop}/{n}")
    out.flush()
    return out_path


def pack_image_dir(root: str, out_path: str, size: int,
                   crop: Optional[int] = None,
                   limit: Optional[int] = None,
                   log_every: int = 10_000) -> str:
    """JPEG/PNG directory (CelebA layout) -> packed uint8 .npy.

    ``crop``: center-crop side before resizing (the reference's CelebA
    pipeline crops 160 from the 178x218 aligned images); default crops
    the shortest side.
    """
    from smmdax_torch.data.image import center_crop_resize, decode_image
    from smmdax_torch.data.pipeline import image_files
    files = image_files(root)
    if not files:
        raise FileNotFoundError(f"no images under {root}")
    if limit is not None:
        files = files[:limit]
    out = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.uint8,
                                    shape=(len(files), size, size, 3))
    for i, path in enumerate(files):
        with open(path, "rb") as f:
            out[i] = center_crop_resize(decode_image(f.read()), size, crop=crop)
        if log_every and (i + 1) % log_every == 0:
            print(f"[smmdax_torch.convert] {i + 1}/{len(files)}")
    out.flush()
    return out_path


def packed_path(data_dir: str, dataset: str, size: int,
                category: str = "") -> str:
    """Default packed-cache location.  For LSUN with a category the
    cache is per-scene (``packed_bedroom_train_64.npy``) so a cache
    built from one scene can never silently serve another."""
    tag = f"packed_{category}_{size}.npy" if category else f"packed_{size}.npy"
    return os.path.join(data_dir, dataset, tag)


def load_packed(path: str) -> Optional[np.ndarray]:
    """Memmap a packed uint8 array if present and well-formed."""
    if not os.path.exists(path):
        return None
    arr = np.load(path, mmap_mode="r")
    if arr.dtype != np.uint8 or arr.ndim != 4:
        print(f"[smmdax_torch.convert] ignoring malformed packed file {path} "
              f"(dtype={arr.dtype}, ndim={arr.ndim})")
        return None
    return arr


def main(argv=None) -> None:
    p = argparse.ArgumentParser("smmdax_torch.data.convert", description=__doc__)
    p.add_argument("kind", choices=["lsun", "images"])
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--threads", type=int, default=8)
    a = p.parse_args(argv)
    if a.kind == "lsun":
        pack_lsun(a.src, a.out, a.size, limit=a.limit, threads=a.threads)
    else:
        pack_image_dir(a.src, a.out, a.size, crop=a.crop, limit=a.limit)
    print(f"[smmdax_torch.convert] wrote {a.out}")


if __name__ == "__main__":
    main()
