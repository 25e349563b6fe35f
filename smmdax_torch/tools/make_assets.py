"""Synthesize full-size on-disk datasets in every real storage format.

The counterpart of the JAX package's ``tools/make_assets.py``, without PIL:
the same functions, flags, defaults, seeds (101-105), file names, record
keys and printed lines, and the same bytes.  No network reaches the real
CIFAR / CelebA / LSUN / ImageNet assets, so this writes byte-format stand-ins
at production volume, for the loaders to be proven on:

* ``cifar-10-batches-py/data_batch_1..5``: python pickles with the real
  dict layout ({b'data': (10000, 3072) uint8 CHW-flattened, b'labels':
  [...]}), 50k samples.
* ``celeba/*.jpg``: aligned-CelebA-shaped JPEGs (178x218, quality 88).
* ``lsun/bedroom_train_lmdb/data.mdb``: an LMDB environment (the port's
  ``write_lmdb``) of 256 px JPEG records at quality 85.
* ``imagenet64/*.npz``: Downsampled-ImageNet-style shards with a flattened
  CHW uint8 'data' array.
* ``mnist/train-images-idx3-ubyte``: the idx header and the rasters.

Images are procedural low-frequency fields (``_proc_image``: the upscale
is the port's ``resize_bilinear_pil``, PIL's bytes), deterministic per
index; the JPEGs come from the native encoder (``data.native.encode_jpeg``,
PIL's bytes), which runs on the host in a pool of threads.  A failed
build raises: nothing falls back to the plain encoder.

Usage: python -m smmdax_torch.tools.make_assets --out DIR \\
           [--cifar_n 50000] [--celeba_n 10000] [--lsun_n 10000]
           [--imagenet_n 50000] [--mnist_n 10000] [--only cifar,celeba,...]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import hashlib
import os
import pickle
import time

import numpy as np

from smmdax_torch.data import native
from smmdax_torch.data.image import resize_bilinear_pil
from smmdax_torch.data.lmdb_store import write_lmdb

FORMATS = ("cifar", "celeba", "lsun", "imagenet64", "mnist")
ENCODE_THREADS = 8
ENCODE_AHEAD = 64           # images drawn ahead of the encoding pool


def _proc_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Low-frequency random field + mild noise: photo-like enough that
    JPEG sizes are realistic (pure uint8 noise barely compresses)."""
    base = rng.integers(0, 256, (12, 12, 3), np.uint8)
    arr = resize_bilinear_pil(base, (w, h)).astype(np.int16)
    noise = rng.integers(-10, 11, arr.shape, dtype=np.int16)
    return np.clip(arr + noise, 0, 255).astype(np.uint8)


def _jpegs(rng: np.random.Generator, n: int, h: int, w: int, quality: int):
    """The JPEG bytes of ``n`` images drawn from ``rng`` in order.  The
    draws stay on this thread (one stream); the encodes run in a pool of
    threads meanwhile, at most ENCODE_AHEAD of them pending."""
    native.encode_library()              # built (or raising) before any draw
    pending = collections.deque()
    with cf.ThreadPoolExecutor(ENCODE_THREADS) as pool:
        for _ in range(n):
            pending.append(pool.submit(native.encode_jpeg, _proc_image(rng, h, w), quality))
            if len(pending) >= ENCODE_AHEAD:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def make_cifar(root: str, n: int) -> None:
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(101)
    per = n // 5
    for b in range(1, 6):
        imgs = np.stack([_proc_image(rng, 32, 32) for _ in range(per)])
        flat = imgs.transpose(0, 3, 1, 2).reshape(per, -1)   # CHW flattened
        with open(os.path.join(d, f"data_batch_{b}"), "wb") as f:
            pickle.dump({b"data": flat,
                         b"labels": rng.integers(0, 10, per).tolist()}, f)
        print(f"  cifar batch {b}/5 ({per} samples)", flush=True)


def make_celeba(root: str, n: int) -> None:
    d = os.path.join(root, "celeba")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(102)
    # the aligned CelebA geometry: 178x218 (w x h)
    for i, data in enumerate(_jpegs(rng, n, 218, 178, 88)):
        with open(os.path.join(d, f"{i:06d}.jpg"), "wb") as f:
            f.write(data)
        if (i + 1) % 2500 == 0:
            print(f"  celeba {i + 1}/{n} jpegs", flush=True)


def make_lsun(root: str, n: int, size: int = 256,
              category: str = "bedroom_train") -> None:
    env = os.path.join(root, "lsun", f"{category}_lmdb")
    rng = np.random.default_rng(103)
    # LSUN keys are opaque hashes; any sorted byte key works
    write_lmdb(env, ((f"{i:016x}".encode(), data)
                     for i, data in enumerate(_jpegs(rng, n, size, size, 85))))
    sz = os.path.getsize(os.path.join(env, "data.mdb")) / 1e6
    print(f"  lsun {n} records -> {env} ({sz:.0f} MB)", flush=True)


def make_imagenet64(root: str, n: int, shards: int = 5) -> None:
    d = os.path.join(root, "imagenet64")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(104)
    per = n // shards
    for s in range(shards):
        imgs = np.stack([_proc_image(rng, 64, 64) for _ in range(per)])
        flat = imgs.transpose(0, 3, 1, 2).reshape(per, -1)   # CHW flattened
        np.savez(os.path.join(d, f"train_data_batch_{s + 1}.npz"), data=flat)
        print(f"  imagenet64 shard {s + 1}/{shards} ({per} samples)",
              flush=True)


def make_mnist(root: str, n: int = 10000) -> None:
    d = os.path.join(root, "mnist")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(105)
    imgs = np.stack([_proc_image(rng, 28, 28)[..., 0] for _ in range(n)])
    with open(os.path.join(d, "train-images-idx3-ubyte"), "wb") as f:
        f.write((2051).to_bytes(4, "big") + n.to_bytes(4, "big")
                + (28).to_bytes(4, "big") + (28).to_bytes(4, "big"))
        f.write(imgs.tobytes())
    print(f"  mnist {n} rasters", flush=True)


def _file_sha(path: str) -> bytes:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.digest()


def _array_sha(h, a) -> None:
    a = np.ascontiguousarray(a)
    h.update(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())


def asset_digests(root: str, formats=FORMATS) -> dict:
    """format -> SHA-256 (hex) of what was written under ``root``, for each
    of ``formats``: the JPEG files (names and bytes), ``data.mdb``
    and the idx file by their bytes; the pickles and npz shards by their
    arrays and labels, since their bytes depend on numpy's version."""
    out = {}
    for fmt in formats:
        h = hashlib.sha256()
        if fmt == "cifar":
            d = os.path.join(root, "cifar-10-batches-py")
            for b in range(1, 6):
                with open(os.path.join(d, f"data_batch_{b}"), "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                _array_sha(h, np.asarray(batch[b"data"], np.uint8))
                _array_sha(h, np.asarray(batch[b"labels"], np.int64))
        elif fmt == "celeba":
            d = os.path.join(root, "celeba")
            for name in sorted(os.listdir(d)):
                h.update(name.encode())
                h.update(_file_sha(os.path.join(d, name)))
        elif fmt == "lsun":
            h.update(_file_sha(os.path.join(root, "lsun", "bedroom_train_lmdb", "data.mdb")))
        elif fmt == "imagenet64":
            d = os.path.join(root, "imagenet64")
            for name in sorted(os.listdir(d)):
                h.update(name.encode())
                with np.load(os.path.join(d, name)) as z:
                    _array_sha(h, z["data"])
        elif fmt == "mnist":
            h.update(_file_sha(os.path.join(root, "mnist", "train-images-idx3-ubyte")))
        else:
            raise ValueError(f"unknown asset format {fmt!r}")
        out[fmt] = h.hexdigest()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cifar_n", type=int, default=50_000)
    ap.add_argument("--celeba_n", type=int, default=10_000)
    ap.add_argument("--lsun_n", type=int, default=10_000)
    ap.add_argument("--imagenet_n", type=int, default=50_000)
    ap.add_argument("--mnist_n", type=int, default=10_000)
    ap.add_argument("--only", default="",
                    help="comma list of cifar,celeba,lsun,imagenet64,mnist")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))

    def want(name):
        return not only or name in only

    t0 = time.time()
    os.makedirs(args.out, exist_ok=True)
    if want("cifar"):
        make_cifar(args.out, args.cifar_n)
    if want("celeba"):
        make_celeba(args.out, args.celeba_n)
    if want("lsun"):
        make_lsun(args.out, args.lsun_n)
    if want("imagenet64"):
        make_imagenet64(args.out, args.imagenet_n)
    if want("mnist"):
        make_mnist(args.out, args.mnist_n)
    print(f"assets under {args.out} in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
