"""Dataset dispatch and the macro-batch iterator (port of
``smmdax/data/pipeline.py``).

Batches are numpy, keyed by (seed, step), drawn exactly as the JAX
package draws them, so both packages train on byte-identical batches.
The loaders read CIFAR-10 pickles, ImageNet-64 npz shards and TFRecord
shards, MNIST idx files, decode-once packed uint8 caches, LSUN LMDB
environments and CelebA-layout JPEG/PNG directories, in the JAX package's
order.  Images are decoded without PIL (``data/image.py``: the native JPEG
and webp decoders and PIL's bilinear resize, all byte-identical to PIL's).  Without
an asset the procedural ``SyntheticImages`` source with the same shapes
stands in, with a printed note, as in the JAX package; an asset that is
present but cannot be read raises.  ``gaussian_mix`` is the 1-D toy
(float32 samples, ``toy_dim`` ignored as in the JAX package).
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Protocol, Tuple

import numpy as np

from smmdax_torch import tracing
from smmdax_torch.configs import Config
from smmdax_torch.data.image import (DECODE_THREADS, DecodePool, center_crop_resize,
                                     decode_image)
from smmdax_torch.data.synthetic import GaussianMix, SyntheticImages

Array = np.ndarray

# (x - 127.5) * (1 / 127.5) in float32, the JAX package's native gather
_INV_127_5 = np.float32(1.0) / np.float32(127.5)


class DataSource(Protocol):
    sample_shape: Tuple[int, ...]

    def batch(self, n: int, key: Optional[int] = None) -> Array:
        """n samples; with ``key`` the batch is a pure function of
        (source seed, key), so a resumed run draws the same batches."""
        ...


class ArraySource:
    """In-memory dataset; shuffled minibatches in [-1, 1] (``batch``) or
    raw uint8 (``batch_u8``, the uint8-transfer path)."""

    def __init__(self, data: Array, seed: int = 0, flip: bool = False):
        self.data = data
        self.seed = seed
        self.flip = flip and data.ndim == 4
        self._rng = np.random.default_rng(seed)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return self.data.shape[1:]

    def _rng_for(self, key: Optional[int]) -> np.random.Generator:
        return self._rng if key is None else np.random.default_rng((self.seed, key))

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        """n samples, or the ``rows`` of them (every draw of the n is
        made, only those rows are built)."""
        rng = self._rng_for(key)
        idx = _rows(rng.integers(0, len(self.data), size=n), rows)
        if self.data.dtype == np.uint8:
            out = (self.data[idx].astype(np.float32) - np.float32(127.5)) * _INV_127_5
        else:
            out = self.data[idx]
        if self.flip:
            m = _rows(rng.integers(0, 2, size=n).astype(bool), rows)
            out = out.copy()
            out[m] = out[m][:, :, ::-1, :]
        return out

    def batch_u8(self, n: int, key: Optional[int] = None,
                 rows: Optional[Array] = None) -> Array:
        """Raw uint8 batch for on-device normalization; float data is
        quantized."""
        rng = self._rng_for(key)
        idx = _rows(rng.integers(0, len(self.data), size=n), rows)
        if self.data.dtype == np.uint8:
            out = self.data[idx]
        else:
            out = np.round((self.data[idx] + 1.0) * 127.5).astype(np.uint8)
        if self.flip:
            m = _rows(rng.integers(0, 2, size=n).astype(bool), rows)
            out = out.copy()
            out[m] = out[m][:, :, ::-1, :]
        return out


def _rows(a: Array, rows: Optional[Array]) -> Array:
    return a if rows is None else a[rows]


def _load_cifar10(data_dir: str) -> Optional[Array]:
    """CIFAR-10 python pickles (data_batch_1..5) -> (N,32,32,3) uint8."""
    root = os.path.join(data_dir, "cifar-10-batches-py")
    files = [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
    if not all(os.path.exists(f) for f in files):
        return None
    arrs = []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        arrs.append(np.asarray(d[b"data"], np.uint8))
    x = np.concatenate(arrs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x)


def _load_npz_images(data_dir: str, subdir: str, size: int) -> Optional[Array]:
    """ImageNet-64-style npz shards with a 'data' array of uint8 images."""
    root = os.path.join(data_dir, subdir)
    if not os.path.isdir(root):
        return None
    shards = sorted(f for f in os.listdir(root) if f.endswith(".npz"))
    if not shards:
        return None
    arrs = []
    for s in shards:
        with np.load(os.path.join(root, s)) as z:
            d = z["data"] if "data" in z else z[list(z.keys())[0]]
        if d.ndim == 2:      # flattened CHW
            d = d.reshape(-1, 3, size, size).transpose(0, 2, 3, 1)
        arrs.append(np.asarray(d, np.uint8))
    return np.concatenate(arrs)


def _decoder_pool(threads: int) -> DecodePool:
    """A decode pool, with the native decoders built (or raising) first:
    before any batch, a source that decodes has no other decoder to fall
    back to."""
    from smmdax_torch.data.native import library, webp_library
    library()
    webp_library()
    return DecodePool(threads)


def image_files(root: str) -> list:
    """The JPEG and PNG files of a directory, sorted."""
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.lower().endswith((".jpg", ".jpeg", ".png")))


class CelebASource:
    """JPEG/PNG directory -> center-crop -> resize to output_size, in
    [-1, 1] (``x / 127.5 - 1.0``, as the JAX package).  The drawn images
    are decoded per batch, in a pool of ``DECODE_THREADS``; the crop and
    resize match the reference's 160x160 CelebA pipeline (center-crop 160
    from the 178x218 aligned images).  Like the JAX package's, it has no
    ``batch_u8``."""

    def __init__(self, root: str, output_size: int = 160, crop: int = 160,
                 seed: int = 0):
        self.seed = seed
        self.root = root
        self.files = image_files(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root}")
        self.pool = _decoder_pool(DECODE_THREADS)
        self.output_size = output_size
        self.crop = crop
        self._rng = np.random.default_rng(seed)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return (self.output_size, self.output_size, 3)

    def decode_u8(self, i: int) -> Array:
        """File ``i`` -> (size, size, 3) uint8."""
        with open(self.files[i], "rb") as f:
            return center_crop_resize(decode_image(f.read()), self.output_size,
                                      crop=self.crop)

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        """n samples, or the ``rows`` of them (every draw is made, only
        those images are decoded)."""
        rng = self._rng if key is None else np.random.default_rng(
            (self.seed, key))
        idx = _rows(rng.integers(0, len(self.files), size=n), rows)
        u8 = self.pool.decode_into(self.decode_u8, idx.tolist(), np.empty(
            (len(idx), self.output_size, self.output_size, 3), np.uint8))
        return u8.astype(np.float32) / 127.5 - 1.0


class LSUNSource:
    """LSUN LMDB environment -> decode -> center-crop the shortest side ->
    resize to output_size, in [-1, 1].

    Reads the LMDB B+tree directly (``data/lmdb_store.py``); random access
    over the key index keeps batches a pure function of (seed, step).  The
    drawn records are decoded in a pool of ``decode_threads``.  webp
    values (the official LSUN LMDBs' encoding, lossy or lossless), JPEG
    and PNG are read, each to PIL's bytes.
    """

    def __init__(self, lmdb_path: str, output_size: int = 64, seed: int = 0,
                 decode_threads: int = DECODE_THREADS):
        from smmdax_torch.data.lmdb_store import LMDBReader
        self.reader = LMDBReader(lmdb_path)
        if len(self.reader) == 0:
            raise FileNotFoundError(f"empty LMDB at {lmdb_path}")
        self.pool = _decoder_pool(decode_threads)
        self.output_size = output_size
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return (self.output_size, self.output_size, 3)

    def decode_u8(self, i: int) -> Array:
        """One record -> (size, size, 3) uint8 (crop shortest side,
        bilinear resize), also the conversion tool's unit of work."""
        return center_crop_resize(decode_image(self.reader.value(i)), self.output_size)

    def _indices(self, n: int, key: Optional[int]) -> Array:
        rng = self._rng if key is None else np.random.default_rng(
            (self.seed, key))
        return rng.integers(0, len(self.reader), size=n)

    def batch_u8(self, n: int, key: Optional[int] = None,
                 rows: Optional[Array] = None) -> Array:
        idx = _rows(self._indices(n, key), rows)
        return self.pool.decode_into(self.decode_u8, idx.tolist(), np.empty(
            (len(idx), self.output_size, self.output_size, 3), np.uint8))

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        return self.batch_u8(n, key, rows).astype(np.float32) / 127.5 - 1.0


def _find_lsun_lmdb(root: str, category: str = "") -> Optional[str]:
    """data_dir/lsun may BE an environment, or contain one or more
    ``*_lmdb`` environment directories (the official LSUN layout).

    ``category`` selects the scene ("bedroom_train" matches
    ``bedroom_train_lmdb`` or an exact directory name).  With several
    environments present and no category this raises instead of
    silently training on an arbitrary scene."""
    if not os.path.isdir(root):
        return None
    if os.path.exists(os.path.join(root, "data.mdb")):
        return root
    envs = sorted(d for d in os.listdir(root)
                  if os.path.exists(os.path.join(root, d, "data.mdb")))
    if category:
        matches = [d for d in envs if d in (category, category + "_lmdb")]
        if not matches:
            raise FileNotFoundError(
                f"lsun_category={category!r} not found under {root}; "
                f"available environments: {envs}")
        chosen = matches[0]
    elif len(envs) > 1:
        raise ValueError(
            f"multiple LSUN environments under {root}: {envs}; select one "
            "with --lsun_category")
    elif envs:
        chosen = envs[0]
    else:
        return None
    print(f"[smmdax_torch.data] LSUN environment: {chosen}")
    return os.path.join(root, chosen)


def _try_tfrecords(cfg: Config, subdir: str):
    """TFRecord shards under data_dir/<subdir>."""
    root = os.path.join(cfg.data_dir, subdir)
    if not os.path.isdir(root):
        return None
    if not any(".tfrecord" in f for f in os.listdir(root)):
        return None
    from smmdax_torch.data.tfrecord import TFRecordSource
    crop = 160 if subdir == "celeba" else None
    return TFRecordSource(root, cfg.output_size, crop=crop,
                          seed=cfg.random_seed)


def make_dataset(cfg: Config) -> DataSource:
    ds = cfg.dataset
    if ds == "gaussian_mix":
        return GaussianMix(seed=cfg.random_seed)
    if ds == "synthetic":
        return SyntheticImages(cfg.output_size, cfg.c_dim, seed=cfg.random_seed)
    if ds == "cifar10":
        data = _load_cifar10(cfg.data_dir)
        if data is not None:
            return ArraySource(data, seed=cfg.random_seed)
    elif ds == "imagenet64":
        data = _load_npz_images(cfg.data_dir, "imagenet64", 64)
        if data is not None:
            return ArraySource(data, seed=cfg.random_seed)
        src = _try_tfrecords(cfg, "imagenet64")
        if src is not None:
            return src
    elif ds == "mnist":
        path = os.path.join(cfg.data_dir, "mnist", "train-images-idx3-ubyte")
        if os.path.exists(path):
            with open(path, "rb") as f:
                f.read(16)
                x = np.frombuffer(f.read(), np.uint8).reshape(-1, 28, 28, 1)
            return ArraySource(x.copy(), seed=cfg.random_seed)
    elif ds in ("lsun", "celeba"):
        # fastest first: a decode-once packed uint8 cache (memmapped; built
        # by ``python -m smmdax_torch.data.convert``).  With --lsun_category
        # set, ONLY the per-scene cache is accepted: the generic packed file
        # records no provenance and could have been built from another scene
        from smmdax_torch.data.convert import load_packed, packed_path
        category = cfg.lsun_category if ds == "lsun" else ""
        packed = load_packed(packed_path(cfg.data_dir, ds, cfg.output_size,
                                         category=category))
        if packed is not None:
            return ArraySource(packed, seed=cfg.random_seed)
        if category:
            generic = load_packed(
                packed_path(cfg.data_dir, ds, cfg.output_size))
            if generic is not None:
                print(f"[smmdax_torch.data] ignoring category-less packed cache "
                      f"(lsun_category={category!r} requested; repack with "
                      f"out={packed_path(cfg.data_dir, ds, cfg.output_size, category=category)!r})")
        if ds == "lsun":
            lmdb_env = _find_lsun_lmdb(os.path.join(cfg.data_dir, "lsun"),
                                       category=cfg.lsun_category)
            if lmdb_env is not None:
                return LSUNSource(lmdb_env, cfg.output_size,
                                  seed=cfg.random_seed)
        src = _try_tfrecords(cfg, ds)
        if src is not None:
            return src
        root = os.path.join(cfg.data_dir, ds)
        # a directory without images is no asset; one with images is read,
        # or raises (the decoder not built, a file not readable)
        if os.path.isdir(root) and image_files(root):
            # shortest-side crop (crop=None) for LSUN loose JPEGs, as the
            # LMDB / TFRecord / packed paths crop; CelebA's default is 160
            crop = None if ds == "lsun" else 160
            return CelebASource(root, cfg.output_size,
                                seed=cfg.random_seed, crop=crop)
    print(f"[smmdax_torch.data] assets for {ds!r} not found under {cfg.data_dir}; "
          "substituting the procedural synthetic source with matching shapes")
    return SyntheticImages(cfg.output_size, cfg.c_dim, seed=cfg.random_seed)


def macro_batch_at(source, step: int, per_step: int, batch: int,
                   u8: bool = False, block: Optional[Tuple[int, int]] = None) -> Array:
    """The (per_step, batch, ...) macro-batch of ``step``: float [-1, 1]
    from ``source.batch``, or uint8 from ``source.batch_u8`` (the
    trainer's uint8-transfer path), bit-identical to the JAX package's.
    ``block=(rank, ranks)``: that rank's (per_step, batch / ranks, ...)
    block, byte-identical to columns [rank * b, (rank + 1) * b) of the
    whole, with only those samples built.  One ``data.macro_batch`` span
    on the calling thread."""
    draw = source.batch_u8 if u8 else source.batch
    with tracing.span("data.macro_batch"):
        if block is None:
            flat = draw(per_step * batch, key=step)
            return flat.reshape((per_step, batch) + flat.shape[1:])
        rank, ranks = block
        b = batch // ranks
        rows = (np.arange(per_step)[:, None] * batch
                + np.arange(rank * b, (rank + 1) * b)[None, :]).ravel()
        flat = draw(per_step * batch, key=step, rows=rows)
        return flat.reshape((per_step, b) + flat.shape[1:])


def macro_batches(source: DataSource, per_step: int, batch: int,
                  start_step: int = 0) -> Iterator[Array]:
    """Yield (per_step, batch, *sample_shape) float arrays forever, keyed
    by step index (deterministic and resumable)."""
    step = start_step
    while True:
        yield macro_batch_at(source, step, per_step, batch)
        step += 1


# key of the device-resident pool draw: the trainer's step keys are step
# indices and scoring uses 2**31 + 1, so this draw collides with neither
_POOL_KEY = 2**31 + 2


def materialize_u8(source: DataSource, pool: int = 0,
                   block: Optional[Tuple[int, int]] = None) -> Optional[Array]:
    """The dataset as ONE uint8 (N, H, W, C) array: an in-memory source's
    backing array, or a fixed ``pool``-sample draw from a procedural
    source with ``batch_u8``; None when neither is possible.
    ``block=(rank, ranks)``: that rank's slice of the dataset cut to a
    multiple of ``ranks`` samples (equal slices, the remainder dropped),
    with only those samples of a procedural pool built."""
    if getattr(source, "flip", False):
        raise ValueError("data_placement=device cannot honor flip "
                         "augmentation (batches are gathered in-program "
                         "from the resident pool); disable one of them")
    def span(total: int) -> slice:
        if block is None:
            return slice(0, total)
        rank, ranks = block
        per = total // ranks
        return slice(rank * per, (rank + 1) * per)

    data = getattr(source, "data", None)
    if isinstance(data, np.ndarray) and data.ndim == 4:
        data = data[span(data.shape[0])]
        if data.dtype == np.uint8:
            return data
        return np.round((np.asarray(data) + 1.0) * 127.5).astype(np.uint8)
    if pool > 0 and hasattr(source, "batch_u8"):
        if block is None:
            return source.batch_u8(pool, key=_POOL_KEY)
        rows = span(pool)
        return source.batch_u8(pool, key=_POOL_KEY,
                               rows=np.arange(rows.start, rows.stop))
    return None
