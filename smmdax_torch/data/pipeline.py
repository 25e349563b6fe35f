"""Dataset dispatch and the macro-batch iterator (port of
``smmdax/data/pipeline.py``).

Batches are numpy, keyed by (seed, step), drawn exactly as the JAX
package draws them, so both packages train on byte-identical batches.
The loaders read CIFAR-10 pickles, ImageNet-64 npz shards and MNIST idx
files; without an asset the procedural ``SyntheticImages`` source with
the same shapes stands in, with a printed note, as in the JAX package.
The decoders of CelebA / LSUN images, LMDB environments, TFRecord shards
and packed caches are not ported (ROADMAP A.14): when such an asset is
present, ``make_dataset`` raises rather than train on synthetic data.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Protocol, Tuple

import numpy as np

from smmdax_torch.configs import Config
from smmdax_torch.data.synthetic import SyntheticImages

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

    def batch(self, n: int, key: Optional[int] = None) -> Array:
        rng = self._rng_for(key)
        idx = rng.integers(0, len(self.data), size=n)
        if self.data.dtype == np.uint8:
            out = (self.data[idx].astype(np.float32) - np.float32(127.5)) * _INV_127_5
        else:
            out = self.data[idx]
        if self.flip:
            m = rng.integers(0, 2, size=n).astype(bool)
            out = out.copy()
            out[m] = out[m][:, :, ::-1, :]
        return out

    def batch_u8(self, n: int, key: Optional[int] = None) -> Array:
        """Raw uint8 batch for on-device normalization; float data is
        quantized."""
        rng = self._rng_for(key)
        idx = rng.integers(0, len(self.data), size=n)
        if self.data.dtype == np.uint8:
            out = self.data[idx]
        else:
            out = np.round((self.data[idx] + 1.0) * 127.5).astype(np.uint8)
        if self.flip:
            m = rng.integers(0, 2, size=n).astype(bool)
            out = out.copy()
            out[m] = out[m][:, :, ::-1, :]
        return out


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


def _no_reader(cfg: Config, what: str):
    raise NotImplementedError(
        f"dataset {cfg.dataset!r}: {what} found under {cfg.data_dir}, but the "
        "port has no reader for it yet (ROADMAP A.14); convert it to npz "
        "shards or train with the JAX package")


def make_dataset(cfg: Config) -> DataSource:
    ds = cfg.dataset
    if ds == "gaussian_mix":
        raise NotImplementedError(
            "the gaussian_mix toy needs the mlp networks and viz.py, not "
            "ported yet (ROADMAP A.11)")
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
        root = os.path.join(cfg.data_dir, "imagenet64")
        if os.path.isdir(root) and any(".tfrecord" in f for f in os.listdir(root)):
            _no_reader(cfg, "TFRecord shards")
    elif ds == "mnist":
        path = os.path.join(cfg.data_dir, "mnist", "train-images-idx3-ubyte")
        if os.path.exists(path):
            with open(path, "rb") as f:
                f.read(16)
                x = np.frombuffer(f.read(), np.uint8).reshape(-1, 28, 28, 1)
            return ArraySource(x.copy(), seed=cfg.random_seed)
    elif ds in ("lsun", "celeba"):
        root = os.path.join(cfg.data_dir, ds)
        if os.path.isdir(root) and os.listdir(root):
            _no_reader(cfg, f"{root} (images, an LMDB, TFRecords or a packed cache)")
    print(f"[smmdax_torch.data] assets for {ds!r} not found under {cfg.data_dir}; "
          "substituting the procedural synthetic source with matching shapes")
    return SyntheticImages(cfg.output_size, cfg.c_dim, seed=cfg.random_seed)


def macro_batch_at(source, step: int, per_step: int, batch: int,
                   u8: bool = False) -> Array:
    """The (per_step, batch, ...) macro-batch of ``step``: float [-1, 1]
    from ``source.batch``, or uint8 from ``source.batch_u8`` (the
    trainer's uint8-transfer path), bit-identical to the JAX package's."""
    draw = source.batch_u8 if u8 else source.batch
    flat = draw(per_step * batch, key=step)
    return flat.reshape((per_step, batch) + flat.shape[1:])


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


def materialize_u8(source: DataSource, pool: int = 0) -> Optional[Array]:
    """The dataset as ONE uint8 (N, H, W, C) array: an in-memory source's
    backing array, or a fixed ``pool``-sample draw from a procedural
    source with ``batch_u8``; None when neither is possible."""
    if getattr(source, "flip", False):
        raise ValueError("data_placement=device cannot honor flip "
                         "augmentation (batches are gathered in-program "
                         "from the resident pool); disable one of them")
    data = getattr(source, "data", None)
    if isinstance(data, np.ndarray) and data.ndim == 4:
        if data.dtype == np.uint8:
            return data
        return np.round((np.asarray(data) + 1.0) * 127.5).astype(np.uint8)
    if pool > 0 and hasattr(source, "batch_u8"):
        return source.batch_u8(pool, key=_POOL_KEY)
    return None
