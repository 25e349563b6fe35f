"""The port's data pipeline (``smmdax_torch.data.pipeline``) against the
JAX package's: batches keyed by (seed, step) are byte-identical, for the
synthetic source and for in-memory uint8 data read from CIFAR-10 pickles
(with and without flips, float and uint8 batches); the asset dispatch
substitutes synthetic data like JAX when nothing is there and raises when
an asset is there but cannot be read."""

import os
import pickle
import struct

import numpy as np
import pytest

from smmdax.configs import Config as JConfig
from smmdax.data import pipeline as jpipe
from smmdax_torch.configs import Config
from smmdax_torch.data import pipeline as tpipe
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _write_cifar(root):
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        data = rng.integers(0, 256, (7, 3 * 32 * 32), dtype=np.uint8)
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": data}, f)


@pytest.mark.parametrize("dataset", ["synthetic", "cifar10"])
def test_macro_batches_byte_identical(tmp_path, dataset):
    _write_cifar(tmp_path)
    kw = dict(dataset=dataset, data_dir=str(tmp_path), random_seed=5)
    jsrc, tsrc = jpipe.make_dataset(JConfig(**kw)), tpipe.make_dataset(Config(**kw))
    assert type(tsrc).__name__ == type(jsrc).__name__
    for step in (0, 3, 2**31 + 1):
        for u8 in (False, True):
            want = (jsrc.batch_u8(12, key=step).reshape(3, 4, 32, 32, 3) if u8
                    else jpipe.macro_batch_at(jsrc, step, 3, 4))
            got = tpipe.macro_batch_at(tsrc, step, 3, 4, u8=u8)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    first = next(tpipe.macro_batches(tsrc, 3, 4, start_step=3))
    assert first.tobytes() == jpipe.macro_batch_at(jsrc, 3, 3, 4).tobytes()


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_array_source_matches_jax(flip, dtype):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (30, 8, 8, 3)).astype(np.uint8)
    if dtype == np.float32:
        data = (data.astype(np.float32) - 127.5) / 127.5
    jsrc, tsrc = jpipe.ArraySource(data, seed=2, flip=flip), tpipe.ArraySource(data, seed=2, flip=flip)
    for key in (0, 9):
        assert tsrc.batch(16, key=key).tobytes() == jsrc.batch(16, key=key).tobytes()
        assert tsrc.batch_u8(16, key=key).tobytes() == jsrc.batch_u8(16, key=key).tobytes()
    if not flip:
        assert tpipe.materialize_u8(tsrc).tobytes() == jpipe.materialize_u8(jsrc).tobytes()


def test_mnist_and_substitution(tmp_path, capsys):
    (tmp_path / "mnist").mkdir()
    img = np.random.default_rng(3).integers(0, 256, (5, 28, 28), dtype=np.uint8)
    (tmp_path / "mnist" / "train-images-idx3-ubyte").write_bytes(b"\0" * 16 + img.tobytes())
    kw = dict(dataset="mnist", data_dir=str(tmp_path), c_dim=1, output_size=28)
    src = tpipe.make_dataset(Config(**kw))
    assert src.batch_u8(4, key=1).tobytes() == \
        jpipe.make_dataset(JConfig(**kw)).batch_u8(4, key=1).tobytes()
    src = tpipe.make_dataset(Config(dataset="imagenet64", data_dir=str(tmp_path / "none"),
                                    output_size=64))
    assert src.sample_shape == (64, 64, 3)
    assert "substituting the procedural synthetic source" in capsys.readouterr().out


# what each unreadable asset raises: not an image, a 1-byte LMDB, no records
_ERRORS = {"celeba": (NotImplementedError, "decodes JPEG, PNG and webp"),
           "lsun": (struct.error, None), "imagenet64": (ValueError, "no records found")}


@pytest.mark.parametrize("dataset, path", [("celeba", "celeba/img_0001.jpg"),
                                           ("lsun", "lsun/bedroom_train_lmdb/data.mdb"),
                                           ("imagenet64", "imagenet64/train.tfrecord-0")])
def test_unreadable_assets_raise(tmp_path, dataset, path, capsys):
    """An asset that is there but cannot be read raises, when the dataset
    is made or at its first batch, and never turns into synthetic data
    (the port reads these formats now: ``tests/test_torch_readers.py``)."""
    os.makedirs(os.path.dirname(tmp_path / path), exist_ok=True)
    (tmp_path / path).write_bytes(b"\0")
    error, match = _ERRORS[dataset]
    with pytest.raises(error, match=match):
        src = tpipe.make_dataset(Config(dataset=dataset, data_dir=str(tmp_path)))
        src.batch(2, key=0)
    assert "substituting" not in capsys.readouterr().out
