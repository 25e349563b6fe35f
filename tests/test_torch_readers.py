"""The port's readers against the JAX package's, byte for byte: LMDB
environments (the port's reader on the JAX writer's files, the two writers'
files equal, overflow values and deep branch trees included), TFRecord
shards written with TensorFlow (raw and encoded layouts, parsed without
TensorFlow), and ``make_dataset``'s batches from every format (CelebA JPEG
directories at 160 and 64 px, LSUN LMDB, packed caches with and without a
category, TFRecord raw and encoded, ImageNet-64 TFRecord) for several
step keys, float and uint8, whole and by rows and rank blocks."""

import io
import os

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax.configs import Config as JConfig  # noqa: E402
from smmdax.data import lmdb_store as jlmdb  # noqa: E402
from smmdax.data import pipeline as jpipe  # noqa: E402
from smmdax_torch.configs import Config  # noqa: E402
from smmdax_torch.data import lmdb_store as tlmdb  # noqa: E402
from smmdax_torch.data import pipeline as tpipe  # noqa: E402

KEYS = (0, 5, 2**31 + 1)


def _proc(rng, h, w):
    from tools.make_assets import _proc_image
    return _proc_image(rng, h, w)


def _jpeg(arr, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _same_batches(jsrc, tsrc, n=6, u8=True):
    """Float (and uint8) batches of both sources equal for every key, whole
    and by rows (only those decoded), and rank blocks of macro-batches."""
    assert type(tsrc).__name__ == type(jsrc).__name__
    rows = np.array([4, 1, 5])
    for key in KEYS:
        want = jsrc.batch(n, key=key)
        assert tsrc.batch(n, key=key).tobytes() == want.tobytes()
        got_rows = tsrc.batch(n, key=key, rows=rows)
        assert got_rows.tobytes() == want[rows].tobytes()
        if u8:
            want8 = jsrc.batch_u8(n, key=key)
            assert tsrc.batch_u8(n, key=key).tobytes() == want8.tobytes()
            assert tsrc.batch_u8(n, key=key, rows=rows).tobytes() == want8[rows].tobytes()
    whole = jpipe.macro_batch_at(jsrc, 3, 2, 4)
    for rank in range(2):
        block = tpipe.macro_batch_at(tsrc, 3, 2, 4, block=(rank, 2))
        assert block.tobytes() == np.ascontiguousarray(whole[:, 2 * rank:2 * rank + 2]).tobytes()


# ---------------------------------------------------------------------------
# LMDB


def _items(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"{i:016x}".encode(), bytes(rng.integers(0, 256, int(s), dtype=np.uint8)))
            for i, s in enumerate(rng.integers(1, size, n))]


@pytest.mark.parametrize("n, size, psize", [(5, 200, 4096), (300, 400, 4096),
                                            (12, 30_000, 4096), (3000, 64, 4096),
                                            (40, 3000, 8192)],
                         ids=["one leaf", "branch root", "overflow", "deep tree", "8k pages"])
def test_lmdb_writers_equal_and_reader_reads_jax_files(tmp_path, n, size, psize):
    items = _items(n, size)
    jlmdb.write_lmdb(str(tmp_path / "j"), items, psize=psize)
    tlmdb.write_lmdb(str(tmp_path / "t"), items, psize=psize)
    assert (tmp_path / "t" / "data.mdb").read_bytes() == (tmp_path / "j" / "data.mdb").read_bytes()
    reader = tlmdb.LMDBReader(str(tmp_path / "j"))
    want = jlmdb.LMDBReader(str(tmp_path / "j"))
    assert len(reader) == len(want) == n
    assert list(reader.items()) == list(want.items()) == sorted(items)
    with pytest.raises(tlmdb.LMDBFormatError):
        (tmp_path / "g").mkdir()
        (tmp_path / "g" / "data.mdb").write_bytes(b"\0" * 8192)
        tlmdb.LMDBReader(str(tmp_path / "g"))


def _lsun_env(root, n=7, size=96, seed=0):
    rng = np.random.default_rng(seed)
    items = [(f"{i:016x}".encode(), _jpeg(_proc(rng, size, size + 8 * (i % 3)), quality=85))
             for i in range(n)]
    jlmdb.write_lmdb(str(root), items)


def test_lsun_lmdb_batches_equal_jax(tmp_path, capsys):
    _lsun_env(tmp_path / "lsun" / "bedroom_train_lmdb")
    _lsun_env(tmp_path / "lsun" / "tower_train_lmdb", seed=1)
    kw = dict(dataset="lsun", data_dir=str(tmp_path), output_size=64, random_seed=3,
              lsun_category="bedroom_train")
    jsrc = jpipe.make_dataset(JConfig(**kw))
    tsrc = tpipe.make_dataset(Config(**kw))
    _same_batches(jsrc, tsrc)
    assert "LSUN environment: bedroom_train_lmdb" in capsys.readouterr().out
    pool = tpipe.materialize_u8(tsrc, pool=10, block=(1, 2))
    assert pool.tobytes() == jpipe.materialize_u8(jsrc, pool=10)[5:10].tobytes()
    # the category rules: several environments need one, a wrong one names them
    for cat, err in (("", ValueError), ("kitchen", FileNotFoundError)):
        kw["lsun_category"] = cat
        with pytest.raises(err) as want:
            jpipe.make_dataset(JConfig(**kw))
        with pytest.raises(err) as got:
            tpipe.make_dataset(Config(**kw))
        assert str(got.value) == str(want.value)


def test_lsun_webp_record_raises(tmp_path):
    """A webp record (the official LSUN encoding) no longer raises: it
    gives JAX's batch, byte for byte."""
    buf = io.BytesIO()
    arr = np.random.default_rng(4).integers(0, 256, (16, 20, 3), dtype=np.uint8)
    Image.fromarray(arr).save(buf, format="WEBP")
    tlmdb.write_lmdb(str(tmp_path / "lsun"), [(b"k", buf.getvalue())])
    kw = dict(dataset="lsun", data_dir=str(tmp_path), output_size=16)
    src = tpipe.make_dataset(Config(**kw))
    want = jpipe.make_dataset(JConfig(**kw)).batch_u8(2, key=0)
    assert src.batch_u8(2, key=0).tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# CelebA directories and packed caches


def _celeba_dir(root, n=5, seed=0):
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        (root / f"{i:06d}.jpg").write_bytes(_jpeg(_proc(rng, 218, 178), quality=75))
    Image.fromarray(_proc(rng, 190, 170)).save(root / "extra.png")


@pytest.mark.parametrize("size", [160, 64])
def test_celeba_directory_batches_equal_jax(tmp_path, size):
    _celeba_dir(tmp_path / "celeba")
    kw = dict(dataset="celeba", data_dir=str(tmp_path), output_size=size, random_seed=1)
    _same_batches(jpipe.make_dataset(JConfig(**kw)), tpipe.make_dataset(Config(**kw)),
                  u8=False)


def test_lsun_loose_jpegs_crop_the_shortest_side(tmp_path):
    root = tmp_path / "lsun"
    root.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        (root / f"im{i}.jpg").write_bytes(_jpeg(_proc(rng, 80, 120)))
    kw = dict(dataset="lsun", data_dir=str(tmp_path), output_size=32)
    _same_batches(jpipe.make_dataset(JConfig(**kw)), tpipe.make_dataset(Config(**kw)),
                  u8=False)


@pytest.mark.parametrize("category", ["", "bedroom_train"])
def test_packed_caches_equal_jax(tmp_path, category, capsys):
    from smmdax.data.convert import packed_path
    data = np.random.default_rng(4).integers(0, 256, (9, 16, 16, 3), dtype=np.uint8)
    os.makedirs(tmp_path / "lsun")
    np.save(packed_path(str(tmp_path), "lsun", 16, category=category), data)
    kw = dict(dataset="lsun", data_dir=str(tmp_path), output_size=16, lsun_category=category)
    tsrc = tpipe.make_dataset(Config(**kw))
    assert isinstance(tsrc.data, np.memmap)
    _same_batches(jpipe.make_dataset(JConfig(**kw)), tsrc)
    if category:
        # a category-less cache beside it is ignored, with JAX's line
        np.save(packed_path(str(tmp_path), "lsun", 16), data)
        os.remove(packed_path(str(tmp_path), "lsun", 16, category=category))
        capsys.readouterr()
        with pytest.raises(FileNotFoundError, match="not found under"):
            jpipe.make_dataset(JConfig(**kw))
        want = capsys.readouterr().out
        with pytest.raises(FileNotFoundError, match="not found under"):
            tpipe.make_dataset(Config(**kw))
        got = capsys.readouterr().out
        assert "ignoring category-less packed cache" in got
        assert got.replace("smmdax_torch.", "smmdax.") == want


# ---------------------------------------------------------------------------
# TFRecord shards


def _tfrecords(path, images, layout):
    tf = pytest.importorskip("tensorflow")
    with tf.io.TFRecordWriter(str(path)) as w:
        for img in images:
            if layout == "raw":
                feat = {"image": tf.train.Feature(bytes_list=tf.train.BytesList(
                            value=[img.tobytes()])),
                        "shape": tf.train.Feature(int64_list=tf.train.Int64List(
                            value=list(img.shape)))}
            else:
                enc = _jpeg(img, quality=90) if layout == "jpeg" else tf.io.encode_png(img).numpy()
                feat = {"image/encoded": tf.train.Feature(bytes_list=tf.train.BytesList(
                            value=[enc])),
                        "label": tf.train.Feature(float_list=tf.train.FloatList(value=[0.5]))}
            w.write(tf.train.Example(features=tf.train.Features(feature=feat))
                    .SerializeToString())


@pytest.mark.parametrize("dataset, layout, hw, size", [
    ("imagenet64", "raw", (64, 64), 64),
    ("imagenet64", "jpeg", (72, 64), 64),
    ("celeba", "jpeg", (218, 178), 64),
    ("lsun", "png", (48, 40), 32),
    ("lsun", "raw", (30, 30), 32),
])
def test_tfrecord_batches_equal_jax(tmp_path, dataset, layout, hw, size):
    from smmdax.data.tfrecord import index_tfrecord as jindex
    from smmdax_torch.data.tfrecord import index_tfrecord, parse_example
    rng = np.random.default_rng(5)
    os.makedirs(tmp_path / dataset)
    for s in range(2):
        _tfrecords(tmp_path / dataset / f"train.tfrecord-{s:05d}",
                   [_proc(rng, *hw) for _ in range(4)], layout)
    path = str(tmp_path / dataset / "train.tfrecord-00000")
    assert index_tfrecord(path) == jindex(path)
    kw = dict(dataset=dataset, data_dir=str(tmp_path), output_size=size, random_seed=2)
    _same_batches(jpipe.make_dataset(JConfig(**kw)), tpipe.make_dataset(Config(**kw)),
                  u8=False)
    tf = pytest.importorskip("tensorflow")
    off, ln = index_tfrecord(path)[0]
    with open(path, "rb") as f:
        f.seek(off)
        payload = f.read(ln)
    want = tf.train.Example.FromString(payload).features.feature
    got = parse_example(payload)
    assert set(got) == set(want.keys())
    for k, (kind, values) in got.items():
        assert values == list(getattr(want[k], f"{kind}_list").value)


def test_unknown_record_names_its_keys(tmp_path):
    tf = pytest.importorskip("tensorflow")
    os.makedirs(tmp_path / "imagenet64")
    with tf.io.TFRecordWriter(str(tmp_path / "imagenet64" / "a.tfrecord")) as w:
        w.write(tf.train.Example(features=tf.train.Features(feature={
            "pixels": tf.train.Feature(int64_list=tf.train.Int64List(value=[1]))}))
            .SerializeToString())
    src = tpipe.make_dataset(Config(dataset="imagenet64", data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match=r"keys: \['pixels'\]"):
        src.batch(1, key=0)
