"""The port's packing tool (``python -m smmdax_torch.data.convert``) against
the JAX package's (``python -m smmdax.data.convert``): the ``.npy`` files of
an LSUN LMDB and of a CelebA-layout directory are byte-identical, and
``make_dataset`` trains from them as the JAX package does."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax.configs import Config as JConfig  # noqa: E402
from smmdax.data import convert as jconvert  # noqa: E402
from smmdax.data import pipeline as jpipe  # noqa: E402
from smmdax.data.lmdb_store import write_lmdb  # noqa: E402
from smmdax_torch.configs import Config  # noqa: E402
from smmdax_torch.data import convert as tconvert  # noqa: E402
from smmdax_torch.data import pipeline as tpipe  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _proc(rng, h, w):
    from tools.make_assets import _proc_image
    return _proc_image(rng, h, w)


def _jpeg(arr, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_pack_lsun_equals_jax_and_trains(tmp_path, capsys):
    rng = np.random.default_rng(0)
    env = tmp_path / "lsun" / "bedroom_train_lmdb"
    write_lmdb(str(env), [(f"{i:04d}".encode(), _jpeg(_proc(rng, 80, 96 + 4 * i), quality=85))
                          for i in range(11)])
    want = str(tmp_path / "jax.npy")
    jconvert.main(["lsun", str(env), want, "--size", "32", "--threads", "2"])
    out = tconvert.packed_path(str(tmp_path), "lsun", 32, category="bedroom_train")
    tconvert.main(["lsun", str(env), out, "--size", "32", "--threads", "3"])
    assert _read(out) == _read(want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"[smmdax_torch.convert] wrote {out}"
    assert lines[-2] == "[smmdax_torch.convert] 11/11"
    limited = str(tmp_path / "limited.npy")
    tconvert.pack_lsun(str(env), limited, 32, limit=4, threads=2)
    assert np.load(limited).tobytes() == np.load(want)[:4].tobytes()
    kw = dict(dataset="lsun", data_dir=str(tmp_path), output_size=32,
              lsun_category="bedroom_train", random_seed=4)
    tsrc, jsrc = tpipe.make_dataset(Config(**kw)), jpipe.make_dataset(JConfig(**kw))
    assert isinstance(tsrc, tpipe.ArraySource)
    for key in (0, 7):
        assert tsrc.batch_u8(8, key=key).tobytes() == jsrc.batch_u8(8, key=key).tobytes()
        assert tsrc.batch(8, key=key).tobytes() == jsrc.batch(8, key=key).tobytes()


@pytest.mark.parametrize("crop", [None, 160])
def test_pack_image_dir_cli_equals_jax(tmp_path, crop):
    rng = np.random.default_rng(1)
    root = tmp_path / "celeba"
    root.mkdir()
    for i in range(4):
        (root / f"{i:06d}.jpg").write_bytes(_jpeg(_proc(rng, 218, 178), quality=75))
    Image.fromarray(_proc(rng, 40, 60)).convert("L").save(root / "z.png")
    flags = ["--size", "64"] + ([] if crop is None else ["--crop", str(crop)])
    want, got = str(tmp_path / "jax.npy"), str(tmp_path / "port.npy")
    jconvert.main(["images", str(root), want] + flags)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "smmdax_torch.data.convert", "images",
                           str(root), got] + flags, capture_output=True, text=True,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"[smmdax_torch.convert] wrote {got}"
    assert _read(got) == _read(want)
