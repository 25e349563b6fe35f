"""The port's asset tool (``python -m smmdax_torch.tools.make_assets``)
against the JAX package's ``tools/make_assets.py``: ``_proc_image`` draws
the same fields from the same stream; both tools' ``main`` at tiny counts
write the same JPEG files, ``data.mdb`` and idx file byte for byte, the
same pickle and npz arrays and labels (whose bytes depend on numpy's
version), and print the same lines; the port's ``make_dataset`` reads all
five formats back (as ``tests/test_real_loaders.py`` does for the JAX
package), with batches equal to the JAX package's on the JAX tool's files.
A failed encoder build raises: nothing falls back."""

import contextlib
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("PIL.Image")

from smmdax.configs import Config as JConfig  # noqa: E402
from smmdax.data import make_dataset as jmake_dataset  # noqa: E402
from smmdax_torch.configs import Config  # noqa: E402
from smmdax_torch.data import make_dataset  # noqa: E402
from smmdax_torch.data import native  # noqa: E402
from smmdax_torch.tools import make_assets as port_tool  # noqa: E402

from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import make_assets as jax_tool  # noqa: E402

COUNTS = ["--cifar_n", "50", "--celeba_n", "6", "--lsun_n", "8", "--imagenet_n", "20",
          "--mnist_n", "10"]
# dataset, output size, config fields, samples (None: decoded on demand)
READBACK = [("cifar10", 32, {}, 50), ("celeba", 160, {}, None),
            ("lsun", 64, {"lsun_category": "bedroom_train"}, None), ("imagenet64", 64, {}, 20),
            ("mnist", 28, {"c_dim": 1}, 10)]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both tools' output at the same tiny counts, and what each printed."""
    out = {}
    for name, tool in (("jax", jax_tool), ("port", port_tool)):
        root = str(tmp_path_factory.mktemp(name))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main(["--out", root] + COUNTS)
        out[name] = (root, buf.getvalue())
    return out


@pytest.mark.parametrize("seed,h,w", [(0, 32, 32), (1, 218, 178), (2, 256, 256), (3, 28, 28),
                                      (4, 64, 64), (5, 1, 1), (6, 7, 300)])
def test_proc_image_equals_jax(seed, h, w):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):                   # the stream stays in step
        want, got = jax_tool._proc_image(ra, h, w), port_tool._proc_image(rb, h, w)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_same_files(written):
    assert _files(written["port"][0]) == _files(written["jax"][0])


@pytest.mark.parametrize("fmt", ["celeba", "lsun", "mnist"])
def test_bytes_equal_jax(written, fmt):
    (jroot, _), (proot, _) = written["jax"], written["port"]
    rel = [f for f in _files(jroot) if f.split(os.sep)[0] == fmt]
    assert rel
    for f in rel:
        with open(os.path.join(jroot, f), "rb") as a, open(os.path.join(proot, f), "rb") as b:
            assert b.read() == a.read(), f


def test_pickles_and_npz_equal_jax(written):
    (jroot, _), (proot, _) = written["jax"], written["port"]
    for b in range(1, 6):
        rel = os.path.join("cifar-10-batches-py", f"data_batch_{b}")
        with open(os.path.join(jroot, rel), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(proot, rel), "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want) == {b"data", b"labels"}
        assert got[b"data"].dtype == want[b"data"].dtype == np.uint8
        np.testing.assert_array_equal(got[b"data"], want[b"data"])
        assert got[b"labels"] == want[b"labels"]
    for s in range(1, 6):
        rel = os.path.join("imagenet64", f"train_data_batch_{s}.npz")
        with np.load(os.path.join(jroot, rel)) as a, np.load(os.path.join(proot, rel)) as b:
            assert list(b.keys()) == list(a.keys()) == ["data"]
            assert b["data"].dtype == a["data"].dtype
            np.testing.assert_array_equal(b["data"], a["data"])
    assert port_tool.asset_digests(proot) == port_tool.asset_digests(jroot)


def test_printed_lines_equal_jax(written):
    (jroot, jout), (proot, pout) = written["jax"], written["port"]
    jl, pl = jout.replace(jroot, "OUT").splitlines(), pout.replace(proot, "OUT").splitlines()
    assert len(pl) == len(jl) == 13
    assert pl[:-1] == jl[:-1]
    assert pl[-1].startswith("assets under OUT in ") and pl[-1].endswith("s")


@pytest.mark.parametrize("ds,size,kw,n_expect", READBACK, ids=[r[0] for r in READBACK])
def test_make_dataset_reads_every_format(written, ds, size, kw, n_expect):
    (jroot, _), (proot, _) = written["jax"], written["port"]
    src = make_dataset(Config(dataset=ds, output_size=size, data_dir=proot, **kw))
    assert type(src).__name__ != "SyntheticImages", ds
    b = src.batch(4, key=0)
    c = 1 if ds == "mnist" else 3
    assert b.shape == (4, size, size, c), ds
    assert b.min() >= -1.0 and b.max() <= 1.0, ds
    data = getattr(src, "data", None)
    if n_expect is not None and data is not None:
        assert len(data) == n_expect, ds
    jsrc = jmake_dataset(JConfig(dataset=ds, output_size=size, data_dir=jroot, **kw))
    assert type(src).__name__ == type(jsrc).__name__
    for key in (0, 7):
        want = np.asarray(jsrc.batch(4, key=key))
        got = src.batch(4, key=key)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (ds, key)


def test_only_writes_the_named_formats(tmp_path):
    port_tool.main(["--out", str(tmp_path), "--only", "mnist,lsun", "--lsun_n", "3",
                    "--mnist_n", "4"])
    assert sorted(os.listdir(tmp_path)) == ["lsun", "mnist"]
    assert set(port_tool.asset_digests(str(tmp_path), ("lsun", "mnist"))) == {"lsun", "mnist"}


def test_cli_in_a_fresh_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", "smmdax_torch.tools.make_assets", "--out",
                           str(tmp_path), "--only", "celeba", "--celeba_n", "3"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(f"assets under {tmp_path} in ")
    assert sorted(os.listdir(tmp_path / "celeba")) == ["000000.jpg", "000001.jpg", "000002.jpg"]


def test_failed_encoder_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "ENCODE_SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_ENCODE_LIB", None)
    with pytest.raises(RuntimeError, match="JPEG encoder"):
        port_tool.make_celeba(str(tmp_path), 2)
    assert not os.listdir(tmp_path / "celeba")
