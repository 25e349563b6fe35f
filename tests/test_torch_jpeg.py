"""The port's JPEG decoder (native ``data/_native/jpeg.cpp`` and the plain
``data/jpeg.py``) and PIL's bilinear resize (``data/image.py``) against PIL,
byte for byte: the committed fixtures (``tests/fixtures/port_images``, whose
manifest of PIL's hashes is regenerated here), a seeded sweep of sizes,
qualities, subsamplings and restart intervals, native against plain on
small images; the fixtures of layouts once refused decode to PIL's bytes
where PIL decodes them and raise where PIL raises; unknown formats raise;
a decoder that cannot be built raises in ``make_dataset`` and is never
replaced.  Progressive, CMYK / YCCK and RGB files beyond the fixtures:
``tests/test_torch_jpeg_layouts.py``; arithmetic coding, lossless, the
other sampling layouts, block smoothing and scan orders:
``tests/test_torch_jpeg_arith.py``."""

import hashlib
import io
import json
import os

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax_torch.data import image as timage  # noqa: E402
from smmdax_torch.data import jpeg as plain  # noqa: E402
from smmdax_torch.data import native  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_images")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
READ = [e for e in MANIFEST if "refuse" not in e]
# the layouts the decoder once refused; those PIL refuses too carry "refuse"
REFUSED = [e for e in MANIFEST if e["name"].startswith("refuse_")]


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _proc(rng, h, w):
    from tools.make_assets import _proc_image
    return _proc_image(rng, h, w)


def _generator():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_manifest_holds_pils_hashes():
    """The recorded hashes are PIL's own on this host (what the machine
    without PIL holds the port to); the generator lists every file."""
    gen = _generator()
    LISTED, pil_hashes = gen.FIXTURES, gen.pil_hashes
    assert [e["name"] for e in MANIFEST] == [n for n, *_ in LISTED]
    for e in READ:
        got = pil_hashes(_bytes(e["name"]))
        assert {k: e[k] for k in got} == got, e["name"]
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 300_000


@pytest.mark.parametrize("entry", READ, ids=lambda e: e["name"])
def test_fixture_decodes_to_pils_bytes(entry):
    data = _bytes(entry["name"])
    got = native.decode_jpeg(data)
    assert got.shape == (entry["height"], entry["width"], 3)
    assert _sha(got) == entry["rgb_sha256"]
    assert _sha(timage.center_crop_resize(got, 160, crop=160)) == entry["crop160_sha256"]
    assert _sha(timage.center_crop_resize(got, 64)) == entry["crop64_sha256"]
    # the plain decoder on baseline files up to 256x256, progressive up to 64x64
    limit = 64 * 64 if entry["options"].get("progressive") else 256 * 256
    if entry["width"] * entry["height"] <= limit:
        np.testing.assert_array_equal(plain.decode_jpeg(data), got)


@pytest.mark.parametrize("entry", REFUSED, ids=lambda e: e["name"])
@pytest.mark.parametrize("decode", [native.decode_jpeg, plain.decode_jpeg,
                                    timage.decode_image], ids=["native", "plain", "dispatch"])
def test_unsupported_layouts_raise(entry, decode):
    """The headers patched to processes and layouts PIL does not write, and
    a progressive file cut short, held to what PIL does with them:
    lossless over DCT data, hierarchical and 12-bit raise JPEGUnsupported
    (saying PIL cannot decode them either) as PIL raises; Huffman data
    read as arithmetic-coded (libjpeg's corrupt-data path), 4:4:0 and the
    unsent bits (block smoothing) decode to PIL's recorded bytes."""
    data = _bytes(entry["name"])
    if "refuse" in entry:
        with pytest.raises(plain.JPEGUnsupported, match="PIL .* cannot decode this JPEG either"):
            decode(data)
        with pytest.raises(Exception):
            _pil(data)
        return
    got = decode(data)
    assert got.shape == (entry["height"], entry["width"], 3)
    assert _sha(got) == entry["rgb_sha256"]


def _sweep_case(rng):
    h, w = (int(v) for v in rng.integers(1, 71, 2))
    opts = dict(quality=int(rng.integers(10, 101)), subsampling=int(rng.integers(0, 3)))
    r = rng.random()
    if r < 0.25:
        opts["restart_marker_blocks"] = int(rng.integers(1, 5))
    elif r < 0.35:
        opts["restart_marker_rows"] = int(rng.integers(1, 3))
    if rng.random() < 0.2:
        opts["optimize"] = True
    arr = _proc(rng, h, w) if rng.random() < 0.6 else rng.integers(0, 256, (h, w, 3), np.uint8)
    img = Image.fromarray(arr)
    if rng.random() < 0.15:
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sweep_equals_pil(seed):
    """1-70 px (odd sizes too), quality 10-100, 4:4:4 / 4:2:2 / 4:2:0 and
    grey, restart intervals by blocks and by rows, optimized tables; the
    plain decoder on every eighth case."""
    rng = np.random.default_rng(100 + seed)
    for i in range(60):
        data = _sweep_case(rng)
        want = _pil(data)
        got = native.decode_jpeg(data)
        np.testing.assert_array_equal(got, want)
        if i % 8 == 0:
            np.testing.assert_array_equal(plain.decode_jpeg(data), want)


def test_large_image_and_fill_bytes():
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    Image.fromarray(_proc(rng, 480, 640)).save(buf, format="JPEG", quality=95,
                                                restart_marker_blocks=5)
    data = buf.getvalue()
    np.testing.assert_array_equal(native.decode_jpeg(data), _pil(data))
    # fill bytes (runs of 0xFF) before every restart marker and before EOI
    filled = data[:2] + data[2:-2].replace(b"\xff\xd0", b"\xff\xff\xff\xd0") + \
        b"\xff\xff" + data[-2:]
    np.testing.assert_array_equal(native.decode_jpeg(filled), _pil(data))


def test_corrupt_data_decodes_or_raises():
    """Bytes changed, cut or dropped at random: the native decoder returns
    an image or raises ValueError / NotImplementedError, never crashes."""
    rng = np.random.default_rng(11)
    datas = [_bytes(e["name"]) for e in MANIFEST]
    for _ in range(400):
        d = bytearray(datas[rng.integers(len(datas))])
        for _ in range(int(rng.integers(1, 6))):
            if len(d) < 2:
                break
            i, kind = int(rng.integers(len(d))), int(rng.integers(3))
            if kind == 0:
                d[i] = int(rng.integers(256))
            elif kind == 1:
                del d[i:i + int(rng.integers(1, 50))]
            else:
                d = d[:i]
        try:
            native.decode_jpeg(bytes(d))
        except (ValueError, NotImplementedError):
            pass


def test_webp_and_unknown_formats_raise():
    """webp decodes (to PIL's bytes), an animation to its first frame;
    unknown formats still raise, as does a corrupt JPEG."""
    buf = io.BytesIO()
    arr = np.random.default_rng(5).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(arr).save(buf, format="WEBP")
    np.testing.assert_array_equal(timage.decode_image(buf.getvalue()), _pil(buf.getvalue()))
    with pytest.raises(NotImplementedError, match="decodes JPEG, PNG and webp"):
        timage.decode_image(b"GIF89a\x01\x00")
    anim = io.BytesIO()
    frames = [Image.fromarray(arr), Image.fromarray(255 - arr)]
    frames[0].save(anim, format="WEBP", save_all=True, append_images=frames[1:], duration=50)
    np.testing.assert_array_equal(timage.decode_image(anim.getvalue()), _pil(anim.getvalue()))
    with pytest.raises(ValueError, match="corrupt JPEG"):
        native.decode_jpeg(b"\xff\xd8\xff")


def test_png_dispatch_equals_pil():
    rng = np.random.default_rng(3)
    for mode in ("L", "RGB", "RGBA"):
        arr = rng.integers(0, 256, (9, 11, len(mode)), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(buf, format="PNG")
        np.testing.assert_array_equal(timage.decode_image(buf.getvalue()), _pil(buf.getvalue()))


@pytest.mark.parametrize("case", ["down", "up", "non-square", "one axis"])
def test_resize_equals_pil(case):
    """Native and plain resize against PIL's BILINEAR where the fixed-point
    details matter: odd sizes, non-integer scales, grey and RGB."""
    rng = np.random.default_rng({"down": 0, "up": 1, "non-square": 2, "one axis": 3}[case])
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        if case == "down":
            oh, ow = int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1))
        elif case == "up":
            oh, ow = int(rng.integers(h, 2 * h + 9)), int(rng.integers(w, 2 * w + 9))
        elif case == "non-square":
            oh, ow = (int(v) for v in rng.integers(1, 120, 2))
        else:
            oh, ow = (h, int(rng.integers(1, 120))) if rng.random() < 0.5 else \
                (int(rng.integers(1, 120)), w)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if rng.random() < 0.3:
            arr = arr[..., 0]
        want = np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(timage.resize_bilinear_pil(arr, (ow, oh)), want)
        np.testing.assert_array_equal(timage.resize_bilinear_pil_plain(arr, (ow, oh)), want)


def test_center_crop_resize_matches_jax_on_pil_images():
    from smmdax.data.pipeline import center_crop_resize as jax_ccr
    rng = np.random.default_rng(4)
    for h, w, size, crop in [(218, 178, 160, 160), (218, 178, 64, None), (256, 256, 64, None),
                             (100, 140, 64, 200), (37, 91, 50, 30), (5, 3, 64, None)]:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(jax_ccr(Image.fromarray(arr), size, crop=crop))
        np.testing.assert_array_equal(timage.center_crop_resize(arr, size, crop=crop), want)


def test_threads_decode_side_by_side():
    import concurrent.futures as cf
    datas = [_bytes(e["name"]) for e in READ]
    want = [native.decode_jpeg(d) for d in datas]
    with cf.ThreadPoolExecutor(4) as pool:
        got = list(pool.map(native.decode_jpeg, datas * 3))
    for g, w in zip(got, want * 3):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dataset", ["celeba", "lsun"])
@pytest.mark.parametrize("failure, message", [
    ("bad source", "g\\+\\+ failed"),
    ("no source", "cannot build the JPEG decoder"),
    ("no compiler", "cannot build the JPEG decoder"),
])
def test_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch, capsys, dataset,
                                                  failure, message):
    """A decoder that cannot be built (a source that does not compile, no
    source, no g++ on PATH) raises in make_dataset for a directory of JPEGs,
    which never substitutes synthetic data or the plain decoder: the
    build's own missing file is never taken for a missing dataset."""
    import shutil
    from smmdax_torch.configs import Config
    from smmdax_torch.data import pipeline as tpipe
    (tmp_path / dataset).mkdir()
    shutil.copy(os.path.join(FIXTURES, "celeba_0.jpg"), tmp_path / dataset / "000001.jpg")
    if failure == "bad source":
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", str(bad))
    elif failure == "no source":
        monkeypatch.setattr(native, "SOURCE", str(tmp_path / "absent.cpp"))
    else:
        monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(plain, "decode_jpeg", lambda data: pytest.fail("plain decoder used"))
    with pytest.raises(RuntimeError, match=message):
        tpipe.make_dataset(Config(dataset=dataset, data_dir=str(tmp_path), output_size=64))
    assert "substituting" not in capsys.readouterr().out
