"""The JPEG layouts beyond baseline YCbCr (native ``data/_native/jpeg.cpp``
and the plain ``data/jpeg.py``) against PIL, byte for byte: seeded sweeps
of progressive files (4:4:4 / 4:2:2 / 4:2:0, grey, optimized tables,
restart intervals by blocks and rows, odd sizes), CMYK, YCCK and RGB
files, sequential files of several scans (written by the fixtures'
encoder, in any order of scans and of components within them as far as
PIL takes it), and every way an Adobe marker, a JFIF marker and the
component ids pick the colour space; a progressive file cut after any of
its scans decodes as PIL (smoothed where libjpeg smooths it);
truncations and bit flips of progressive files raise or decode and never
crash.  And the slice against the JAX package on one directory of mixed
layouts (every readable JPEG and PNG fixture): ``compute_scores._load``
and ``CelebASource.batch`` equal its bytes."""

import io
import os
import shutil

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax_torch.data import jpeg as plain  # noqa: E402
from smmdax_torch.data import native  # noqa: E402

HERE = os.path.dirname(__file__)
JPEG_FIXTURES = os.path.join(HERE, "fixtures", "port_images")
PNG_FIXTURES = os.path.join(HERE, "fixtures", "port_png")


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _proc(rng, h, w):
    from tools.make_assets import _proc_image
    return _proc_image(rng, h, w)


def _jpeg(img, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _case(rng, kind: str):
    h, w = (int(v) for v in rng.integers(1, 71, 2))
    arr = _proc(rng, h, w) if rng.random() < 0.6 else rng.integers(0, 256, (h, w, 3), np.uint8)
    img = Image.fromarray(arr)
    opts = dict(quality=int(rng.integers(5, 101)))
    if kind == "progressive":
        opts.update(progressive=True, subsampling=int(rng.integers(0, 3)))
        r = rng.random()
        if r < 0.25:
            opts["restart_marker_blocks"] = int(rng.integers(1, 5))
        elif r < 0.4:
            opts["restart_marker_rows"] = int(rng.integers(1, 3))
        if rng.random() < 0.3:
            opts["optimize"] = True
        if rng.random() < 0.15:
            img = img.convert("L")
    elif kind == "cmyk":
        img = img.convert("CMYK")
        opts["progressive"] = bool(rng.random() < 0.5)
    else:
        opts.update(keep_rgb=True, progressive=bool(rng.random() < 0.5))
    return _jpeg(img, **opts), h * w


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "rgb"])
def test_seeded_sweep_equals_pil(kind):
    """1-70 px, quality 5-100; native on every case, the plain decoder on
    those up to 64x64."""
    rng = np.random.default_rng({"progressive": 20, "cmyk": 21, "rgb": 22}[kind])
    for i in range(50):
        data, pixels = _case(rng, kind)
        want = _pil(data)
        np.testing.assert_array_equal(native.decode_jpeg(data), want)
        if pixels <= 64 * 64 and i % 3 == 0:
            np.testing.assert_array_equal(plain.decode_jpeg(data), want)


def _generator():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_jpeg_fixtures", os.path.join(JPEG_FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sequential_scans_equal_pil():
    """Sequential files whose components come in several scans (each of
    one component walking its own extent, or interleaved), in any order of
    scans, an interleaved scan's components in the frame's order or out of
    it, with and without restart intervals, 1-60 px, 4:2:2 and 4:2:0; a
    scan naming a component where libjpeg-turbo's get_sos cannot take it
    raises in both decoders, as in PIL."""
    gen = _generator()
    rng = np.random.default_rng(60)
    partitions = [[[0], [1], [2]], [[0], [1, 2]], [[0, 1], [2]], [[2], [0], [1]], [[1, 2], [0]],
                  [[0], [2, 1]], [[2, 1], [0]]]
    for i in range(30):
        h, w = (int(v) for v in rng.integers(1, 61, 2))
        data = gen.encode_scans(_proc(rng, h, w), int(rng.integers(1, 3)),
                                partitions[i % len(partitions)], int(rng.integers(0, 4)))
        want = _pil(data)
        np.testing.assert_array_equal(native.decode_jpeg(data), want)
        if h * w <= 40 * 40:
            np.testing.assert_array_equal(plain.decode_jpeg(data), want)
    data = gen.encode_scans(_proc(rng, 20, 30), 2, [[0], [2, 1]])
    want = _pil(data)
    for decode in (native.decode_jpeg, plain.decode_jpeg):
        np.testing.assert_array_equal(decode(data), want)
    data = gen.encode_scans(_proc(rng, 20, 30), 2, [[0, 2, 1]])
    with pytest.raises(OSError):
        _pil(data)
    for decode in (native.decode_jpeg, plain.decode_jpeg):
        with pytest.raises(plain.JPEGUnsupported, match="get_sos"):
            decode(data)


def _without(data: bytes, marker: int) -> bytes:
    """``data`` without its first segment of ``marker``."""
    i, n = next((i, 2 + n) for i, m, n in _generator()._segments(data) if m == marker)
    return data[:i] + data[i + n:]


def _adobe(transform: int) -> bytes:
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])


@pytest.mark.parametrize("components", [3, 4])
def test_colour_space_as_libjpeg_picks_it(components):
    """JFIF, Adobe transforms 0 / 1 / 2 / 5 and none, with the component ids
    1-2-3 or R-G-B, in front of PIL's YCbCr, RGB and CMYK files: the colour
    space libjpeg's ``default_decompress_parms`` picks (YCbCr, RGB, CMYK or
    YCCK), in both decoders."""
    rng = np.random.default_rng(30 + components)
    img = Image.fromarray(_proc(rng, 21, 29))
    if components == 4:
        bases = [_without(_jpeg(img.convert("CMYK"), quality=85), 0xEE)]
    else:
        ycc = _jpeg(img, quality=85, subsampling=2)
        bases = [ycc, _without(ycc, 0xE0), _without(_jpeg(img, quality=85, keep_rgb=True), 0xEE)]
    for base in bases:
        for marker in [b"", _adobe(0), _adobe(1), _adobe(2), _adobe(5)]:
            data = base[:2] + marker + base[2:]
            want = _pil(data)
            np.testing.assert_array_equal(native.decode_jpeg(data), want)
            np.testing.assert_array_equal(plain.decode_jpeg(data), want)


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_files_cut_after_each_scan(mode):
    """A progressive file cut after each of its scans (then EOI): decoded
    to PIL's bytes in both decoders, libjpeg's block smoothing included
    where the first AC coefficients still miss bits."""
    rng = np.random.default_rng(50)
    data = _jpeg(Image.fromarray(_proc(rng, 24, 32)).convert(mode), quality=80, progressive=True)
    sos = [i for i, m, _ in _generator()._segments(data) if m == 0xDA]
    read = 0
    for k in range(1, len(sos) + 1):
        cut = data[:sos[k]] + b"\xff\xd9" if k < len(sos) else data
        got = native.decode_jpeg(cut)
        np.testing.assert_array_equal(got, _pil(cut))
        np.testing.assert_array_equal(plain.decode_jpeg(cut), got)
        read += 1
    assert read == len(sos)


def _raises_or_decodes(data: bytes) -> None:
    try:
        out = native.decode_jpeg(data)
    except (ValueError, NotImplementedError):
        return
    assert out.ndim == 3 and out.shape[2] == 3


@pytest.mark.parametrize("name", ["progressive_restart_blocks_56x40.jpg", "cmyk_45x33.jpg"])
def test_every_truncation_raises_or_decodes(name):
    with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
        data = f.read()
    for n in range(len(data)):
        _raises_or_decodes(data[:n])


def test_bit_flips_raise_or_decode():
    """400 seeded single-bit flips over progressive, CMYK, YCCK and RGB
    files (markers, tables and entropy-coded data alike)."""
    rng = np.random.default_rng(13)
    names = ["progressive_s422_61x47.jpg", "progressive_optimized_33x29.jpg",
             "progressive_restart_rows_70x35.jpg", "cmyk_progressive_37x21.jpg",
             "ycck_45x33.jpg", "rgb_keep_progressive_29x20.jpg"]
    datas = []
    for name in names:
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            datas.append(f.read())
    for i in range(400):
        data = bytearray(datas[i % len(datas)])
        data[int(rng.integers(2, len(data)))] ^= 1 << int(rng.integers(0, 8))
        _raises_or_decodes(bytes(data))


# ---------------------------------------------------------------------------
# the slice against the JAX package


def _mixed_directory(root) -> int:
    """Every readable JPEG and PNG fixture, PNGs named .png and .jpg alike
    (both packages sniff the bytes)."""
    import json
    n = 0
    for where in (JPEG_FIXTURES, PNG_FIXTURES):
        with open(os.path.join(where, "manifest.json")) as f:
            entries = [e for e in json.load(f)["files"] if "refuse" not in e]
        for e in entries:
            ext = ".png" if e["name"].endswith(".png") and n % 3 else ".jpg"
            shutil.copy(os.path.join(where, e["name"]), os.path.join(root, f"{n:03d}{ext}"))
            n += 1
    return n


def test_compute_scores_load_equals_jax_on_mixed_layouts(tmp_path, capsys):
    import compute_scores as jcs
    from smmdax_torch import compute_scores as tcs
    _mixed_directory(tmp_path)
    want = jcs._load(str(tmp_path))
    want_out = capsys.readouterr().out
    got = tcs._load(str(tmp_path))
    assert capsys.readouterr().out == want_out
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_celeba_batches_equal_jax_on_mixed_layouts(tmp_path):
    """``batch(n, key)`` at 160 px (crop 160, CelebA's) and 64 px, and each
    file's crop against the JAX package's on PIL's decode."""
    from smmdax.data.pipeline import CelebASource as JaxCelebA
    from smmdax.data.pipeline import center_crop_resize
    from smmdax_torch.data.pipeline import CelebASource
    n = _mixed_directory(tmp_path)
    for size, keys in ((160, (1, 2)), (64, (3,))):
        jsrc = JaxCelebA(str(tmp_path), output_size=size)
        tsrc = CelebASource(str(tmp_path), output_size=size)
        assert tsrc.files == jsrc.files and len(tsrc.files) == n
        for key in keys:
            assert tsrc.batch(32, key=key).tobytes() == jsrc.batch(32, key=key).tobytes()
    for i, f in enumerate(tsrc.files):
        want = np.asarray(center_crop_resize(Image.open(f).convert("RGB"), 64, crop=160))
        np.testing.assert_array_equal(tsrc.decode_u8(i), want)
