"""The JPEG layouts PIL decodes but never writes, in both decoders (native
``data/_native/jpeg.cpp`` and the plain ``data/jpeg.py``), against PIL
byte for byte: arithmetic coding (sequential and progressive, restart
intervals, DAC conditioning, and its corrupt-data path), lossless files
(predictors 1-7, point transforms, restarts), every integral sampling
layout (4:4:0, 4:1:1, 4:1:0, chroma above 1x1, four components sampled),
scans out of the frame's order, and libjpeg's block smoothing of
progressive files that leave bits unsent.  The committed fixtures
(``tests/fixtures/port_jpeg_layouts``, whose manifest of PIL's hashes is
checked here), seeded sweeps of sizes 1x1-67x45, qualities, sampling,
restarts and scan scripts (the arithmetic and sampling ones written by the
fixtures' libjpeg writer when ``gcc`` and ``jpeglib.h`` are here, else
skipped), the layouts PIL refuses (raised as ``JPEGUnsupported`` here and
as an error by PIL), and truncations and bit flips that raise or decode."""

import hashlib
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax_torch.data import image as timage  # noqa: E402
from smmdax_torch.data import jpeg as plain  # noqa: E402
from smmdax_torch.data import native  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_jpeg_layouts")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
READ = [e for e in MANIFEST if "refuse" not in e]
REFUSED = [e for e in MANIFEST if "refuse" in e]
PIL_REFUSES = "PIL .* cannot decode this JPEG either"


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _generator():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_layout_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    """The fixtures' libjpeg writer, built here, or None without gcc or
    libjpeg's headers."""
    if shutil.which("gcc") is None:
        return None
    out = str(tmp_path_factory.mktemp("writer") / "jpeg_writer")
    built = subprocess.run(["gcc", "-O1", os.path.join(FIXTURES, "jpeg_writer.c"), "-ljpeg",
                            "-o", out], capture_output=True)
    return out if built.returncode == 0 else None


def test_manifest_is_pils():
    """The recorded hashes are PIL's own on this host (what the machine
    without PIL holds the port to), PIL raises on every refused file, and
    the generator lists every file."""
    gen = _generator()
    assert [e["name"] for e in MANIFEST] == [n for n, *_ in gen.FIXTURES]
    for e in READ:
        got = gen.pil_hashes(_bytes(e["name"]))
        assert {k: e[k] for k in got} == got, e["name"]
    for e in REFUSED:
        assert gen.pil_refuses(_bytes(e["name"])), e["name"]
    files = [f for f in os.listdir(FIXTURES) if f.endswith(".jpg")]
    assert sorted(files) == sorted(e["name"] for e in MANIFEST)
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in files) < 150_000


@pytest.mark.parametrize("entry", READ, ids=lambda e: e["name"])
def test_fixture_decodes_to_pils_bytes(entry):
    """Both decoders, and the crops of the JAX package's pipeline."""
    data = _bytes(entry["name"])
    got = native.decode_jpeg(data)
    assert got.shape == (entry["height"], entry["width"], 3)
    assert _sha(got) == entry["rgb_sha256"]
    assert _sha(timage.center_crop_resize(got, 160, crop=160)) == entry["crop160_sha256"]
    assert _sha(timage.center_crop_resize(got, 64)) == entry["crop64_sha256"]
    np.testing.assert_array_equal(plain.decode_jpeg(data), got)


@pytest.mark.parametrize("entry", REFUSED, ids=lambda e: e["name"])
@pytest.mark.parametrize("decode", [native.decode_jpeg, plain.decode_jpeg,
                                    timage.decode_image], ids=["native", "plain", "dispatch"])
def test_refused_layouts_raise(entry, decode):
    """What PIL refuses (checked in ``test_manifest_is_pils``): a scan out
    of the place get_sos takes it at, a fractional sampling ratio, colour
    conversion in a lossless file, arithmetic lossless, hierarchical, the
    JPG process, a DNL height, 2 components, 12-bit lossless."""
    with pytest.raises(plain.JPEGUnsupported, match=PIL_REFUSES) as err:
        decode(_bytes(entry["name"]))
    assert "ROADMAP" not in str(err.value)


# ---------------------------------------------------------------------------
# seeded sweeps

SAMPLINGS = ["1x1,1x1,1x1", "2x1,1x1,1x1", "2x2,1x1,1x1", "1x2,1x1,1x1", "4x1,1x1,1x1",
             "4x2,1x1,1x1", "1x1,2x2,2x2", "2x2,2x1,1x2", "1x4,1x1,1x1", "3x1,1x1,1x1",
             "2x2,1x1,2x2", "3x2,1x1,1x1", "2x2,2x2,1x1", "1x3,1x1,1x1"]


def _image(rng, h: int, w: int, space: str) -> np.ndarray:
    from tools.make_assets import _proc_image
    rgb = _proc_image(rng, h, w) if rng.random() < 0.6 else \
        rng.integers(0, 256, (h, w, 3), np.uint8)
    if space == "grey":
        return rgb[..., 0].copy()
    if space in ("cmyk", "ycck"):
        return np.concatenate([rgb, rgb[..., :1]], axis=2)
    return rgb


def _c_case(rng, kind: str, gen, writer: str, tmp: str) -> bytes:
    """A file of jpeg_writer.c: arithmetic sequential or progressive (DAC
    values drawn for each table), or Huffman or arithmetic with a drawn
    sampling layout or progressive scan script; restarts by MCUs or rows;
    grey, YCbCr, RGB, CMYK or YCCK."""
    h, w = int(rng.integers(1, 46)), int(rng.integers(1, 68))
    opts = dict(quality=int(rng.integers(5, 101)))
    r = rng.random()
    if r < 0.3:
        opts["restart"] = int(rng.integers(1, 6))
    elif r < 0.45:
        opts["restart_rows"] = int(rng.integers(1, 3))
    if kind.startswith("arith"):
        opts["arith"] = 1
        opts["progressive"] = int(kind == "arith_progressive")
        if rng.random() < 0.5:
            dac = []
            for t in range(3):
                lo = int(rng.integers(0, 16))
                dac.append(f"{t}:{lo}:{lo + int(rng.integers(0, 16 - lo))}:"
                           f"{int(rng.integers(1, 64))}")
            opts["dac"] = ",".join(dac)
    else:
        opts["arith"] = int(rng.random() < 0.5)
    if kind == "scan_scripts":
        opts["progressive"] = 1
        opts["scans"] = list(gen.SCRIPTS)[int(rng.integers(len(gen.SCRIPTS)))]
    sampled = kind == "sampling" or rng.random() < 0.5
    space = ["ycc", "ycc", "ycc", "rgb", "grey", "cmyk", "ycck"][int(rng.integers(7))]
    if opts.get("scans") == "grey_ac_unsent":
        space = "grey"
    elif opts.get("scans"):
        space = ["ycc", "rgb"][int(rng.integers(2))]
    if sampled and space != "grey":
        opts["sampling"] = SAMPLINGS[int(rng.integers(len(SAMPLINGS)))]
        if space in ("cmyk", "ycck"):
            opts["sampling"] += ",1x1"
    return gen._write_c(writer, _image(rng, h, w, space), tmp, space=space, **opts)


def _python_case(rng, kind: str, gen) -> bytes:
    """A lossless file (predictor, point transform, sampling and restart
    rows drawn; grey, RGB by ids or Adobe marker, or CMYK), or PIL's
    baseline file re-encoded with scans out of the frame's order."""
    h, w = int(rng.integers(1, 46)), int(rng.integers(1, 68))
    if kind == "reorder":
        scans = [[[0], [2, 1]], [[2, 1], [0]], [[2], [1], [0]], [[1], [2], [0]],
                 [[0, 2], [1]], [[1, 2], [0]]][int(rng.integers(6))]
        buf = io.BytesIO()
        Image.fromarray(_image(rng, h, w, "ycc")).save(
            buf, format="JPEG", quality=int(rng.integers(5, 101)),
            subsampling=int(rng.integers(0, 3)))
        restart = int(rng.integers(0, 4))
        return gen.encode_reordered(buf.getvalue(), scans, restart)
    space = ["rgb", "rgb", "grey", "cmyk"][int(rng.integers(4))]
    opts = dict(psv=int(rng.integers(1, 8)), pt=int(rng.integers(0, 3)))
    if space == "rgb":
        if rng.random() < 0.5:
            opts["sampling"] = SAMPLINGS[int(rng.integers(len(SAMPLINGS)))]
        opts.update([("ids", b"RGB")] if rng.random() < 0.3 else
                    [("adobe", 0)] if rng.random() < 0.3 else [])
    if rng.random() < 0.4:
        opts["restart_rows"] = int(rng.integers(1, 4))
    return gen.encode_lossless(_image(rng, h, w, space), **opts)


@pytest.mark.parametrize("kind", ["arith", "arith_progressive", "sampling", "scan_scripts",
                                  "lossless", "reorder"])
def test_seeded_sweep_equals_pil(kind, writer, tmp_path):
    """30 files of each kind, 1x1-67x45, quality 5-100; both decoders on
    every file."""
    gen = _generator()
    rng = np.random.default_rng({"arith": 1, "arith_progressive": 2, "sampling": 3,
                                 "scan_scripts": 4, "lossless": 5, "reorder": 6}[kind] + 1500)
    python_writer = kind in ("lossless", "reorder")
    if not python_writer and writer is None:
        pytest.skip("the fixtures' libjpeg writer needs gcc and jpeglib.h")
    done = 0
    while done < 30:
        try:
            data = (_python_case(rng, kind, gen) if python_writer else
                    _c_case(rng, kind, gen, writer, str(tmp_path)))
        except subprocess.CalledProcessError:   # more blocks per MCU than libjpeg writes
            continue
        want = _pil(data)
        np.testing.assert_array_equal(native.decode_jpeg(data), want)
        np.testing.assert_array_equal(plain.decode_jpeg(data), want)
        done += 1


def test_corrupt_arithmetic_data_equals_pil():
    """PIL's Huffman files with their frame header patched to SOF9 / SOF10:
    read as arithmetic-coded data they overflow (JWRN_ARITH_BAD_CODE),
    zero the rest of the interval, and give coefficients no encoder writes,
    which libjpeg-turbo's SIMD IDCT wraps and saturates; both decoders
    equal PIL wherever PIL decodes."""
    from tools.make_assets import _proc_image
    rng = np.random.default_rng(1515)
    decoded = 0
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(1, 68, 2))
        buf = io.BytesIO()
        Image.fromarray(_proc_image(rng, h, w)).save(
            buf, format="JPEG", quality=int(rng.integers(5, 101)),
            progressive=bool(rng.random() < 0.3), restart_marker_blocks=int(rng.integers(0, 3)))
        data = buf.getvalue()
        sof = data.find(b"\xff\xc0") if b"\xff\xc0" in data else data.find(b"\xff\xc2")
        data = data[:sof + 1] + bytes([{0xC0: 0xC9, 0xC2: 0xCA}[data[sof + 1]]]) + data[sof + 2:]
        try:
            want = _pil(data)
        except OSError:
            with pytest.raises((ValueError, NotImplementedError)):
                native.decode_jpeg(data)
            continue
        np.testing.assert_array_equal(native.decode_jpeg(data), want)
        np.testing.assert_array_equal(plain.decode_jpeg(data), want)
        decoded += 1
    assert decoded >= 30


def _raises_or_decodes(data: bytes) -> None:
    try:
        out = native.decode_jpeg(data)
    except (ValueError, NotImplementedError):
        return
    assert out.ndim == 3 and out.shape[2] == 3


@pytest.mark.parametrize("name", ["arith_seq_restart_dac_61x47.jpg",
                                  "arith_prog_restart_dac_53x37.jpg",
                                  "lossless_p4_restart_45x33.jpg"])
def test_every_truncation_raises_or_decodes(name):
    data = _bytes(name)
    for n in range(len(data)):
        _raises_or_decodes(data[:n])


def test_bit_flips_raise_or_decode():
    """400 seeded single-bit flips over arithmetic, lossless, sampled and
    smoothed files (markers, tables and entropy-coded data alike)."""
    rng = np.random.default_rng(15)
    names = ["arith_seq_restart_dac_61x47.jpg", "arith_prog_restart_dac_53x37.jpg",
             "arith_seq_cmyk_37x21.jpg", "lossless_p7_s420_37x21.jpg",
             "lossless_p4_restart_45x33.jpg", "s410_61x47.jpg", "smooth_luma_ac_48x40.jpg",
             "smooth_arith_dc_only_29x20.jpg", "reorder_cr_y_cb_restart_40x30.jpg"]
    datas = [_bytes(name) for name in names]
    for i in range(400):
        data = bytearray(datas[i % len(datas)])
        data[int(rng.integers(2, len(data)))] ^= 1 << int(rng.integers(0, 8))
        _raises_or_decodes(bytes(data))
