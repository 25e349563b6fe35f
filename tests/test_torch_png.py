"""The port's PNG decoders (native ``data/_native/png.cpp`` through
``data/native.py``, and the plain ``utils.decode_png``) against PIL, byte
for byte: the committed fixtures (``tests/fixtures/port_png``, whose
manifest of PIL's hashes is checked here), PIL-written files of every mode
it saves, hand-written files of every colour type and bit depth, Adam7 or
not, every row filter, at sizes 1-40; ``decode_image`` and ``read_png``
take the native decoder; truncated and bit-flipped files raise
``ValueError`` or decode and never crash; a PNG decoder that cannot be
built raises and is never replaced by the plain one."""

import hashlib
import io
import json
import os

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax_torch import utils  # noqa: E402
from smmdax_torch.data import image as timage  # noqa: E402
from smmdax_torch.data import native  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_png")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]


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
        "make_png_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_manifest_holds_pils_hashes():
    """The recorded hashes are PIL's own here (what the machine without PIL
    holds the port to); the generator lists every file, and the files are
    the layouts they claim."""
    gen = _generator()
    assert [e["name"] for e in MANIFEST] == [n for n, *_ in gen.PIL_FILES + gen.HAND_FILES]
    for e in MANIFEST:
        got = gen.pil_hashes(_bytes(e["name"]))
        assert {k: e[k] for k in got} == got, e["name"]
    for name, _, color, depth, adam7 in gen.HAND_FILES:
        head = _bytes(name)[16:29]
        assert (head[8], head[9], head[12]) == (depth, color, int(adam7)), name
    layouts = {(d[24], d[25], d[28]) for d in map(_bytes, (e["name"] for e in MANIFEST))}
    want = {(1, 3, 0), (2, 3, 0), (4, 3, 0), (8, 3, 0), (1, 0, 0), (2, 0, 0), (4, 0, 0),
            (16, 0, 0), (8, 4, 0), (16, 4, 0), (16, 2, 0), (16, 6, 0), (8, 2, 0), (8, 0, 1),
            (2, 3, 1), (8, 6, 1), (8, 2, 1), (1, 0, 1)}
    assert want <= layouts
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 300_000


@pytest.mark.parametrize("entry", MANIFEST, ids=lambda e: e["name"])
def test_fixture_decodes_to_pils_bytes(entry):
    data = _bytes(entry["name"])
    got = native.decode_png(data)
    assert got.shape == (entry["height"], entry["width"], 3)
    assert _sha(got) == entry["rgb_sha256"]
    assert _sha(timage.center_crop_resize(got, 160, crop=160)) == entry["crop160_sha256"]
    assert _sha(timage.center_crop_resize(got, 64)) == entry["crop64_sha256"]
    np.testing.assert_array_equal(utils.decode_png(data), got)
    np.testing.assert_array_equal(timage.decode_image(data), got)


def test_read_png_takes_the_native_decoder(tmp_path, monkeypatch):
    data = _bytes("adam7_p2_37x21.png")
    (tmp_path / "a.png").write_bytes(data)
    monkeypatch.setattr(utils, "decode_png", lambda *a: pytest.fail("plain decoder used"))
    np.testing.assert_array_equal(utils.read_png(str(tmp_path / "a.png")), _pil(data))
    px = np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    utils.write_png(str(tmp_path / "b.png"), px)
    np.testing.assert_array_equal(utils.read_png(str(tmp_path / "b.png")), px)


PIL_MODES = ["1", "L", "LA", "P", "RGB", "RGBA", "I;16"]


def _pil_png(rng, mode: str, h: int, w: int) -> bytes:
    buf = io.BytesIO()
    if mode == "P":
        bits = int(rng.choice([1, 2, 4, 8]))
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).quantize(
            1 << bits)
        opts = dict(bits=bits)
        if rng.random() < 0.5:
            opts["transparency"] = int(rng.integers(0, 1 << bits))
        img.save(buf, format="PNG", **opts)
        return buf.getvalue()
    if mode == "I;16":
        v = rng.integers(0, 600, (h, w)).astype("<u2")
        img = Image.frombytes("I;16", (w, h), v.tobytes())
    else:
        ch = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        img = Image.fromarray(a[..., 0] if ch == 1 else a, "L" if ch == 1 else mode)
        if mode == "1":
            img = img.convert("1")
    img.save(buf, format="PNG", optimize=bool(rng.random() < 0.3))
    return buf.getvalue()


@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_written_files_decode_as_pil(mode):
    rng = np.random.default_rng(PIL_MODES.index(mode))
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 41, 2))
        data = _pil_png(rng, mode, h, w)
        want = _pil(data)
        np.testing.assert_array_equal(native.decode_png(data), want)
        np.testing.assert_array_equal(utils.decode_png(data), want)


LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("adam7", [False, True], ids=["plain", "adam7"])
def test_hand_written_layouts_decode_as_pil(adam7):
    """Every colour type and bit depth, sizes 1-20 (Adam7's empty passes
    at widths and heights under 8), random samples, every filter in turn,
    palettes shorter than the indices reach (black past their end)."""
    gen = _generator()
    rng = np.random.default_rng(40 + adam7)
    for color, depth in LAYOUTS:
        for _ in range(4):
            h, w = (int(v) for v in rng.integers(1, 21, 2))
            s = rng.integers(0, 1 << depth, (h, w, gen.CHANNELS[color]))
            palette = rng.integers(0, 256, (int(rng.integers(1, 1 << depth)) if depth < 8 else
                                            int(rng.integers(1, 257)), 3)) if color == 3 else None
            data = gen.encode(s, color, depth, adam7, palette)
            want = _pil(data)
            np.testing.assert_array_equal(native.decode_png(data), want)
            np.testing.assert_array_equal(utils.decode_png(data), want)


def _raises_or_decodes(data: bytes) -> None:
    try:
        out = native.decode_png(data)
    except ValueError:
        return
    assert out.ndim == 3 and out.shape[2] == 3


@pytest.mark.parametrize("name", ["adam7_rgba8_31x23.png", "p4_trns_45x33.png"])
def test_every_truncation_raises_or_decodes(name):
    data = _bytes(name)
    for n in range(0, len(data), 3):
        _raises_or_decodes(data[:n])


def test_bit_flips_raise_or_decode():
    """300 seeded bit flips over the image data, with the IDAT CRC left
    stale and the zlib stream re-made, so that filters and samples see the
    damage too."""
    import struct
    import zlib
    rng = np.random.default_rng(12)
    names = [e["name"] for e in MANIFEST if e["width"] * e["height"] < 4096]
    for i in range(300):
        data = bytearray(_bytes(names[i % len(names)]))
        if i % 2:
            pos = int(rng.integers(8, len(data)))
            data[pos] ^= 1 << int(rng.integers(0, 8))
        else:       # flip a bit of the inflated stream (filter bytes and samples)
            w, h, depth, color, interlace, _, raw = utils.png_parts(bytes(data))
            raw = bytearray(raw)
            raw[int(rng.integers(len(raw)))] ^= 1 << int(rng.integers(0, 8))
            body = zlib.compress(bytes(raw))
            head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
            data = bytearray(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + head
                             + b"\0" * 4 + struct.pack(">I", len(body)) + b"IDAT" + body
                             + b"\0" * 4)
        _raises_or_decodes(bytes(data))
    # a 2x2 grey file whose rows name filter type 7
    head = _generator().encode(np.zeros((2, 2, 1), int), 0, 8, False)[:33]
    body = zlib.compress(b"\x07\x00\x00\x07\x00\x00")
    bad = head + struct.pack(">I", len(body)) + b"IDAT" + body + b"\0" * 4
    for decode in (native.decode_png, utils.decode_png):
        with pytest.raises(ValueError, match="filter type"):
            decode(bad)


@pytest.mark.parametrize("failure, message", [
    ("bad source", "g\\+\\+ failed"),
    ("no source", "cannot build the PNG decoder"),
    ("no compiler", "cannot build the PNG decoder"),
])
def test_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch, failure, message):
    """A PNG decoder that cannot be built (a source that does not compile,
    no source, no g++ on PATH) raises in ``decode_image`` and ``read_png``;
    the plain decoder never stands in for it."""
    if failure == "bad source":
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "PNG_SOURCE", str(bad))
    elif failure == "no source":
        monkeypatch.setattr(native, "PNG_SOURCE", str(tmp_path / "absent.cpp"))
    else:
        monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_PNG_LIB", None)
    monkeypatch.setattr(utils, "decode_png", lambda *a: pytest.fail("plain decoder used"))
    (tmp_path / "a.png").write_bytes(_bytes("l1_37x21.png"))
    with pytest.raises(RuntimeError, match=message):
        timage.decode_image(_bytes("l1_37x21.png"))
    with pytest.raises(RuntimeError, match=message):
        utils.read_png(str(tmp_path / "a.png"))
