"""The port's baseline JPEG encoder against PIL, byte for byte: the native
one (``data/_native/jpeg_encode.cpp``, ``data.native.encode_jpeg``) and its
plain numpy version (``data/jpeg_encode.py``, on the cases of 64x64 or
less), at every size class the encoder has to get right (1x1, sizes off the
8 / 16 grid whose MCUs hold dummy blocks, CelebA's 178x218, LSUN's 256x256)
and every branch of the quality scaling, on ``make_assets`` fields and on
flat, saturated, 0/255 checkerboard and uniform-noise fields.  There is no
tolerance: the bytes are PIL's or the test fails.  Also: the manifest of
PIL's hashes (``tests/fixtures/port_jpeg_encode``) that ``chip_smoke.py``
holds the encoder to on the card, a derandomised property over size and
quality, a round trip through the port's decoder, and refusals.

    PYTHONPATH=. python tests/test_torch_jpeg_encode.py

prints PIL's and the native encoder's ms per image at the two asset
geometries, on one thread of the machine it runs on."""

import concurrent.futures as cf
import hashlib
import importlib.util
import io
import json
import os
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

Image = pytest.importorskip("PIL.Image")

from smmdax_torch.data import jpeg_encode as plain  # noqa: E402
from smmdax_torch.data import native  # noqa: E402
from smmdax_torch.tools.make_assets import _proc_image  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_jpeg_encode")
_spec = importlib.util.spec_from_file_location(
    "port_jpeg_encode_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)

SIZES = [(1, 1), (7, 9), (8, 8), (16, 16), (17, 15), (33, 31), (218, 178), (256, 256)]
QUALITIES = [1, 10, 24, 25, 50, 75, 85, 88, 95, 100]
KINDS = ["proc", "flat", "saturated", "checker", "noise"]
PLAIN_MAX = 64 * 64


def pil_jpeg(img: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(kind: str, seed: int, h: int, w: int) -> np.ndarray:
    return fixtures.case_image(kind, seed, h, w, _proc_image)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("h,w", SIZES, ids=lambda v: str(v))
def test_encoders_equal_pil(h, w, quality):
    for i, kind in enumerate(KINDS):
        img = _image(kind, 1000 * h + 10 * w + i, h, w)
        want = pil_jpeg(img, quality)
        assert native.encode_jpeg(img, quality) == want, (kind, h, w, quality)
        if h * w <= PLAIN_MAX:
            assert plain.encode_jpeg(img, quality) == want, (kind, h, w, quality)


def test_quant_tables_equal_pils():
    """jpeg_set_quality at every quality: PIL's two DQT tables (zigzag)."""
    img = np.zeros((8, 8, 3), np.uint8)
    for q in range(1, 101):
        data = pil_jpeg(img, q)
        tables = []
        i = 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] == 0xDB:
                tables.append(np.frombuffer(data[i + 5:i + 69], np.uint8))
            i += 2 + n
        for want, got in zip(tables, plain.quant_tables(q)):
            np.testing.assert_array_equal(got[plain.ZIGZAG], want, err_msg=f"quality {q}")


@pytest.mark.parametrize("case", MANIFEST["cases"], ids=lambda c: c["name"])
def test_manifest_case(case):
    """The recorded hash is PIL's, and the native encoder's bytes have it
    (the plain encoder's too, up to 64x64)."""
    img = _image(case["kind"], case["seed"], case["h"], case["w"])
    want = pil_jpeg(img, case["quality"])
    assert hashlib.sha256(want).hexdigest() == case["sha256"]
    assert len(want) == case["bytes"]
    assert native.encode_jpeg(img, case["quality"]) == want
    if case["h"] * case["w"] <= PLAIN_MAX:
        assert plain.encode_jpeg(img, case["quality"]) == want


def test_manifest_covers_the_asset_geometries():
    geoms = {(c["h"], c["w"], c["quality"]) for c in MANIFEST["cases"]}
    assert {(218, 178, 88), (256, 256, 85)} <= geoms
    assert set(MANIFEST["assets"]) == set(fixtures.ASSET_COUNTS)
    for label, entry in MANIFEST["assets"].items():
        assert entry["counts"] == fixtures.ASSET_COUNTS[label]
        assert set(entry["digests"]) == {"cifar", "celeba", "lsun", "imagenet64", "mnist"}


@settings(max_examples=25, deadline=None, derandomize=True)
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(1, 100),
       kind=st.sampled_from(KINDS), seed=st.integers(0, 2 ** 16))
def test_property_random_sizes_and_qualities(h, w, quality, kind, seed):
    img = _image(kind, seed, h, w)
    want = pil_jpeg(img, quality)
    assert native.encode_jpeg(img, quality) == want
    assert plain.encode_jpeg(img, quality) == want


def test_round_trip_through_the_ports_decoder():
    """The port's decoder reads the encoder's files as PIL does."""
    for h, w, q in [(218, 178, 88), (256, 256, 85), (17, 15, 50), (1, 1, 100)]:
        img = _image("proc", h + w, h, w)
        data = native.encode_jpeg(img, q)
        got = native.decode_jpeg(data)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(got, want)
        if h * w > PLAIN_MAX:           # the asset geometries: close to their fields
            assert np.abs(got.astype(int) - img.astype(int)).mean() < 8


def test_strided_input_and_threads():
    """A strided view encodes as its contiguous copy; a pool of threads as
    one thread."""
    base = _image("proc", 7, 80, 96)
    view = base[5:69, 8:88]
    assert native.encode_jpeg(view, 88) == pil_jpeg(np.ascontiguousarray(view), 88)
    imgs = [_image("proc", s, 218, 178) for s in range(16)]
    with cf.ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(lambda a: native.encode_jpeg(a, 88), imgs))
    assert threaded == [native.encode_jpeg(a, 88) for a in imgs]


@pytest.mark.parametrize("encode", [native.encode_jpeg, plain.encode_jpeg],
                         ids=["native", "plain"])
def test_refuses_what_pil_is_not_asked_for(encode):
    rgb = np.zeros((8, 8, 3), np.uint8)
    for bad in (rgb.astype(np.float32), rgb.astype(np.uint16), rgb[..., 0], rgb[..., :2],
                np.zeros((8, 8, 4), np.uint8), np.zeros((0, 8, 3), np.uint8), rgb.tolist()):
        with pytest.raises(ValueError):
            encode(bad, 75)
    for q in (0, 101, -5, 75.0, True, "75", None):
        with pytest.raises(ValueError):
            encode(rgb, q)


def test_missing_source_raises(monkeypatch, tmp_path):
    """No encoder, no JPEG: a failed build raises, nothing falls back."""
    monkeypatch.setattr(native, "ENCODE_SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_ENCODE_LIB", None)
    with pytest.raises(RuntimeError, match="JPEG encoder"):
        native.encode_jpeg(np.zeros((8, 8, 3), np.uint8), 75)


def _ms(fn, img, q, n=200):
    fn(img, q)
    t0 = time.perf_counter()
    for _ in range(n):
        fn(img, q)
    return (time.perf_counter() - t0) / n * 1e3


if __name__ == "__main__":
    for h, w, q in [(218, 178, 88), (256, 256, 85)]:
        img = _image("proc", 102, h, w)
        print(f"{w}x{h} q{q}: PIL {_ms(pil_jpeg, img, q):.3f} ms, "
              f"native {_ms(native.encode_jpeg, img, q):.3f} ms per image")
