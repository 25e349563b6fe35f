"""The port's webp decoder (native ``data/_native/webp.cpp``) against PIL,
byte for byte: the committed fixtures (``tests/fixtures/port_webp``, whose
manifest of PIL's hashes is checked here), a derandomised property over
PIL-encoded random sizes, lossy and lossless; animations to their first
frame (PIL-encoded, and built here with a smaller first frame at an
offset); truncated and bit-flipped files raise ``ValueError`` or decode
and never crash; the LSUN source, ``make_dataset`` and the packing tool
on webp LMDBs equal the JAX package's bytes.

    PYTHONPATH=. python tests/test_torch_webp.py

prints PIL's and the port's ms per image at 256 px (lossy q75 and
lossless), on one thread of the machine it runs on."""

import hashlib
import io
import json
import os
import time

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from smmdax_torch.data import image as timage  # noqa: E402
from smmdax_torch.data import native  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_webp")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
READ = MANIFEST
ANIMATED = [e["name"] for e in MANIFEST if e["name"].startswith("animated")]


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _bytes(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _webp(arr, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="WEBP", **opts)
    return buf.getvalue()


def _proc(rng, h, w):
    from tools.make_assets import _proc_image
    return _proc_image(rng, h, w)


def _generator():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_webp_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_manifest_holds_pils_hashes():
    """The recorded hashes are PIL's own here (what the machine
    without PIL holds the port to); the generator lists every file, and
    the files are what they claim: VP8X with ALPH, 2/4/8 partitions,
    two-frame animations with ANIM and ANMF."""
    gen = _generator()
    listed = [n for n, *_ in gen.LOSSY + gen.LOSSY_LIB + gen.LOSSLESS + gen.ANIMATED
              + gen.HAND_ANIMATED]
    assert [e["name"] for e in MANIFEST] == listed
    for e in READ:
        got = gen.pil_hashes(_bytes(e["name"]))
        assert {k: e[k] for k in got} == got, e["name"]
    alpha = _bytes("lossy_alpha_exact_33x29.webp")
    assert alpha[12:16] == b"VP8X" and b"ALPH" in alpha and b"VP8 " in alpha
    for e in READ:
        data = _bytes(e["name"])
        if e["name"] in ANIMATED:
            assert data[12:16] == b"VP8X" and data[20] & 0x02 and b"ANIM" in data
            assert data.count(b"ANMF") == 2 == Image.open(io.BytesIO(data)).n_frames
            continue
        assert data[12:16] == (b"VP8L" if e["name"].startswith("lossless") else
                               b"VP8X" if "alpha" in e["name"] else b"VP8 ")
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 200_000


@pytest.mark.parametrize("entry", READ, ids=lambda e: e["name"])
def test_fixture_decodes_to_pils_bytes(entry):
    data = _bytes(entry["name"])
    got = native.decode_webp(data)
    assert got.shape == (entry["height"], entry["width"], 3)
    np.testing.assert_array_equal(got, _pil(data))
    assert _sha(got) == entry["rgb_sha256"]
    assert _sha(timage.center_crop_resize(got, 64)) == entry["crop64_sha256"]
    np.testing.assert_array_equal(timage.decode_image(data), got)


def test_animated_first_frame_at_an_offset():
    """A first frame smaller than its canvas, at an offset, over a non-zero
    ANIM background: the canvas is transparent black around it, whether
    the frame's blend flag is on (with alpha) or off (lossless)."""
    for e in MANIFEST:
        if "offset" not in e:
            continue
        got = native.decode_webp(_bytes(e["name"]))
        (x, y), (w, h) = e["offset"], (e["width"] // 2, e["height"] // 2)
        assert got.shape == (e["height"], e["width"], 3)
        inside = np.zeros(got.shape[:2], bool)
        inside[y:y + h, x:x + w] = True
        assert not got[~inside].any() and got[inside].any(), e["name"]


def _animation(frames, **opts) -> bytes:
    buf = io.BytesIO()
    frames = [Image.fromarray(a, "RGBA" if a.shape[-1] == 4 else "RGB") for a in frames]
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], **opts)
    return buf.getvalue()


def test_random_animations_decode_as_pil():
    """PIL-encoded two- and three-frame animations, sizes 1-48, lossy and
    lossless, with and without alpha; and animations built from still
    frames at random offsets in a larger canvas with the blend flag on or
    off: the port gives PIL's first frame."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    gen = _generator()

    @hyp.settings(max_examples=25, derandomize=True, deadline=None, database=None)
    @hyp.given(h=st.integers(1, 48), w=st.integers(1, 48), lossless=st.booleans(),
               alpha=st.booleans(), frames=st.integers(2, 3), built=st.booleans(),
               dx=st.integers(0, 20), dy=st.integers(0, 20), flags=st.sampled_from([0, 2]),
               seed=st.integers(0, 2**31))
    def check(h, w, lossless, alpha, frames, built, dx, dy, flags, seed):
        rng = np.random.default_rng(seed)
        arrs = [rng.integers(0, 256, (h, w, 4 if alpha else 3), dtype=np.uint8)
                for _ in range(frames)]
        opts = dict(lossless=lossless, quality=60)
        if built:
            first = gen.pil_encode(arrs[0], exact=True, **opts)
            canvas = (w + 2 * dx + 1, h + 2 * dy + 1)
            data = gen.animation(canvas, [(2 * dx, 2 * dy, first, flags),
                                          (0, 0, gen.pil_encode(
                                              np.zeros(canvas[::-1] + (3,), np.uint8)), 0)])
        else:
            data = _animation(arrs, duration=50, **opts)
        np.testing.assert_array_equal(native.decode_webp(data), _pil(data))

    check()


def test_random_images_decode_as_pil():
    """PIL-encoded random sizes 1-80, lossy (quality, method) and lossless,
    random and smooth content: the port decodes PIL's bytes."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=40, derandomize=True, deadline=None, database=None)
    @hyp.given(h=st.integers(1, 80), w=st.integers(1, 80), lossless=st.booleans(),
               quality=st.integers(0, 100), method=st.integers(0, 6), smooth=st.booleans(),
               seed=st.integers(0, 2**31))
    def check(h, w, lossless, quality, method, smooth, seed):
        rng = np.random.default_rng(seed)
        arr = _proc(rng, h, w) if smooth else rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        data = _webp(arr, lossless=lossless, quality=quality, method=method)
        np.testing.assert_array_equal(native.decode_webp(data), _pil(data))

    check()


def _raises_or_decodes(data: bytes) -> None:
    try:
        out = native.decode_webp(data)
    except ValueError:
        return
    assert out.ndim == 3 and out.shape[2] == 3


@pytest.mark.parametrize("name", ["lossy_q75_m4_61x47.webp", "lossless_proc_m0_50x40.webp"])
def test_every_truncation_raises_or_decodes(name):
    data = _bytes(name)
    for n in range(len(data)):
        _raises_or_decodes(data[:n])
    with pytest.raises(ValueError, match="corrupt webp"):
        native.decode_webp(data[:len(data) // 2])


@pytest.mark.parametrize("name", ["animated_lossy_16x16.webp",
                                  "animated_offset_noblend_lossless_64x48.webp"])
def test_every_truncation_of_an_animation_raises_or_decodes(name):
    data = _bytes(name)
    for n in range(len(data)):
        _raises_or_decodes(data[:n])


def test_bit_flips_raise_or_decode():
    """300 seeded single-bit flips over lossy, lossless, extended and
    animated files (container, headers and entropy-coded data alike)."""
    rng = np.random.default_rng(10)
    names = ["lossy_q50_m0_61x47.webp", "lossy_parts4_64x96.webp", "lossy_alpha_exact_33x29.webp",
             "lossless_16colours_45x33.webp", "lossless_proc_m0_50x40.webp",
             "animated_alpha_lossy_33x29.webp", "animated_offset_blend_alpha_64x48.webp"]
    for i in range(300):
        data = bytearray(_bytes(names[i % len(names)]))
        pos = int(rng.integers(0, len(data)))
        data[pos] ^= 1 << int(rng.integers(0, 8))
        _raises_or_decodes(bytes(data))


def test_threads_decode_side_by_side():
    import concurrent.futures as cf
    datas = [_bytes(e["name"]) for e in READ]
    want = [native.decode_webp(d) for d in datas]
    with cf.ThreadPoolExecutor(4) as pool:
        got = list(pool.map(native.decode_webp, datas * 2))
    for g, w in zip(got, want * 2):
        np.testing.assert_array_equal(g, w)


def test_unknown_formats_still_raise():
    with pytest.raises(NotImplementedError, match="decodes JPEG, PNG and webp"):
        timage.decode_image(b"GIF89a\x01\x00")
    with pytest.raises(ValueError, match="corrupt webp"):
        timage.decode_image(b"RIFF\x04\x00\x00\x00WEBP")


# ---------------------------------------------------------------------------
# LSUN on webp LMDBs, against the JAX package


def _write_jax_lsun_layout(data_dir, n: int = 6, size: int = 96) -> None:
    """The JAX package's LSUN test layout (``tests/test_lmdb.py``):
    data_dir/lsun/bedroom_train_lmdb with lossless webp values of random
    non-square images, written by its writer."""
    from smmdax.data.lmdb_store import write_lmdb
    rng = np.random.default_rng(7)
    items = {}
    for i in range(n):
        arr = rng.integers(0, 256, (size, size + 32, 3), dtype=np.uint8)
        items[f"img{i:04d}".encode()] = _webp(arr, lossless=True)
    write_lmdb(os.path.join(str(data_dir), "lsun", "bedroom_train_lmdb"), items.items())


def test_lsun_source_on_jax_lossless_layout_equals_jax(tmp_path):
    from smmdax.configs import Config as JConfig
    from smmdax.data import pipeline as jpipe
    from smmdax_torch.configs import Config
    from smmdax_torch.data import pipeline as tpipe
    _write_jax_lsun_layout(tmp_path)
    kw = dict(dataset="lsun", output_size=64, data_dir=str(tmp_path))
    jsrc, tsrc = jpipe.make_dataset(JConfig(**kw)), tpipe.make_dataset(Config(**kw))
    assert isinstance(tsrc, tpipe.LSUNSource)
    for key in (5, 6):
        assert tsrc.batch(8, key=key).tobytes() == jsrc.batch(8, key=key).tobytes()
        assert tsrc.batch_u8(8, key=key).tobytes() == jsrc.batch_u8(8, key=key).tobytes()
    env = str(tmp_path / "lsun" / "bedroom_train_lmdb")
    want = jpipe.LSUNSource(env, output_size=64).batch(8, key=5)
    assert tpipe.LSUNSource(env, output_size=64).batch(8, key=5).tobytes() == want.tobytes()


def test_lsun_lossy_lmdb_equals_jax_and_exact_at_native_size(tmp_path):
    """Lossy webp records (the official encoding) give JAX's batches; a
    lossless record at the output size comes back exactly."""
    from smmdax.data import pipeline as jpipe
    from smmdax.data.lmdb_store import write_lmdb
    from smmdax_torch.data import pipeline as tpipe
    rng = np.random.default_rng(3)
    env = str(tmp_path / "lossy_lmdb")
    write_lmdb(env, [(f"{i:04d}".encode(), _webp(_proc(rng, 70 + 3 * i, 90), quality=75))
                     for i in range(5)])
    jsrc, tsrc = jpipe.LSUNSource(env, output_size=32), tpipe.LSUNSource(env, output_size=32)
    assert tsrc.batch(6, key=2).tobytes() == jsrc.batch(6, key=2).tobytes()
    arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    exact = str(tmp_path / "exact_lmdb")
    write_lmdb(exact, [(b"only", _webp(arr, lossless=True))])
    out = tpipe.LSUNSource(exact, output_size=64).batch_u8(2, key=0)
    np.testing.assert_array_equal(out[0], arr)
    np.testing.assert_array_equal(out[1], arr)


def test_pack_lsun_webp_equals_jax(tmp_path):
    from smmdax.data import convert as jconvert
    from smmdax.data.lmdb_store import write_lmdb
    from smmdax_torch.data import convert as tconvert
    rng = np.random.default_rng(0)
    env = str(tmp_path / "lsun" / "bedroom_train_lmdb")
    write_lmdb(env, [(f"{i:04d}".encode(), _webp(_proc(rng, 80, 96 + 4 * i), quality=80,
                                                 lossless=bool(i % 2)))
                     for i in range(9)])
    want, got = str(tmp_path / "jax.npy"), str(tmp_path / "port.npy")
    jconvert.main(["lsun", env, want, "--size", "32", "--threads", "2"])
    tconvert.main(["lsun", env, got, "--size", "32", "--threads", "3"])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def _bench() -> None:
    """PIL's and the port's ms per image at 256 px on one thread."""
    rng = np.random.default_rng(0)
    arr = _proc(rng, 256, 256)
    native.decode_webp(_webp(arr))
    for label, opts in (("lossy q75", dict(quality=75)), ("lossless", dict(lossless=True))):
        data = _webp(arr, **opts)
        times = {}
        for name, fn in (("PIL", _pil), ("port", native.decode_webp)):
            fn(data)
            best = float("inf")
            for _ in range(5):
                t = time.perf_counter()
                for _ in range(40):
                    fn(data)
                best = min(best, (time.perf_counter() - t) / 40 * 1e3)
            times[name] = best
        print(f"256x256 {label} ({len(data)} bytes): PIL {times['PIL']:.3f} ms, "
              f"port {times['port']:.3f} ms, port/PIL {times['port'] / times['PIL']:.2f}")


if __name__ == "__main__":
    _bench()
