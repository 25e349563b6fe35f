"""The port's random-conv feature extractor, extractor dispatch (Inception
when its asset loads) and PNG / metric writers (``smmdax_torch.eval.features``, ``smmdax_torch.utils``)
against the JAX package.

``RandomConvFeatures`` loaded with the JAX extractor's weights is held to
JAX's features at rel 1e-5 of the largest feature (measured 1.3e-6 at
32x32x3 and 1.3e-6 at 15x15x3: float32 convolutions in both, summed in
another order).  The odd size pads 1 / 1, the even one 0 / 1.
"""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from smmdax import utils as jutils
from smmdax.eval.features import RandomConvFeatures as JRandomConv
from smmdax_torch import utils as tutils
from smmdax_torch.convert import random_conv_weights_from_jax
from smmdax_torch.eval import features as tfeatures
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FEATURE_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_extractor():
    return JRandomConv()


@pytest.mark.parametrize("size", [32, 15])
def test_random_conv_matches_jax(jax_extractor, size):
    imgs = np.random.default_rng(size).uniform(-1, 1, (10, size, size, 3)).astype(np.float32)
    want = jax_extractor(imgs)
    port = tfeatures.RandomConvFeatures(device="cpu",
                                        weights=random_conv_weights_from_jax(jax_extractor))
    got = port(imgs)
    assert got.shape == want.shape == (10, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_RTOL * np.abs(want).max())
    # a tensor runs where it lives and, without fetch, stays a tensor
    t = port(torch.from_numpy(imgs), fetch=False)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)


def test_same_pad_splits_like_xla():
    assert tfeatures._same_pad(32) == (0, 1)
    assert tfeatures._same_pad(15) == (1, 1)
    assert tfeatures._same_pad(1) == (1, 1)


def test_default_weights_fixed_by_seed():
    imgs = np.random.default_rng(1).uniform(-1, 1, (300, 16, 16, 3)).astype(np.float32)
    a = tfeatures.RandomConvFeatures(device="cpu", batch=128)(imgs)
    b = tfeatures.RandomConvFeatures(device="cpu")(imgs)
    assert a.shape == (300, 256)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    c = tfeatures.RandomConvFeatures(device="cpu", seed=7)(imgs)
    assert not np.allclose(a, c)


def test_get_feature_extractor(tmp_path, capsys):
    """As the JAX package: no asset gives random conv features; a valid
    ``.npz`` gives Inception; a corrupt one prints and falls back to random
    conv; ``prefer_inception=False`` gives random conv."""
    from smmdax.eval.inception import random_state_dict
    ext = tfeatures.get_feature_extractor(str(tmp_path), device="cpu")
    assert isinstance(ext, tfeatures.RandomConvFeatures) and ext.name == "random_conv"
    np.savez(tmp_path / "inception_v3.npz", **random_state_dict(seed=2, include_aux=False))
    assert tfeatures.find_inception_weights(str(tmp_path)).endswith("inception_v3.npz")
    ext = tfeatures.get_feature_extractor(str(tmp_path), device="cpu")
    assert isinstance(ext, tfeatures.InceptionFeatures) and ext.name == "inception_v3"
    assert ext.batch == 64 and ext.feature_dim == 2048 and ext._net.fid_semantics is False
    assert tfeatures.get_feature_extractor(str(tmp_path), fid_semantics=True,
                                           device="cpu")._net.fid_semantics is True
    ext = tfeatures.get_feature_extractor(str(tmp_path), prefer_inception=False, device="cpu")
    assert isinstance(ext, tfeatures.RandomConvFeatures)
    (tmp_path / "inception_v3.pt").write_bytes(b"\0")      # found first, and corrupt
    assert tfeatures.find_inception_weights(str(tmp_path)).endswith("inception_v3.pt")
    capsys.readouterr()
    ext = tfeatures.get_feature_extractor(str(tmp_path), device="cpu")
    assert isinstance(ext, tfeatures.RandomConvFeatures)
    assert "Inception load failed" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="inception_v3.pth"):
        tfeatures.InceptionFeatures(str(tmp_path / "inception_v3.pth"), device="cpu")


def test_extract_with_probs_threads_fetch():
    class Probs:
        name, feature_dim = "stub", 2

        def __call__(self, imgs, fetch=True):
            return ("feats", fetch)

        def probs(self, imgs):
            return "probs"

    assert tfeatures.extract_with_probs(Probs(), None, fetch=False) == (("feats", False), "probs")
    assert tfeatures.extract_features(lambda imgs: "plain", None, fetch=False) == "plain"


def _read_png(path):
    """(width, height, color type, pixel rows) of an 8-bit PNG, decoded
    with zlib; checks every chunk's CRC and that each row is unfiltered."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, comp, filt, interlace) == (8, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return w, h, color, raw[:, 1:]


@pytest.mark.parametrize("channels", [1, 3])
def test_save_images_png_round_trip(tmp_path, channels):
    imgs = np.random.default_rng(channels).uniform(-1, 1, (5, 6, 7, channels))
    path = str(tmp_path / "sub" / "grid.png")
    tutils.save_images(imgs, path, nrow=3)
    grid = jutils.make_grid(jutils.inverse_transform(imgs), nrow=3)
    np.testing.assert_array_equal(tutils.make_grid(tutils.inverse_transform(imgs), nrow=3), grid)
    want = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    w, h, color, rows = _read_png(path)
    assert (w, h) == (want.shape[1], want.shape[0])
    assert color == (0 if channels == 1 else 2)
    np.testing.assert_array_equal(rows.reshape(want.shape), want)


def test_write_png_rejects_other_layouts(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        tutils.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))


def test_metric_writer(tmp_path, capsys):
    w = tutils.MetricWriter(str(tmp_path), "run")
    w.write(113000, {"kid": 0.5, "n": 3})
    w.close()
    rec = json.loads(open(w.path).read())
    assert rec["step"] == 113000 and rec["kid"] == 0.5
    assert "step=113000 kid=0.5" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="TensorBoard"):
        tutils.MetricWriter(str(tmp_path), "run", tensorboard=True)
