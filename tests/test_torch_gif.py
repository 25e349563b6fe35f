"""The toy's GIF (``smmdax_torch/gif.py``, ``viz.assemble_toy_animation``)
against the JAX package's PIL-written one, on matplotlib frames drawn here
by both packages' ``plot_toy_frame`` (plus a repeated frame, which both
merge, and a smaller few-colour frame): PIL reads the port's GIF with
JAX's frame count, size, per-frame durations and loop; a frame of at most
256 colours decodes exactly; on the others the mean absolute error against
the PNG is at most JAX's plus half a grey level.  The committed frames
(``tests/fixtures/port_gif``) give the GIF whose SHA-256 the manifest
records."""

import hashlib
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

Image = pytest.importorskip("PIL.Image")
pytest.importorskip("matplotlib")

from smmdax import viz as jviz  # noqa: E402
from smmdax.configs import Config as JConfig  # noqa: E402
from smmdax_torch import viz as tviz  # noqa: E402
from smmdax_torch.configs import Config  # noqa: E402
from smmdax_torch.gif import lzw, quantize  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "port_gif")
TOY = dict(dataset="gaussian_mix", architecture="mlp", model="mmd", kernel="gaussian",
           rbf_sigmas=(0.1, 0.25, 0.5, 1.0), z_dim=8, dof_dim=8)


def _frames(path):
    """PIL's reading of a GIF: (size, loop, [(duration, RGB canvas)])."""
    im = Image.open(path)
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append((im.info.get("duration"), np.asarray(im.convert("RGB"))))
    return im.size, im.info.get("loop"), out


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """Two frames from each package's plot_toy_frame, one repeated, and a
    smaller frame of 4 colours."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    real = rng.normal(0, 0.3, (256, 1)).astype(np.float32)
    w = np.full((1, 4), 0.5, np.float32)
    tcritic = lambda x: torch.as_tensor(x).reshape(len(x), -1) @ torch.as_tensor(w)  # noqa: E731
    jcritic = lambda x: jnp.asarray(x).reshape(len(x), -1) @ jnp.asarray(w)  # noqa: E731
    for step, shift in ((10, 0.5), (20, 0.2)):
        fake = rng.normal(shift, 0.3, (256, 1)).astype(np.float32)
        tviz.plot_toy_frame(Config(**TOY), tcritic, real, fake, step, str(d))
    for step, shift in ((30, -0.1), (40, -0.3)):
        fake = rng.normal(shift, 0.3, (256, 1)).astype(np.float32)
        jviz.plot_toy_frame(JConfig(**TOY), jcritic, real, fake, step, str(d))
    shutil.copy(d / "toy_0000040.png", d / "toy_0000050.png")
    pal = np.array([[255, 255, 255, 255], [0, 0, 0, 255], [200, 30, 30, 255],
                    [30, 30, 200, 255]], np.uint8)
    small = pal[(np.add.outer(np.arange(120), np.arange(200)) // 7) % 4]
    Image.fromarray(small, "RGBA").save(d / "toy_0000060.png")
    return d


@pytest.fixture(scope="module")
def gifs(frames_dir, tmp_path_factory):
    out = {}
    for name, fn in (("jax", jviz.assemble_toy_animation), ("port", tviz.assemble_toy_animation)):
        d = tmp_path_factory.mktemp(name)
        for f in os.listdir(frames_dir):
            shutil.copy(frames_dir / f, d)
        out[name] = fn(str(d))
        assert out[name] == str(d / "toy_animation.gif")
    return out


def test_pil_reads_jax_layout(gifs):
    jsize, jloop, jframes = _frames(gifs["jax"])
    tsize, tloop, tframes = _frames(gifs["port"])
    assert (tsize, tloop) == (jsize, jloop) and tloop == 0
    assert [d for d, _ in tframes] == [d for d, _ in jframes]
    assert len(tframes) == 5 and tframes[3][0] == 400


def test_frames_exact_or_no_worse_than_jax(gifs, frames_dir):
    _, _, jframes = _frames(gifs["jax"])
    _, _, tframes = _frames(gifs["port"])
    pngs = [np.asarray(Image.open(frames_dir / f).convert("RGB"))
            for f in sorted(os.listdir(frames_dir))]
    del pngs[4]                                        # merged with the one before
    canvas = pngs[0].shape[:2]
    exact = 0
    for png, (_, jf), (_, tf) in zip(pngs, jframes, tframes):
        h, w = min(png.shape[0], canvas[0]), min(png.shape[1], canvas[1])
        png, jf, tf = png[:h, :w].astype(int), jf[:h, :w].astype(int), tf[:h, :w].astype(int)
        if len(np.unique((png[..., 0] << 16) | (png[..., 1] << 8) | png[..., 2])) <= 256:
            np.testing.assert_array_equal(tf, png)
            exact += 1
        else:
            assert np.abs(tf - png).mean() <= np.abs(jf - png).mean() + 0.5
    assert exact >= 1


def test_lzw_and_quantize_round_trip(tmp_path):
    """Exact palettes up to 256 colours and LZW past the 4096-code table
    (clear codes), read back by PIL."""
    from smmdax_torch.gif import write_gif
    rng = np.random.default_rng(1)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    frames = [pal[rng.integers(0, 256, (150, 170))], pal[:2][rng.integers(0, 2, (150, 170))]]
    write_gif(str(tmp_path / "a.gif"), frames, 70)
    size, loop, got = _frames(str(tmp_path / "a.gif"))
    assert size == (170, 150) and loop == 0 and [d for d, _ in got] == [70, 70]
    for f, (_, g) in zip(frames, got):
        np.testing.assert_array_equal(g, f)
    p, idx = quantize(frames[1])
    assert len(p) == 2 and lzw(idx, 2)[:1] != b""


def test_committed_frames_give_recorded_gif(tmp_path):
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name in manifest["frames"]:
        shutil.copy(os.path.join(FIXTURES, name), tmp_path)
    path = tviz.assemble_toy_animation(str(tmp_path), manifest["duration_ms"])
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == manifest["gif_sha256"]
    size, loop, got = _frames(path)
    assert len(got) == len(manifest["frames"]) and loop == 0
    assert sorted(p for p in os.listdir(FIXTURES) if p.endswith(".png")) == manifest["frames"]
