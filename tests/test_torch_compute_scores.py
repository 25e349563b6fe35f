"""The port's scoring CLI (``python -m smmdax_torch.compute_scores``)
against the JAX package's ``compute_scores.py``: on precomputed features
both print the same FID, KID and ``--compare`` lines (float64 numpy arm
in both); with a random-weights Inception asset it scores images with
``inception_v3`` and prints IS, as the CLI's eval branch and the
trainer's scoring event do; a PNG directory decodes as PIL decodes it."""

import struct
import zlib

import numpy as np
import pytest

import compute_scores as jcs
from smmdax.eval.inception import random_state_dict
from smmdax_torch import compute_scores as tcs
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ["--n_subsets", "5", "--subset_size", "100", "--compare_test_size", "150"]


def _features(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for name, shift in (("real", 0.0), ("fake", 0.3), ("other", 0.5)):
        path = str(tmp_path / f"{name}.npy")
        np.save(path, (rng.normal(size=(240, 48)) + shift).astype(np.float32))
        paths.append(path)
    return paths


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_precomputed_features_print_jax_lines(tmp_path, capsys):
    real, fake, other = _features(tmp_path)
    argv = [real, fake, "--compare", other] + ARGS
    jcs.main(argv + ["--score_backend", "numpy"])
    want = _lines(capsys)
    tcs.main(argv + ["--score_backend", "numpy", "--device", "cpu"])
    got = _lines(capsys)
    assert [line.split(":")[0] for line in got] == [
        "FID", "KID", "relative-MMD test (FAKE closer than COMPARE?)",
        "(extractor"], got
    assert got == want
    # the torch arm (float32 Gram blocks) agrees to float32 rounding
    tcs.main(argv + ["--score_backend", "torch", "--device", "cpu"])
    torch_lines = _lines(capsys)
    assert torch_lines[-1] == want[-1]
    fid = float(torch_lines[0].split()[1])
    assert abs(fid - float(want[0].split()[1])) <= 1e-3
    kid = float(torch_lines[1].split()[1])
    assert abs(kid - float(want[1].split()[1])) <= 1e-5


def test_inception_asset_scores_images(tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    np.savez(data / "inception_v3.npz", **random_state_dict(seed=4, include_aux=False))
    rng = np.random.default_rng(1)
    for name in ("real", "fake"):
        np.save(tmp_path / f"{name}.npy", rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8))
    tcs.main([str(tmp_path / "real.npy"), str(tmp_path / "fake.npy"), "--data_dir", str(data),
              "--device", "cpu", "--n_subsets", "2"])
    out = _lines(capsys)
    assert out[-1] == "(extractor: inception_v3, n_real=3, n_fake=3)"
    scores = {line.split(":")[0]: float(line.split()[1]) for line in out[:-1]}
    assert set(scores) == {"FID", "KID", "IS"}
    assert all(np.isfinite(v) for v in scores.values()) and scores["IS"] >= 1.0 - 1e-6


def _png_rows(pixels, filt):
    """Scanlines of ``pixels`` (H, W, C) uint8 encoded with one PNG filter."""
    h, w, c = pixels.shape
    rows, prior = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = pixels[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if filt == 0:
            pred = np.zeros_like(cur)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        rows.append(bytes([filt]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(rows)


def _write_png(path, pixels, filt):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    h, w, c = pixels.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(_png_rows(pixels, filt)))
                + chunk(b"IEND", b""))


def test_png_directory_decodes_as_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:9, 0:11]
    smooth = np.stack([xx * 20, yy * 25, (xx + yy) * 12], -1).astype(np.uint8)
    d = tmp_path / "pngs"
    d.mkdir()
    i = 0
    for channels in (1, 3, 4):
        for filt in range(5):
            noise = rng.integers(0, 256, (9, 11, channels), dtype=np.uint8)
            px = np.where(rng.random((9, 11, 1)) < 0.3, noise, smooth[..., :channels] if
                          channels <= 3 else np.concatenate([smooth, noise[..., :1]], -1))
            _write_png(str(d / f"{i:02d}.png"), px.astype(np.uint8), filt)
            i += 1
    for mode in ("L", "RGB", "RGBA"):          # PIL's own encoder picks the filters
        arr = rng.integers(0, 256, (9, 11, len(mode)), dtype=np.uint8)
        Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(d / f"{i:02d}.png")
        i += 1
    got = tcs._load(str(d))
    assert got.shape == (i, 9, 11, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jcs._load(str(d)))


@pytest.mark.parametrize("case", ["jpeg", "mixed sizes"])
def test_unreadable_directories_raise(tmp_path, case):
    from smmdax_torch.utils import write_png
    write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.uint8))
    if case == "jpeg":
        (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff")
    else:
        write_png(str(tmp_path / "b.png"), np.zeros((5, 4, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="ROADMAP: image readers"):
        tcs._load(str(tmp_path))

def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no images"):
        tcs._load(str(tmp_path))


def test_cli_eval_branch_scores_with_inception(tmp_path, capsys):
    """``python -m smmdax_torch.main --is_train false --compute_scores true``
    scores with Inception (and prints IS) when its asset is in --data_dir."""
    from smmdax_torch.main import main
    np.savez(tmp_path / "inception_v3.npz", **random_state_dict(seed=4, include_aux=False))
    main(["--is_train", "false", "--compute_scores", "true", "--device", "cpu",
          "--dataset", "synthetic", "--architecture", "resnet", "--gf_dim", "8",
          "--df_dim", "8", "--z_dim", "8", "--batch_size", "4", "--no_of_samples", "4",
          "--data_dir", str(tmp_path), "--checkpoint_dir", str(tmp_path / "ck"),
          "--sample_dir", str(tmp_path / "s")])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "[extractor=inception_v3]" in line and " IS=" in line, line


def test_trainer_scores_with_inception(tmp_path):
    """The trainer's scoring event uses Inception when its asset is in
    data_dir, and its log row carries the IS columns."""
    import json
    from smmdax_torch.configs import Config
    from smmdax_torch.eval.features import InceptionFeatures
    from smmdax_torch.trainer import Trainer
    np.savez(tmp_path / "inception_v3.npz", **random_state_dict(seed=4, include_aux=False))
    cfg = Config(dataset="synthetic", architecture="resnet", model="mmd", gf_dim=8, df_dim=8,
                 dof_dim=4, z_dim=8, batch_size=4, real_batch_size=4, max_iteration=2,
                 dsteps=1, warmup_iterations=0, log_every=2, sample_every=0,
                 checkpoint_every=0, compute_scores=True, score_every=2, no_of_samples=6,
                 score_subsets=2, MMD_lr_scheduler=False, data_dir=str(tmp_path),
                 checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "l"),
                 sample_dir=str(tmp_path / "s"))
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert isinstance(trainer._extractor, InceptionFeatures)
    with open(trainer.writer.path) as f:
        row = [r for r in map(json.loads, f) if "fid" in r][-1]
    assert row["step"] == 2 and trainer._real_feats.shape == (6, 2048)
    assert {"kid", "inception_score", "inception_score_std"} <= set(row)
    assert all(np.isfinite(v) for v in row.values())
