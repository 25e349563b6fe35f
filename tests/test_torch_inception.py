"""The port's Inception-v3 (``smmdax_torch.eval.inception``) against the
JAX package's (``smmdax/eval/inception.py``), on the random
torchvision-schema weights both packages draw from one seed.

The spec table, ``random_state_dict`` and the BN-folding converter are
held bit for bit (the converter after HWIO -> OIHW).  The forward is held
at rel 1e-4 of each output's largest entry (measured ~1e-6 at 75 and 299
px: float32 convolutions in both, summed in another order), ``preprocess``
at rel 1e-5 (measured 1.8e-7).
"""

import numpy as np
import pytest
import torch

from smmdax.eval import inception as jinc
from smmdax_torch.convert import inception_params_from_jax
from smmdax_torch.eval import inception as tinc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FORWARD_RTOL = 1e-4
PREPROCESS_RTOL = 1e-5


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _oihw(jparams):
    return {k: {"w": np.asarray(v["w"]) if k == "fc" else np.asarray(v["w"]).transpose(3, 2, 0, 1),
                "b": np.asarray(v["b"])} for k, v in jparams.items()}


def _equal_params(got, want):
    assert got.keys() == want.keys()
    for k in want:
        for leaf in ("w", "b"):
            assert got[k][leaf].dtype == np.float32, k
            np.testing.assert_array_equal(got[k][leaf], want[k][leaf], err_msg=f"{k}.{leaf}")


@pytest.fixture(scope="module")
def params():
    state = jinc.random_state_dict(seed=7)
    return {fid: jinc.convert_torchvision_state_dict(
                jinc.random_state_dict(seed=7 + fid, num_classes=1008 if fid else 1000))
            for fid in (False, True)} | {"state": state}


def test_spec_table_equals_jax():
    assert tinc.conv_specs() == jinc.conv_specs()
    assert tinc.BN_EPS == jinc.BN_EPS
    np.testing.assert_array_equal(tinc.IMAGENET_MEAN, jinc.IMAGENET_MEAN)
    np.testing.assert_array_equal(tinc.IMAGENET_STD, jinc.IMAGENET_STD)


@pytest.mark.parametrize("seed,aux,classes", [(0, True, 1000), (3, False, 1008)])
def test_random_state_dict_equals_jax(seed, aux, classes):
    want = jinc.random_state_dict(seed=seed, include_aux=aux, num_classes=classes)
    got = tinc.random_state_dict(seed=seed, include_aux=aux, num_classes=classes)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("classes", [1000, 1008])
def test_converter_equals_jax(classes):
    state = jinc.random_state_dict(seed=5, num_classes=classes)
    got = tinc.convert_torchvision_state_dict(state)
    _equal_params(got, _oihw(jinc.convert_torchvision_state_dict(state)))
    assert got["fc"]["w"].shape == (2048, classes)
    # torch tensors convert as arrays do
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    _equal_params(tinc.convert_torchvision_state_dict(tensors), got)


@pytest.mark.parametrize("key,shape,match", [
    ("Conv2d_1a_3x3.conv.weight", (32, 3, 5, 5), "Conv2d_1a_3x3"),
    ("fc.weight", (1000, 1024), "fc.weight")])
def test_converter_rejects_bad_shapes(key, shape, match):
    state = jinc.random_state_dict(seed=3, include_aux=False)
    state[key] = np.zeros(shape, np.float32)
    for convert in (jinc.convert_torchvision_state_dict, tinc.convert_torchvision_state_dict):
        with pytest.raises(ValueError, match=match):
            convert(state)


@pytest.mark.parametrize("size", [299, 75])
@pytest.mark.parametrize("fid", [False, True], ids=["torchvision", "fid"])
def test_forward_matches_jax(params, size, fid):
    jp = params[fid]
    x = np.random.default_rng(size + fid).uniform(-1.5, 1.5, (2, size, size, 3)).astype(np.float32)
    want_pool, want_logits = jinc.forward(jp, x, fid_semantics=fid)
    net = tinc.InceptionV3(inception_params_from_jax(jp), device="cpu", fid_semantics=fid)
    with torch.no_grad():
        pool, logits = tinc.forward(net.params(), torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                    fid_semantics=fid)
    assert pool.shape == (2, 2048) and logits.shape == (2, 1008 if fid else 1000)
    _close(pool.numpy(), want_pool, FORWARD_RTOL)
    _close(logits.numpy(), want_logits, FORWARD_RTOL)


@pytest.mark.parametrize("size", [32, 320])
def test_preprocess_matches_jax(size):
    imgs = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jinc.preprocess(imgs)).transpose(0, 3, 1, 2)
    got = tinc.preprocess(torch.from_numpy(imgs))
    assert got.shape == (2, 3, 299, 299) and got.is_contiguous()
    _close(got.numpy(), want, PREPROCESS_RTOL)


def test_pool3_and_probs_ragged_matches_jax(params, monkeypatch):
    jp = params[False]
    imgs = np.random.default_rng(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    want_pool, want_probs = jinc.InceptionV3(jp, batch=2).pool3_and_probs(imgs)
    net = tinc.InceptionV3(tinc.convert_torchvision_state_dict(params["state"]), batch=2,
                           device="cpu")
    assert net.fid_semantics is False and net.batch == 2
    # the sweep runs with TF32 off and leaves the flags as it found them
    seen = []
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    run = tinc.forward
    monkeypatch.setattr(tinc, "forward", lambda *a, **k: (
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)),
        run(*a, **k))[1])
    pool, probs = net.pool3_and_probs(imgs)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    # allow_tf32 (the timing arm) runs it with TF32 on, whatever the caller set
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tinc.InceptionV3(net.params(), device="cpu", allow_tf32=True).pool3(imgs[:1])
    assert seen[-1] == (True, True)
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert isinstance(pool, np.ndarray) and pool.dtype == probs.dtype == np.float32
    _close(pool, want_pool, FORWARD_RTOL)
    np.testing.assert_allclose(probs, want_probs, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    # fetch=False: float32 tensors, a float32 softmax
    t_pool, t_probs = net.pool3_and_probs(torch.from_numpy(imgs), fetch=False)
    assert isinstance(t_pool, torch.Tensor) and t_probs.dtype == torch.float32
    np.testing.assert_array_equal(t_pool.numpy(), pool)
    np.testing.assert_allclose(t_probs.numpy(), probs, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(net.pool3(imgs[:2]), pool[:2])
    np.testing.assert_array_equal(net.probs(imgs[2:]), probs[2:])
    empty = net.pool3_and_probs(np.zeros((0, 32, 32, 3), np.float32))
    assert empty[0].shape == (0, 2048) and empty[1].shape == (0, 1000)


@pytest.mark.parametrize("ext", ["npz", "pt"])
def test_load_params_round_trip(tmp_path, params, ext):
    state = params["state"]
    path = str(tmp_path / f"inception_v3.{ext}")
    if ext == "npz":
        np.savez(path, **state)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)
    got = tinc.load_params(path)
    _equal_params(got, tinc.convert_torchvision_state_dict(state))
    if ext == "npz":
        _equal_params(got, _oihw(jinc.load_params(path)))


def test_fid_semantics_from_fc_width(params):
    p1000 = tinc.convert_torchvision_state_dict(params["state"])
    p1008 = inception_params_from_jax(params[True])
    assert tinc.InceptionV3(p1000, device="cpu").fid_semantics is False
    assert tinc.InceptionV3(p1008, device="cpu").fid_semantics is True
    assert tinc.InceptionV3(p1008, device="cpu", fid_semantics=False).fid_semantics is False
    assert tinc.InceptionV3(p1000, device="cpu", fid_semantics=True).fid_semantics is True


def test_params_from_jax_give_jax_features(params):
    jp = params[True]
    got = inception_params_from_jax(jp)
    _equal_params(got, _oihw(jp))
    imgs = np.random.default_rng(4).uniform(-1, 1, (2, 80, 80, 3)).astype(np.float32)
    want_pool, want_logits = jinc.forward(jp, jinc.preprocess(imgs, size=80), fid_semantics=True)
    net = tinc.InceptionV3(got, device="cpu")
    with torch.no_grad():
        x = tinc.preprocess(torch.from_numpy(imgs), size=80)
        pool, logits = tinc.forward(net.params(), x, fid_semantics=net.fid_semantics)
    _close(pool.numpy(), want_pool, FORWARD_RTOL)
    _close(logits.numpy(), want_logits, FORWARD_RTOL)
    # float64 buffers: the same network in double precision
    net64 = tinc.InceptionV3(got, device="cpu", dtype=torch.float64)
    assert net64.dtype == torch.float64 and net64.fc_w.dtype == torch.float64
    with torch.no_grad():
        pool64, _ = tinc.forward(net64.params(), x.double(), fid_semantics=True)
    _close(pool64.numpy(), want_pool, FORWARD_RTOL)
