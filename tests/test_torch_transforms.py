"""The port's image transforms (``smmdax_torch.data.transforms``, torch,
(B, H, W, C)) against the JAX package's ``smmdax/data/transforms.py`` to
1e-6: the deterministic ones on the same batch, the random ones on the
flags and offsets JAX's own draws give (rebuilt here from its key)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmdax.data import transforms as jt
from smmdax_torch.data import transforms as tt
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-6


def _batch(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_normalize_and_center_crop():
    raw = _batch((3, 20, 17, 3))
    _close(tt.normalize_uint8(torch.from_numpy(raw)), jt.normalize_uint8(jnp.asarray(raw)))
    x = np.array(jt.normalize_uint8(jnp.asarray(raw)))
    for crop in (16, 9, 1):
        _close(tt.center_crop(torch.from_numpy(x), crop), jt.center_crop(jnp.asarray(x), crop))


@pytest.mark.parametrize("h, out", [(32, 16), (160, 40), (8, 8)])
def test_resize_down_pow2(h, out):
    x = np.array(jt.normalize_uint8(jnp.asarray(_batch((2, h, h, 3), 1))))
    _close(tt.resize_down_pow2(torch.from_numpy(x), out), jt.resize_down_pow2(jnp.asarray(x), out))
    with pytest.raises(ValueError, match="2\\^k"):
        tt.resize_down_pow2(torch.from_numpy(x), 3 if h % 3 else 5)


@pytest.mark.parametrize("h, w, out", [(32, 32, 20), (24, 40, 33), (17, 9, 64), (64, 64, 7)])
def test_resize_bilinear_antialiased(h, w, out):
    x = np.array(jt.normalize_uint8(jnp.asarray(_batch((2, h, w, 3), 2))))
    _close(tt.resize_bilinear(torch.from_numpy(x), out), jt.resize_bilinear(jnp.asarray(x), out))


def _jax_flips(key, b):
    return np.array(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))).reshape(b)


def test_random_flip_and_crop_on_jax_draws():
    x = np.array(jt.normalize_uint8(jnp.asarray(_batch((6, 12, 10, 3), 3))))
    key = jax.random.PRNGKey(5)
    flips = torch.from_numpy(_jax_flips(key, 6))
    _close(tt.random_flip(torch.from_numpy(x), flips=flips), jt.random_flip(jnp.asarray(x), key))
    kt, kl = jax.random.split(key)
    tops = torch.from_numpy(np.array(jax.random.randint(kt, (6,), 0, 12 - 7 + 1)))
    lefts = torch.from_numpy(np.array(jax.random.randint(kl, (6,), 0, 10 - 7 + 1)))
    _close(tt.random_crop(torch.from_numpy(x), 7, tops=tops, lefts=lefts),
           jt.random_crop(jnp.asarray(x), 7, key))
    # from a torch.Generator: flags and offsets in range, repeatable
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tt.random_crop(torch.from_numpy(x), 7, generator=g())
    assert a.shape == (6, 7, 7, 3) and torch.equal(a, tt.random_crop(torch.from_numpy(x), 7,
                                                                     generator=g()))
    assert torch.equal(tt.random_flip(torch.from_numpy(x), g()),
                       tt.random_flip(torch.from_numpy(x), g()))


@pytest.mark.parametrize("crop, out_size, flip", [(None, None, False), (140, 70, True),
                                                  (160, 40, False), (96, 50, True)])
def test_standard_pipeline(crop, out_size, flip):
    raw = _batch((4, 178, 160, 3), 4)
    key = jax.random.PRNGKey(9)
    want = jt.standard_pipeline(jnp.asarray(raw), key, crop=crop, out_size=out_size, flip=flip)
    flips = torch.from_numpy(_jax_flips(key, 4)) if flip else None
    got = tt.standard_pipeline(torch.from_numpy(raw), crop=crop, out_size=out_size, flip=flip,
                               flips=flips)
    _close(got, want)
