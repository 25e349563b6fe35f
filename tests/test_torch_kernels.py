"""The port's dense kernel oracle against ``smmdax.kernels``: Gram
blocks, MMD^2 (biased and unbiased) and the SMMD scale, values and input
gradients (rtol 1e-5).

MMD^2 subtracts block means that can be far larger than the result (the
energy distance: means near 3, MMD^2 near 0.08), so its value is held at
rtol 1e-5 of the largest block mean, the float32 cancellation bound."""

import jax
import numpy as np
import pytest
import torch

import smmdax.kernels as jk
import smmdax_torch.kernels as tk

KERNELS = [("gaussian", 0.0), ("rq", 0.0), ("rq", 0.5), ("dot", 0.0),
           ("distance", 0.0)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _xy(seed=0, m=24, n=20, d=6):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 0.7).astype(np.float32)
    y = (r.standard_normal((n, d)) * 0.7 + 0.3).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name,add_dot", KERNELS)
def test_kernel_matrices_and_cross(name, add_dot):
    x, y = _xy()
    want = jk.kernel_matrices(name, x, y, add_dot=add_dot)
    got = tk.kernel_matrices(name, torch.from_numpy(x), torch.from_numpy(y),
                             add_dot=add_dot)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert got.k_diag == want.k_diag
    cross = tk.kernel_cross(name, torch.from_numpy(x), torch.from_numpy(y),
                            add_dot=add_dot)
    np.testing.assert_allclose(
        cross.numpy(), np.asarray(jk.kernel_cross(name, x, y, add_dot=add_dot)), **TOL)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("name,add_dot", KERNELS)
def test_mmd2_value_and_input_gradients(name, add_dot, biased):
    x, y = _xy(1)

    def jloss(a, b):
        return jk.mmd2(jk.kernel_matrices(name, a, b, add_dot=add_dot), biased=biased)

    jval, (jgx, jgy) = jax.value_and_grad(jloss, argnums=(0, 1))(x, y)
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    val = tk.mmd2(tk.kernel_matrices(name, xt, yt, add_dot=add_dot), biased=biased)
    val.backward()
    blocks = tk.kernel_matrices(name, xt, yt, add_dot=add_dot)
    terms = max(abs(float(b.mean())) for b in blocks[:3])
    np.testing.assert_allclose(float(val), float(jval), rtol=TOL["rtol"],
                               atol=TOL["atol"] + TOL["rtol"] * terms)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgy), **TOL)


@pytest.mark.parametrize("variant", ["grad", "value_and_grad"])
def test_smmd_scale(variant):
    r = np.random.default_rng(2)
    g = r.uniform(0, 3, 16).astype(np.float32)
    v = r.uniform(0, 3, 16).astype(np.float32)
    want = jk.smmd_scale(g, v, 10.0, variant)
    got = tk.smmd_scale(torch.from_numpy(g), torch.from_numpy(v), 10.0, variant)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("k_diag", [None, 1.0])
def test_mmd2_from_blocks(biased, k_diag):
    """The blocks given one by one, with and without a constant diagonal
    (taken from the blocks' traces when None)."""
    x, y = _xy(3)
    blocks = jk.kernel_matrices("rq", x, y)
    k_xx, k_xy, k_yy = (np.array(b) for b in blocks[:3])
    want = jk.mmd2_from_blocks(k_xx, k_xy, k_yy, k_diag, biased=biased)
    got = tk.mmd2_from_blocks(*(torch.from_numpy(b) for b in (k_xx, k_xy, k_yy)), k_diag,
                              biased=biased)
    terms = max(abs(float(b.mean())) for b in (k_xx, k_xy, k_yy))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL["rtol"],
                               atol=TOL["atol"] + TOL["rtol"] * terms)
