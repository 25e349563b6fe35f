"""The port's Sutherland variance and t-ratio (``smmdax_torch.kernels.mmd``)
against ``smmdax.kernels.mmd`` on the same numpy inputs: every
``VarStats`` field, ``mmd2_and_variance`` (biased and unbiased) and
``mmd2_and_ratio`` in value and gradient, for the four kernels and rq with
add_dot.

Tolerances: statistics and values rel 2e-4 / abs 1e-5 (tests/test_pallas.py);
the variance rel 1e-3: it is a difference of terms up to ~100x larger, and
in float32 it lies up to 2.0e-4 (port) and 4.7e-5 (JAX) from its float64
value, 2.5e-4 apart (measured, gaussian at 48x8); it is also held to the
port's own float64 evaluation at rel 5e-4; the ratio rel 5e-4; ratio
gradients rtol 1e-3 plus 1e-4 of their largest entry (the variance
formula's cancellations amplify float32 summation-order differences, as
tests/test_ring.py:138-140 notes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmdax.kernels import kernel_matrices as jkm
from smmdax.kernels import mmd as jmmd
from smmdax_torch.kernels import kernel_matrices as tkm
from smmdax_torch.kernels import mmd as tmmd

CASES = [("gaussian", 0.0), ("rq", 0.0), ("rq", 0.3), ("dot", 0.0), ("distance", 0.0)]
IDS = ["gaussian", "rq", "rq+add_dot", "dot", "distance"]


def _xy(seed, m=48, d=8):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 0.6).astype(np.float32)
    y = (r.standard_normal((m, d)) * 0.6 + 0.4).astype(np.float32)
    return x, y


@pytest.mark.parametrize("kernel,add_dot", CASES, ids=IDS)
def test_var_stats_match(kernel, add_dot):
    x, y = _xy(0)
    want = jmmd.var_stats_from_blocks(jkm(kernel, x, y, add_dot=add_dot))
    got = tmmd.var_stats_from_blocks(tkm(kernel, torch.from_numpy(x),
                                         torch.from_numpy(y), add_dot=add_dot))
    assert set(want._fields) == set(got._fields)
    for field in want._fields:
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)),
                                   rtol=2e-4, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("kernel,add_dot", CASES, ids=IDS)
def test_mmd2_and_variance_match(kernel, add_dot, biased):
    x, y = _xy(1)
    wv, wvar = jmmd.mmd2_and_variance(jkm(kernel, x, y, add_dot=add_dot), biased=biased)
    gv, gvar = tmmd.mmd2_and_variance(tkm(kernel, torch.from_numpy(x), torch.from_numpy(y),
                                          add_dot=add_dot), biased=biased)
    _, dvar = tmmd.mmd2_and_variance(tkm(kernel, torch.from_numpy(x).double(),
                                         torch.from_numpy(y).double(), add_dot=add_dot),
                                     biased=biased)
    assert float(gv) == pytest.approx(float(wv), rel=2e-4, abs=1e-5)
    assert float(gvar) == pytest.approx(float(wvar), rel=1e-3)
    assert float(gvar) == pytest.approx(float(dvar), rel=5e-4)


@pytest.mark.parametrize("kernel,add_dot", CASES, ids=IDS)
def test_mmd2_and_ratio_value_and_gradient_match(kernel, add_dot):
    x, y = _xy(2)

    def jratio(a, b):
        return jmmd.mmd2_and_ratio(jkm(kernel, a, b, add_dot=add_dot))[1]

    wv, wr = jmmd.mmd2_and_ratio(jkm(kernel, x, y, add_dot=add_dot))
    wgx, wgy = jax.grad(jratio, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    gv, gr = tmmd.mmd2_and_ratio(tkm(kernel, xt, yt, add_dot=add_dot))
    gx, gy = torch.autograd.grad(gr, (xt, yt))
    gv, gr = gv.detach(), gr.detach()
    assert float(gv) == pytest.approx(float(wv), rel=2e-4, abs=1e-5)
    # the ratio carries the variance's float32 error halved (sqrt)
    assert float(gr) == pytest.approx(float(wr), rel=5e-4)
    for got, want in ((gx, wgx), (gy, wgy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())


def test_ratio_floors_the_variance():
    """A variance below min_var_est is replaced by it (mmd2 / sqrt(1e-8))."""
    x, _ = _xy(3)
    blocks = tkm("rq", torch.from_numpy(x), torch.from_numpy(x))
    val, ratio = tmmd.mmd2_and_ratio(blocks, min_var_est=1.0)
    assert float(ratio) == pytest.approx(float(val), rel=1e-6)
    with pytest.raises(ValueError, match="m == n"):
        tmmd.var_stats_from_blocks(tkm("rq", torch.from_numpy(x), torch.from_numpy(x[:10])))
