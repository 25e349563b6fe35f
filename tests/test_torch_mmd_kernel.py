"""The port's fused MMD path (``smmdax_torch.cuda.mmd_kernel``) against
``smmdax.pallas`` in interpret mode.

On the CPU the wrappers run their kernels' plain versions, so these
tests hold the plain versions and the autograd.Function around them to
the TPU kernels' semantics, with the cases and tolerances of
tests/test_pallas.py (plus rq with add_dot).  The comparison of the CUDA
kernels with their plain versions needs the card (marker ``cuda``)."""

import jax
import numpy as np
import pytest
import torch

import smmdax.pallas.mmd_kernel as pk
from smmdax_torch.cuda import dispatch
from smmdax_torch.cuda import mmd_kernel as tk

CASES = [("gaussian", (1.0, 2.0, 4.0, 8.0, 16.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.5),
         ("distance", (), 0.0),
         ("dot", (), 0.0)]


@pytest.fixture(scope="module")
def pallas_interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _xy(seed, m, n, d, scale=0.7, shift=0.3):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * scale).astype(np.float32)
    y = (r.standard_normal((n, d)) * scale + shift).astype(np.float32)
    return x, y


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("kernel,params,add_dot", CASES)
@pytest.mark.parametrize("m,n,d", [(64, 64, 16), (100, 60, 16)])
def test_fused_mmd2_matches_pallas(kernel, params, add_dot, m, n, d):
    x, y = _xy(0, m, n, d)
    want = float(pk.fused_mmd2(x, y, kernel, params, add_dot=add_dot))
    got = float(tk.fused_mmd2(torch.from_numpy(x), torch.from_numpy(y),
                              kernel, params, add_dot=add_dot))
    assert got == pytest.approx(want, rel=2e-4, abs=1e-5)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("kernel,params,add_dot", CASES)
def test_fused_mmd2_biased_matches_pallas(kernel, params, add_dot):
    x, y = _xy(1, 48, 48, 8, scale=1.0, shift=0.5)
    want = float(pk.fused_mmd2(x, y, kernel, params, biased=True, add_dot=add_dot))
    got = float(tk.fused_mmd2(torch.from_numpy(x), torch.from_numpy(y), kernel,
                              params, biased=True, add_dot=add_dot))
    assert got == pytest.approx(want, rel=2e-4, abs=1e-5)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("kernel,params,add_dot", CASES)
def test_fused_gradients_match_pallas(kernel, params, add_dot):
    x, y = _xy(2, 40, 56, 12, scale=0.5, shift=0.2)
    gx, gy = jax.grad(lambda a, b: pk.fused_mmd2(a, b, kernel, params,
                                                 add_dot=add_dot),
                      argnums=(0, 1))(x, y)
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    tk.fused_mmd2(xt, yt, kernel, params, add_dot=add_dot).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=2e-4, atol=1e-6)


def test_cpu_uses_plain_versions_and_counts_no_launch():
    before = (tk.pair_sum.launches, tk.pair_sum_grad_a.launches)
    x, y = _xy(3, 32, 32, 8)
    xt = torch.from_numpy(x).requires_grad_()
    tk.fused_mmd2(xt, torch.from_numpy(y)).backward()
    assert (tk.pair_sum.launches, tk.pair_sum_grad_a.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tk.pair_sum(a, torch.zeros(4, 2), "rq", (1.0,), False)
    with pytest.raises(ValueError):
        tk.pair_sum(a, a, "rq", tuple(range(1, 10)), False)
    with pytest.raises(ValueError):
        tk.pair_sum(a, a, "gaussian", (1.0,), False, add_dot=0.5)
    with pytest.raises(ValueError):
        tk.pair_sum(a.to("meta"), a.to("meta"), "rq", (1.0,), False)


def test_dispatch_semantics():
    sp = dispatch.should_use_pallas
    assert sp("on", "rq", 8, 8) and not sp("off", "rq", 8, 8, platform="cuda")
    assert not sp("auto", "rq", 10**6, 10**6, platform="cpu")
    assert sp("auto", "rq", 64, 64, platform="cuda")          # default 0 rows
    assert not sp("auto", "rq", 64, 64, min_rows=4096, platform="cuda")
    with pytest.raises(ValueError):
        sp("sometimes", "rq", 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,params,add_dot", CASES)
def test_cuda_kernels_match_plain_versions(kernel, params, add_dot):
    """On the card: both kernels against their plain versions, self and
    cross blocks, rel 2e-4 / abs 1e-5 (values), and the fused_mmd2
    gradients at rtol 2e-4 / atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    x, y = (torch.from_numpy(v).cuda() for v in _xy(4, 100, 60, 16))
    for b, excl in ((x, True), (y, False)):
        want = float(tk.pair_sum_plain(x, b, kernel, params, excl, add_dot))
        got = float(tk.pair_sum(x, b, kernel, params, excl, add_dot))
        assert got == pytest.approx(want, rel=2e-4, abs=1e-5)
        ga = tk.pair_sum_grad_a(x, b, kernel, params, excl, add_dot)
        gp = tk.pair_sum_grad_a_plain(x, b, kernel, params, excl, add_dot)
        torch.testing.assert_close(ga, gp, rtol=2e-4, atol=1e-5 * float(gp.abs().max()))
