"""The port's fused block statistics (``make_row_stats``,
``make_pair_stats``) and differentiable pair sum (``make_pair_sum``)
against ``smmdax.pallas`` in interpret mode, value and gradient, with and
without the diagonal (the cases of tests/test_ring.py:147-202).

On the CPU the wrappers run their kernels' plain versions, so these tests
hold the plain versions and the autograd.Functions around them to the TPU
kernels' semantics.  Tolerances are those of tests/test_ring.py: row and
column sums rel 2e-4 / abs 1e-5, the sum of squares rel 2e-4, gradients
rtol 5e-4 / atol 1e-5.  The comparison of the CUDA kernels with their
plain versions needs the card (marker ``cuda``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smmdax.pallas.mmd_kernel as pk
from smmdax_torch.cuda import mmd_kernel as tk

CASES = [("gaussian", (1.0, 2.0, 4.0, 8.0, 16.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.3),
         ("distance", (), 0.0),
         ("dot", (), 0.0)]
IDS = ["gaussian", "rq", "rq+add_dot", "distance", "dot"]


@pytest.fixture(scope="module")
def pallas_interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _inputs(excl):
    r = np.random.default_rng(5)
    a = (r.standard_normal((48, 8)) * 0.7).astype(np.float32)
    b = a if excl else (r.standard_normal((40, 8)) * 0.7 + 0.2).astype(np.float32)
    u = r.standard_normal(a.shape[0]).astype(np.float32)
    v = r.standard_normal(b.shape[0]).astype(np.float32)
    return a, b, u, v


def _grads(loss, a, b):
    at = torch.from_numpy(a.copy()).requires_grad_()
    bt = torch.from_numpy(b.copy()).requires_grad_()
    return torch.autograd.grad(loss(at, bt), (at, bt))


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("excl", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_pair_stats_match_pallas(kernel, params, add_dot, excl):
    a, b, u, v = _inputs(excl)
    want = pk.make_pair_stats(kernel, params, excl, add_dot=add_dot)
    got = tk.make_pair_stats(kernel, params, excl, add_dot=add_dot)
    w_rows, w_cols, w_sq = want(a, b)
    g_rows, g_cols, g_sq = got(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(g_rows.numpy(), np.asarray(w_rows), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(g_cols.numpy(), np.asarray(w_cols), rtol=2e-4, atol=1e-5)
    assert float(g_sq) == pytest.approx(float(w_sq), rel=2e-4)

    # the gradient of a functional of all three statistics
    def jloss(aa, cc):
        r_, c_, s_ = want(aa, cc)
        return jnp.dot(u, r_) + jnp.dot(v, c_) + 0.3 * s_

    def tloss(aa, cc):
        r_, c_, s_ = got(aa, cc)
        return (torch.dot(torch.from_numpy(u), r_) + torch.dot(torch.from_numpy(v), c_)
                + 0.3 * s_)

    wg = jax.grad(jloss, argnums=(0, 1))(a, b)
    tg = _grads(tloss, a, b)
    for g, w in zip(tg, wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=1e-5)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("excl", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_pair_sum_matches_pallas(kernel, params, add_dot, excl):
    """make_pair_sum: the ring's block sum; on a self block one tensor
    feeds both arguments and the two cotangents add up."""
    a, b, _, _ = _inputs(excl)
    want = pk.make_pair_sum(kernel, params, excl, add_dot=add_dot)
    got = tk.make_pair_sum(kernel, params, excl, add_dot=add_dot)
    wv = float(want(a, b))
    assert float(got(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        wv, rel=2e-4, abs=1e-5)
    if excl:
        wg = (jax.grad(lambda aa: want(aa, aa))(a),)
        at = torch.from_numpy(a.copy()).requires_grad_()
        tg = torch.autograd.grad(got(at, at), at)
    else:
        wg = jax.grad(lambda aa, cc: want(aa, cc), argnums=(0, 1))(a, b)
        tg = _grads(got, a, b)
    for g, w in zip(tg, wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=1e-5)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_stats_grad_kernel_matches_pallas(kernel, params, add_dot):
    """The raw kernel-4 function with non-zero u, v and c (ragged shapes),
    against ``_pair_stats_grad_a``; held at 2e-4 of its largest entry, as
    chip_smoke.py holds the kernel (RAW_GRAD_SCALE_TOL)."""
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    a, b, u, v = _inputs(False)
    for excl, bb, vv in ((False, b, v), (True, a, u[::-1].copy())):
        want = np.asarray(pk._pair_stats_grad_a(a, bb, u, vv, jnp.float32(0.7), kernel,
                                                params, excl, add_dot=add_dot))
        got = tk.pair_stats_grad_a(*(torch.from_numpy(t) for t in (a, bb, u, vv)),
                                   torch.tensor(0.7), kernel, params, excl, add_dot)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())


def test_cpu_uses_plain_versions_and_counts_no_launch():
    before = [f.launches for f in tk.kernel_launch_counters()]
    a, b, _, _ = _inputs(False)
    at = torch.from_numpy(a).requires_grad_()
    rows, cols, sq = tk.make_pair_stats("rq", (0.5, 1.0), False)(at, torch.from_numpy(b))
    (rows.sum() + cols.sum() + sq).backward()
    tk.make_pair_sum("rq", (0.5, 1.0), True)(at, at).backward()
    assert [f.launches for f in tk.kernel_launch_counters()] == before


def test_row_stats_backward_skips_inputs_without_gradient(monkeypatch):
    """One stats-gradient call when only a needs a gradient, none for b."""
    calls = []
    real = tk.pair_stats_grad_a
    monkeypatch.setattr(tk, "pair_stats_grad_a",
                        lambda *args, **kw: calls.append(1) or real(*args, **kw))
    a, b, _, _ = _inputs(False)
    at = torch.from_numpy(a).requires_grad_()
    rows, sq = tk.make_row_stats("rq", (0.5, 1.0), False)(at, torch.from_numpy(b))
    (rows.sum() + sq).backward()
    assert len(calls) == 1


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(4, 3)
    b = torch.zeros(5, 3)
    with pytest.raises(ValueError):
        tk.pair_stats(a, torch.zeros(4, 2), "rq", (1.0,), False)
    with pytest.raises(ValueError):
        tk.pair_stats_grad_a(a, b, torch.zeros(5), torch.zeros(5), torch.tensor(1.0),
                             "rq", (1.0,), False)
    with pytest.raises(ValueError):
        tk.pair_stats_grad_a(a, b, torch.zeros(4), torch.zeros(5), torch.zeros(2),
                             "rq", (1.0,), False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_cuda_stats_kernels_match_plain_versions(kernel, params, add_dot):
    """On the card: both stats kernels against their plain versions, self
    and cross blocks, ragged 100x60x16, non-zero u, v and c: rows and
    sum_sq at rel 2e-4 / abs 1e-5, da at 2e-4 of its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    r = np.random.default_rng(4)
    x = torch.from_numpy((r.standard_normal((100, 16)) * 0.7).astype(np.float32)).cuda()
    y = torch.from_numpy((r.standard_normal((60, 16)) * 0.7 + 0.3).astype(np.float32)).cuda()
    for b, excl in ((x, True), (y, False)):
        u = torch.randn(x.shape[0], device="cuda")
        v = torch.randn(b.shape[0], device="cuda")
        c = torch.tensor(0.7, device="cuda")
        rows, sq = tk.pair_stats(x, b, kernel, params, excl, add_dot)
        p_rows, p_sq = tk.pair_stats_plain(x, b, kernel, params, excl, add_dot)
        torch.testing.assert_close(rows, p_rows, rtol=2e-4, atol=1e-5)
        assert float(sq) == pytest.approx(float(p_sq), rel=2e-4, abs=1e-5)
        da = tk.pair_stats_grad_a(x, b, u, v, c, kernel, params, excl, add_dot)
        dp = tk.pair_stats_grad_a_plain(x, b, u, v, c, kernel, params, excl, add_dot)
        torch.testing.assert_close(da, dp, rtol=0, atol=2e-4 * float(dp.abs().max()))
