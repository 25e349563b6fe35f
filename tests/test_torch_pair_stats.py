"""The port's fused block statistics (``make_row_stats``,
``make_pair_stats``) and differentiable pair sum (``make_pair_sum``)
against ``smmdax.pallas`` in interpret mode, value and gradient, with and
without the diagonal (the cases of tests/test_ring.py:147-202), and the
one-sweep stats (rows, columns, sum of squares) and stats gradient (da, db)
against JAX's two sweeps and two calls.

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
from smmdax_torch import tracing
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


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("excl", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_block_stats_match_two_pallas_sweeps(kernel, params, add_dot, excl):
    """The one-sweep forward's (rows, cols, sum_sq) against JAX's two
    sweeps ``_pair_stats_fwd(a, b)`` and ``_pair_stats_fwd(b, a)``."""
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    a, b, _, _ = _inputs(excl)
    w_rows, w_sq = pk._pair_stats_fwd(a, b, kernel, params, excl, add_dot=add_dot)
    w_cols, _ = pk._pair_stats_fwd(b, a, kernel, params, excl, add_dot=add_dot)
    rows, cols, sq = tk.pair_block_stats(torch.from_numpy(a), torch.from_numpy(b),
                                         kernel, params, excl, add_dot)
    np.testing.assert_allclose(rows.numpy(), np.asarray(w_rows), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(cols.numpy(), np.asarray(w_cols), rtol=2e-4, atol=1e-5)
    assert float(sq) == pytest.approx(float(w_sq), rel=2e-4, abs=1e-5)
    assert tk.pair_block_stats(torch.from_numpy(a), torch.from_numpy(b), kernel, params,
                               excl, add_dot, want_cols=False)[1] is None


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("excl", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_block_stats_grad_matches_two_pallas_calls(kernel, params, add_dot, excl):
    """The one-sweep gradient's (da, db), non-zero u, v and c, against
    JAX's ``_pair_stats_grad_a(a, b, u, v, c)`` and
    ``_pair_stats_grad_a(b, a, v, u, c)``; each at 2e-4 of its largest
    entry, as chip_smoke.py holds the kernel (RAW_GRAD_SCALE_TOL).  With
    ``scale`` and the need-flags."""
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    a, b, u, v = _inputs(excl)
    c = jnp.float32(0.7)
    want_a = np.asarray(pk._pair_stats_grad_a(a, b, u, v, c, kernel, params, excl,
                                              add_dot=add_dot))
    want_b = np.asarray(pk._pair_stats_grad_a(b, a, v, u, c, kernel, params, excl,
                                              add_dot=add_dot))
    args = [torch.from_numpy(t) for t in (a, b, u, v)] + [torch.tensor(0.7)]
    da, db = tk.pair_block_stats_grad(*args, kernel, params, excl, add_dot)
    for got, want in ((da, want_a), (db, want_b)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())
    da2, none = tk.pair_block_stats_grad(*args, kernel, params, excl, add_dot,
                                         need_b=False, scale=2.0)
    assert none is None
    np.testing.assert_allclose(da2.numpy(), 2.0 * want_a, rtol=0,
                               atol=4e-4 * np.abs(want_a).max())


class _OneHostAxis:
    """A data axis whose shifts and sums are identities: each rotation of
    the ring sees the rank's own blocks again."""

    def __init__(self, size):
        self.size, self.index = size, 0

    def ppermute_next(self, x):
        return x

    def psum(self, x):
        return x


@pytest.mark.parametrize("size", [1, 2])
def test_ring_var_stats_makes_three_stats_sweeps_per_rotation(monkeypatch, size):
    """xx and yy take rows only, xy rows and columns from one sweep: 3
    stats-forward calls per rotation, not 4; and one gradient call per
    block in the backward."""
    from smmdax_torch.parallel.ring import ring_var_stats
    calls = {"fwd": 0, "grad": 0}
    for name, key in (("pair_stats", "fwd"), ("pair_block_stats", "fwd"),
                      ("pair_block_stats_grad", "grad")):
        real = getattr(tk, name)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(tk, name, counted)
    a, b, _, _ = _inputs(False)
    x = torch.from_numpy(a[:40]).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    stats = ring_var_stats(x, y, _OneHostAxis(size), "rq", use_pallas=True)
    assert calls == {"fwd": 3 * size, "grad": 0}
    (stats.kt_xx_2_sum + stats.dot_xy_cols + stats.k_xy_sum).backward()
    assert calls["grad"] == 3 * size


def test_cpu_uses_plain_versions_and_counts_no_launch():
    tracing.enable()
    try:
        tracing.drain()
        a, b, _, _ = _inputs(False)
        at = torch.from_numpy(a).requires_grad_()
        rows, cols, sq = tk.make_pair_stats("rq", (0.5, 1.0), False)(at, torch.from_numpy(b))
        (rows.sum() + cols.sum() + sq).backward()
        tk.make_pair_sum("rq", (0.5, 1.0), True)(at, at).backward()
        _, counters = tracing.drain()
    finally:
        tracing.disable()
    assert not [k for k in counters if k.startswith("mmd.")]


@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_row_stats_backward_skips_inputs_without_gradient(monkeypatch, which):
    """One stats-gradient call, for a only, b only or both, asking only for
    the gradients that are needed."""
    calls = []
    real = tk.pair_block_stats_grad
    monkeypatch.setattr(tk, "pair_block_stats_grad",
                        lambda *args, **kw: calls.append(kw) or real(*args, **kw))
    a, b, _, _ = _inputs(False)
    at = torch.from_numpy(a).requires_grad_(which in ("a", "both"))
    bt = torch.from_numpy(b).requires_grad_(which in ("b", "both"))
    rows, sq = tk.make_row_stats("rq", (0.5, 1.0), False)(at, bt)
    (rows.sum() + sq).backward()
    assert [(c["need_a"], c["need_b"]) for c in calls] == [
        (which != "b", which != "a")]
    assert (at.grad is not None) == (which != "b")
    assert (bt.grad is not None) == (which != "a")


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
    and cross blocks, at shapes ragged against the tiles (m x n x d: 1x7x3,
    33x17x5, 100x60x16, 130x70x130), non-zero u, v and c: rows, cols and
    sum_sq at rel 2e-4 / abs 1e-5 (rows, cols at 2e-4 of the largest),
    da, db at 2e-4 of their largest entry; the single-side wrappers too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    r = np.random.default_rng(4)
    for m, n, d in ((1, 7, 3), (33, 17, 5), (100, 60, 16), (130, 70, 130)):
        x = torch.from_numpy((r.standard_normal((m, d)) * 0.7).astype(np.float32)).cuda()
        y = torch.from_numpy((r.standard_normal((n, d)) * 0.7 + 0.3).astype(np.float32)).cuda()
        for b, excl in ((x, True), (y, False)):
            u = torch.randn(x.shape[0], device="cuda")
            v = torch.randn(b.shape[0], device="cuda")
            c = torch.tensor(0.7, device="cuda")
            rows, cols, sq = tk.pair_block_stats(x, b, kernel, params, excl, add_dot)
            p_rows, p_cols, p_sq = tk.pair_block_stats_plain(x, b, kernel, params, excl,
                                                             add_dot)
            for got, want in ((rows, p_rows), (cols, p_cols)):
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=1e-5 + 2e-4 * float(want.abs().max()))
            assert float(sq) == pytest.approx(float(p_sq), rel=2e-4, abs=1e-5)
            rows1, sq1 = tk.pair_stats(x, b, kernel, params, excl, add_dot)
            assert torch.equal(rows1, rows) and torch.equal(sq1, sq)
            da, db = tk.pair_block_stats_grad(x, b, u, v, c, kernel, params, excl, add_dot)
            pa, pb = tk.pair_block_stats_grad_plain(x, b, u, v, c, kernel, params, excl,
                                                    add_dot)
            for got, want in ((da, pa), (db, pb)):
                torch.testing.assert_close(got, want, rtol=0,
                                           atol=2e-4 * float(want.abs().max()) + 1e-6)
            da1 = tk.pair_stats_grad_a(x, b, u, v, c, kernel, params, excl, add_dot)
            torch.testing.assert_close(da1, pa, rtol=0,
                                       atol=2e-4 * float(pa.abs().max()) + 1e-6)
