"""The port's one-sweep pair-sum gradient (``pair_sum_grad``) and the
autograd Functions rewired onto it (``make_fused_mmd_sums``,
``make_pair_sum``) against ``smmdax.pallas`` in interpret mode.

JAX takes da from ``_pair_sum_grad_a(a, b)`` and db from a second call on
the swapped block ``_pair_sum_grad_a(b, a)``, and multiplies by the pair
factor and the cotangent on the host; the port gives both from one sweep,
times scale * c with c a tensor.  On the CPU the wrappers run their
kernels' plain versions, so these tests hold the plain versions and the
Functions to the TPU kernels' semantics.  Raw gradients are held at 2e-4
of their largest entry (as chip_smoke.py holds the kernel), gradients of
the Functions at rtol 2e-4 / atol 1e-6 (tests/test_pallas.py) and, for
``make_pair_sum``, rtol 5e-4 / atol 1e-5 (tests/test_ring.py).  The
comparison of the CUDA kernels with their plain versions needs the card
(marker ``cuda``)."""

import jax
import numpy as np
import pytest
import torch

import smmdax.pallas.mmd_kernel as pk
from smmdax_torch.cuda import mmd_kernel as tk

CASES = [("gaussian", (1.0, 2.0, 4.0, 8.0, 16.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.5),
         ("distance", (), 0.0),
         ("dot", (), 0.0)]
IDS = ["gaussian", "rq", "rq+add_dot", "distance", "dot"]
C = 0.7                                   # a cotangent that is not 1


@pytest.fixture(scope="module")
def pallas_interpret():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _xy(seed, m, n, d):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 0.7).astype(np.float32)
    y = (r.standard_normal((n, d)) * 0.7 + 0.3).astype(np.float32)
    return x, y


def _close_at_scale(got, want, tol=2e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("m,n,d", [(33, 17, 5), (100, 60, 16)])
@pytest.mark.parametrize("excl", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_pair_sum_grad_matches_two_pallas_calls(kernel, params, add_dot, excl, m, n, d):
    """da against ``_pair_sum_grad_a(a, b)`` and db against
    ``_pair_sum_grad_a(b, a)``, times scale * c, for scale 2 and 4; each
    side alone gives None for the other."""
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    a, b = _xy(6, m, n, d)
    if excl:
        b = a
    want_a = np.asarray(pk._pair_sum_grad_a(a, b, kernel, params, excl, add_dot=add_dot))
    want_b = want_a if excl else np.asarray(
        pk._pair_sum_grad_a(b, a, kernel, params, excl, add_dot=add_dot))
    at, bt, c = torch.from_numpy(a), torch.from_numpy(b), torch.tensor(C)
    for scale in (2.0, 4.0):
        da, db = tk.pair_sum_grad(at, bt, c, kernel, params, excl, add_dot, scale=scale)
        _close_at_scale(da.numpy(), scale * C * want_a)
        _close_at_scale(db.numpy(), scale * C * want_b)
        da1, none_b = tk.pair_sum_grad(at, bt, c, kernel, params, excl, add_dot,
                                       need_b=False, scale=scale)
        none_a, db1 = tk.pair_sum_grad(at, bt, c, kernel, params, excl, add_dot,
                                       need_a=False, scale=scale)
        assert none_a is None and none_b is None
        assert torch.equal(da1, da) and torch.equal(db1, db)
    _close_at_scale(tk.pair_sum_grad_a(at, bt, kernel, params, excl, add_dot).numpy(),
                    want_a)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("block", ["cross", "self", "self_one_tensor"])
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_make_pair_sum_gradients_match_pallas(kernel, params, add_dot, block):
    """Gradients of c * make_pair_sum(a, b) (argnums 0 and 1; on a self
    block also with one tensor in both places) against JAX's
    make_pair_sum."""
    excl = block != "cross"
    a, b = _xy(7, 33, 17, 5)
    if excl:
        b = a.copy()
    want = pk.make_pair_sum(kernel, params, excl, add_dot=add_dot)
    got = tk.make_pair_sum(kernel, params, excl, add_dot=add_dot)
    if block == "self_one_tensor":
        wg = (jax.grad(lambda aa: C * want(aa, aa))(a),)
        at = torch.from_numpy(a.copy()).requires_grad_()
        tg = torch.autograd.grad(C * got(at, at), at)
    else:
        wg = jax.grad(lambda aa, cc: C * want(aa, cc), argnums=(0, 1))(a, b)
        at = torch.from_numpy(a.copy()).requires_grad_()
        bt = torch.from_numpy(b.copy()).requires_grad_()
        tg = torch.autograd.grad(C * got(at, bt), (at, bt))
    for g, w in zip(tg, wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=1e-5)


@pytest.mark.usefixtures("pallas_interpret")
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_fused_sums_cotangents_reach_their_blocks(kernel, params, add_dot):
    """Gradients of w1 s_xx + w2 s_yy + w3 s_xy through
    make_fused_mmd_sums, with distinct weights, against JAX's custom VJP:
    each cotangent must reach its own block, with x, y or both needing a
    gradient.  The weights carry the MMD estimator's normalisation, so the
    gradients have the scale of fused_mmd2's, whose tolerance this is."""
    x, y = _xy(8, 40, 56, 12)
    m, n = x.shape[0], y.shape[0]
    w = (0.3 / (m * (m - 1)), -1.7 / (n * (n - 1)), 2.9 / (m * n))

    def jloss(xx, yy):
        s = pk.make_fused_mmd_sums(kernel, params, add_dot)(xx, yy)
        return w[0] * s[0] + w[1] * s[1] + w[2] * s[2]

    wx, wy = jax.grad(jloss, argnums=(0, 1))(x, y)
    sums = tk.make_fused_mmd_sums(kernel, params, add_dot)
    for need in ("xy", "x", "y"):
        xt = torch.from_numpy(x.copy()).requires_grad_("x" in need)
        yt = torch.from_numpy(y.copy()).requires_grad_("y" in need)
        s = sums(xt, yt)
        (w[0] * s[0] + w[1] * s[1] + w[2] * s[2]).backward()
        for t, want, name in ((xt, wx, "x"), (yt, wy, "y")):
            if name in need:
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=2e-4,
                                           atol=1e-6)
            else:
                assert t.grad is None


def _count_grad_calls(monkeypatch):
    calls = []
    real = tk.pair_sum_grad
    monkeypatch.setattr(tk, "pair_sum_grad",
                        lambda *args, **kw: calls.append((args, kw)) or real(*args, **kw))
    return calls


@pytest.mark.parametrize("which", ["x", "y", "both"])
def test_fused_sums_backward_makes_one_cross_sweep(monkeypatch, which):
    """The cross block's one sweep serves dx and dy: 3 gradient calls when
    both need a gradient (from 4 in JAX), 2 when one does; the cross call
    asks only for the sides that are needed, at scale 2, the self blocks
    for da alone at scale 4."""
    calls = _count_grad_calls(monkeypatch)
    x, y = _xy(9, 24, 20, 6)
    xt = torch.from_numpy(x).requires_grad_(which != "y")
    yt = torch.from_numpy(y).requires_grad_(which != "x")
    sum(tk.make_fused_mmd_sums("rq", (0.5, 1.0))(xt, yt)).backward()
    cross = [kw for args, kw in calls if args[5] is False]
    self_blocks = [kw for args, kw in calls if args[5] is True]
    assert [(kw["need_a"], kw["need_b"], kw["scale"]) for kw in cross] == [
        (which != "y", which != "x", 2.0)]
    assert [(kw["need_b"], kw["scale"]) for kw in self_blocks] == [(False, 4.0)] * (
        2 if which == "both" else 1)


@pytest.mark.parametrize("which", ["a", "b", "both", "one_tensor"])
def test_pair_sum_backward_is_one_call(monkeypatch, which):
    """make_pair_sum's backward is one gradient call, for a only, b only or
    both (one tensor in both places included), at scale 2."""
    calls = _count_grad_calls(monkeypatch)
    a, b = _xy(10, 24, 20, 6)
    at = torch.from_numpy(a).requires_grad_(which != "b")
    bt = at if which == "one_tensor" else torch.from_numpy(b).requires_grad_(which != "a")
    tk.make_pair_sum("rq", (0.5, 1.0), which == "one_tensor")(at, bt).backward()
    assert [(kw["need_a"], kw["need_b"], kw["scale"]) for _, kw in calls] == [
        (which != "b", which != "a", 2.0)]


def test_pair_sum_grad_a_is_the_unit_da_only_call():
    a, b = (torch.from_numpy(t) for t in _xy(11, 30, 26, 7))
    ga = tk.pair_sum_grad_a(a, b, "rq", (0.5, 2.0), False)
    da, db = tk.pair_sum_grad(a, b, None, "rq", (0.5, 2.0), False, need_b=False)
    assert db is None and torch.equal(ga, da)
    da1, _ = tk.pair_sum_grad(a, b, torch.tensor([1.0]), "rq", (0.5, 2.0), False,
                              need_b=False)
    torch.testing.assert_close(da1, ga, rtol=0, atol=0)


def test_pair_sum_grad_rejects_what_the_kernel_does_not_take():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tk.pair_sum_grad(a, a, None, "rq", (1.0,), True, need_a=False, need_b=False)
    with pytest.raises(ValueError):
        tk.pair_sum_grad(a, a, torch.ones(2), "rq", (1.0,), True)
    with pytest.raises(ValueError):
        tk.pair_sum_grad(a, a, torch.ones((), device="meta"), "rq", (1.0,), True)
    with pytest.raises(ValueError):
        tk.pair_sum_grad(a, torch.zeros(4, 2), None, "rq", (1.0,), False)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,params,add_dot", CASES, ids=IDS)
def test_cuda_pair_sum_kernels_match_plain_versions(kernel, params, add_dot):
    """On the card: the forward and the one-sweep gradient (da, db, both;
    c = 0.7) against their plain versions, self and cross blocks, at shapes
    ragged against the 16/32/64 tiles and 64-feature chunks (m x n x d:
    1x7x3, 33x17x5, 100x60x16, 130x70x130): S at rel 2e-4 / abs 1e-5,
    da and db at 2e-4 of their largest entry; a second launch on the same
    inputs repeats the first bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel, params, add_dot = tk.canon_kernel(kernel, params, add_dot)
    r = np.random.default_rng(12)
    c = torch.tensor(C, device="cuda")
    for m, n, d in ((1, 7, 3), (33, 17, 5), (100, 60, 16), (130, 70, 130)):
        x = torch.from_numpy((r.standard_normal((m, d)) * 0.7).astype(np.float32)).cuda()
        y = torch.from_numpy((r.standard_normal((n, d)) * 0.7 + 0.3).astype(np.float32)).cuda()
        for b, excl in ((x, True), (y, False)):
            s = tk.pair_sum(x, b, kernel, params, excl, add_dot)
            want = float(tk.pair_sum_plain(x, b, kernel, params, excl, add_dot))
            assert float(s) == pytest.approx(want, rel=2e-4, abs=1e-5)
            assert torch.equal(tk.pair_sum(x, b, kernel, params, excl, add_dot), s)
            pa, pb = tk.pair_sum_grad_plain(x, b, c, kernel, params, excl, add_dot,
                                            scale=2.0)
            for need_a, need_b in ((True, True), (True, False), (False, True)):
                got = tk.pair_sum_grad(x, b, c, kernel, params, excl, add_dot,
                                       need_a=need_a, need_b=need_b, scale=2.0)
                again = tk.pair_sum_grad(x, b, c, kernel, params, excl, add_dot,
                                         need_a=need_a, need_b=need_b, scale=2.0)
                for g, g2, want_g, needed in zip(got, again, (pa, pb), (need_a, need_b)):
                    if not needed:
                        assert g is None
                        continue
                    torch.testing.assert_close(g, want_g, rtol=0,
                                               atol=2e-4 * float(want_g.abs().max()) + 1e-6)
                    assert torch.equal(g, g2)
            ga = tk.pair_sum_grad_a(x, b, kernel, params, excl, add_dot)
            gp = tk.pair_sum_grad_a_plain(x, b, kernel, params, excl, add_dot)
            torch.testing.assert_close(ga, gp, rtol=0,
                                       atol=2e-4 * float(gp.abs().max()) + 1e-6)
