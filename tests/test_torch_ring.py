"""The port's ring estimators (``smmdax_torch.parallel.ring``) on 2 and 4
gloo ranks against the JAX package's ``shard_map`` ring on the same shards
(the first N of the 8 CPU devices of tests/conftest.py) and against the
dense single-device oracle, in value and gradient: the port of
tests/test_ring.py's cases, plus the collectives' transpose rules.

The ranks run in spawned processes (``tests/_torch_dist.py``), one spawn
per world size with every case inside.  Each rank's gradient of the
global loss is divided by the rank count (the psum -> psum convention,
pinned by ``test_collectives_follow_jax_transposes``) and the blocks are
concatenated.  ``use_pallas`` routes the port through the fused block
functions, which run their kernels' plain versions on the CPU.

Tolerances are those of tests/test_ring.py: MMD^2 values rel 2e-4 /
abs 1e-6, their gradients rtol 5e-4 / atol 1e-6; ratios rel 5e-4 / abs
1e-6, their gradients rtol 1e-3 plus 2e-4 of the largest entry (measured:
at most 6e-5 of it, 4 ranks, gaussian; the variance formula's
cancellations amplify float32 summation order, tests/test_ring.py:138-140).
One exception: the biased distance MMD^2.  The ring adds the COMPUTED
trace -sqrt(d2_ii + eps), whose d2_ii is float32 cancellation residue, so
its gradient carries noise (measured up to 1.9e-6, 1.4e-4 of the largest
entry) that the dense oracle's constant diagonal does not: held at 2e-4
of the largest entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist
from smmdax.kernels import kernel_matrices, mmd2, mmd2_and_ratio
from smmdax.parallel.ring import ring_mmd2, ring_mmd2_and_ratio

WORLD_SIZES = (2, 4)
KERNELS = ("gaussian", "rq", "distance", "dot")


def _xy(seed, m, d):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((m, d)) * 0.6).astype(np.float32)
    y = (r.standard_normal((m, d)) * 0.6 + 0.4).astype(np.float32)
    return x, y


X32, Y32 = _xy(0, 32, 8)
X64, Y64 = _xy(1, 64, 16)

# (name, kernel, estimator, biased, use_pallas, add_dot)
CASES = ([(k, "mmd2", b, p, 0.0) for k in KERNELS for b in (False, True) for p in (False, True)]
         + [("rq", "mmd2", b, p, 0.5) for b in (False, True) for p in (False, True)]
         + [(k, "ratio", False, p, 0.0) for k in KERNELS for p in (False, True)]
         + [("rq", "ratio", False, p, 0.3) for p in (False, True)])


def _name(kernel, est, biased, use_pallas, add_dot):
    return (f"{kernel}{'+add_dot' if add_dot else ''}-{est}"
            f"{'-biased' if biased else ''}{'-fused' if use_pallas else '-dense'}")


NAMES = [_name(*c) for c in CASES]
# the cases also held to the JAX ring itself (each a ~3 s shard_map
# compile): the tmmd ratio and the biased arm with its psum'd traces
JAX_RING_CASES = [("rq", "ratio", False, 0.0), ("rq", "mmd2", True, 0.5)]
COLL_X = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) / 7.0
COLL_W = np.random.default_rng(2).standard_normal((8, 3)).astype(np.float32)


def _data(est):
    return (X32, Y32) if est == "mmd2" else (X64, Y64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: [rank results]} of one spawn per world size."""
    cases = [(_name(*c), c[0], c[1], c[2], c[3], c[4], *_data(c[1])) for c in CASES]
    out = {}
    for n in WORLD_SIZES:
        out[n] = _torch_dist.run(n, "ring_suite", {
            "cases": cases, "coll_x": COLL_X[:2 * n], "coll_w": COLL_W[:2 * n]},
            tmp_path_factory.mktemp(f"ring{n}"))
    return out


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _port(ranks, n, name):
    """(value, dx, dy) of the port from the ranks' results."""
    res = [r["ring"] for r in ranks[n]]
    values = {r[name][0] for r in res}
    assert len(values) == 1, f"ranks disagree on the value: {values}"
    return (values.pop(), np.concatenate([r[name][1] for r in res]),
            np.concatenate([r[name][2] for r in res]))


@functools.lru_cache(maxsize=None)
def _dense(kernel, est, biased, add_dot):
    x, y = _data(est)

    def f(a, b):
        blocks = kernel_matrices(kernel, a, b, add_dot=add_dot)
        return mmd2(blocks, biased=biased) if est == "mmd2" else mmd2_and_ratio(blocks)[1]
    v, (gx, gy) = jax.value_and_grad(f, argnums=(0, 1))(x, y)
    return float(v), np.asarray(gx), np.asarray(gy)


def _check(got, want, est, grad_scale_tol=0.0):
    (gv, gx, gy), (wv, wx, wy) = got, want
    if est == "mmd2":
        assert gv == pytest.approx(wv, rel=2e-4, abs=1e-6)
        for g, w in ((gx, wx), (gy, wy)):
            np.testing.assert_allclose(g, w, rtol=5e-4,
                                       atol=max(1e-6, grad_scale_tol * np.abs(w).max()))
    else:
        assert gv == pytest.approx(wv, rel=5e-4, abs=1e-6)
        for g, w in ((gx, wx), (gy, wy)):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-4 * np.abs(w).max())


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", CASES, ids=NAMES)
def test_ring_matches_dense(ranks, n, case):
    kernel, est, biased, use_pallas, add_dot = case
    x, y = _data(est)
    got = _port(ranks, n, _name(*case))
    _check(got, _dense(kernel, est, biased, add_dot), est,
           grad_scale_tol=2e-4 if (kernel, biased) == ("distance", True) else 0.0)
    if est == "ratio":
        want = mmd2_and_ratio(kernel_matrices(kernel, x, y, add_dot=add_dot))[0]
        values = {r["ring"][_name(*case) + "/mmd2"] for r in ranks[n]}
        assert len(values) == 1
        assert values.pop() == pytest.approx(float(want), rel=2e-4, abs=1e-6)


@pytest.mark.parametrize("n", WORLD_SIZES)
@pytest.mark.parametrize("case", JAX_RING_CASES,
                         ids=[_name(k, e, b, False, a) for k, e, b, a in JAX_RING_CASES])
def test_ring_matches_jax_ring(ranks, n, case):
    """The JAX shard_map ring on the same N shards, and the port's dense
    and fused arms."""
    kernel, est, biased, add_dot = case
    x, y = _data(est)
    if est == "mmd2":
        body = functools.partial(ring_mmd2, axis_name="data", kernel=kernel,
                                 biased=biased, add_dot=add_dot)
    else:
        body = lambda a, b: ring_mmd2_and_ratio(a, b, "data", kernel,  # noqa: E731
                                                add_dot=add_dot)[1]
    ring = shard_map(body, mesh=_mesh(n), in_specs=(P("data"), P("data")),
                     out_specs=P(), check_rep=False)
    v, (gx, gy) = jax.jit(jax.value_and_grad(ring, argnums=(0, 1)))(x, y)
    want = (float(v), np.asarray(gx), np.asarray(gy))
    for use_pallas in (False, True):
        _check(_port(ranks, n, _name(kernel, est, biased, use_pallas, add_dot)), want, est)


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_collectives_follow_jax_transposes(ranks, n):
    """Inside shard_map, per-shard jax.grad through psum / tiled
    all_gather / ppermute gives the port's backward of the same
    collective: psum -> psum, all_gather -> reduce-scatter, shift ->
    reverse shift.  With psum -> psum, the pmean over ranks of each rank's
    gradient of a psum'd loss is the global gradient."""
    x, w = COLL_X[:2 * n], COLL_W[:2 * n]
    perm = [(i, (i + 1) % n) for i in range(n)]

    def body(v):
        k = (jax.lax.axis_index("data") + 1).astype(jnp.float32)
        g_psum = jax.grad(lambda t: jnp.sum(jax.lax.psum(t, "data") * k))(v)
        g_gather = jax.grad(lambda t: jnp.sum(
            jax.lax.all_gather(t, "data", axis=0, tiled=True) * w))(v)
        g_shift = jax.grad(lambda t: jnp.sum(jax.lax.ppermute(t, "data", perm) * k))(v)
        return (jax.lax.psum(v, "data"), jax.lax.all_gather(v, "data", axis=0, tiled=True),
                jax.lax.ppermute(v, "data", perm), g_psum, g_gather, g_shift)

    fn = shard_map(body, mesh=_mesh(n), in_specs=P("data"),
                   out_specs=(P("data"),) * 6, check_rep=False)
    psum, gathered, shifted, g_psum, g_gather, g_shift = (np.asarray(a) for a in jax.jit(fn)(x))
    res = [r["collectives"] for r in ranks[n]]

    def cat(key):
        return np.concatenate([r[key] for r in res])

    # float sums in another order than XLA's: rtol 1e-6
    np.testing.assert_allclose(cat("psum"), psum, rtol=1e-6)
    np.testing.assert_allclose(cat("pmean"), psum / n, rtol=1e-6)
    np.testing.assert_array_equal(cat("gathered"), gathered)
    np.testing.assert_array_equal(cat("shifted"), shifted)
    np.testing.assert_array_equal(cat("psum_grad"), g_psum)
    np.testing.assert_allclose(cat("gather_grad"), g_gather, rtol=1e-6)
    np.testing.assert_array_equal(cat("shift_grad"), g_shift)
    # psum -> psum: every rank's gradient is the sum of all ranks' weights
    np.testing.assert_array_equal(cat("psum_grad"), np.full_like(x, n * (n + 1) / 2))
