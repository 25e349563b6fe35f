"""The port's score math (``smmdax_torch.eval.scores``) against the JAX
package's numpy arm (``smmdax.eval.scores``) on the same seeded features.

Tolerances and their measurements (these features):
* numpy arm, rtol 1e-10: it is the same float64 code; measured equal to
  the last bit (0 difference) for every score;
* torch arm on CPU tensors, rtol 1e-4: float32 Gram blocks finished in
  float64; measured at most 8.4e-6 relative (the KID std), 1.2e-7 / 5.7e-7
  (mean / covariance, relative to their largest entry), 8.3e-8 (FID),
  4.6e-6 (three-sample t).  Subset indices are drawn as in JAX, so the
  vote fractions are equal.
"""

import numpy as np
import pytest
import torch

from smmdax.eval import scores as jscores
from smmdax_torch.eval import scores as tscores
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

NUMPY_RTOL = 1e-10
TORCH_RTOL = 1e-4

_rng = np.random.default_rng(0)
REAL = _rng.normal(size=(300, 32)).astype(np.float32)
FAKE = (_rng.normal(size=(200, 32)) + 0.05).astype(np.float32)
BEST = (_rng.normal(size=(200, 32)) + 0.08).astype(np.float32)
PROBS = _rng.uniform(0.05, 1.0, (200, 10))
PROBS /= PROBS.sum(axis=1, keepdims=True)

ARMS = {"numpy": (lambda x: x, NUMPY_RTOL),
        "torch": (lambda x: torch.from_numpy(np.asarray(x, np.float32)), TORCH_RTOL)}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("arm", ARMS)
def test_gaussian_stats_and_fid(arm):
    to, rtol = ARMS[arm]
    for got, want in zip(tscores.gaussian_stats(to(REAL)), jscores.gaussian_stats(REAL)):
        _close(got, want, rtol)
    _close(tscores.fid_from_features(to(REAL), to(FAKE)),
           jscores.fid_from_features(REAL, FAKE), rtol)
    mu1, s1 = jscores.gaussian_stats(REAL)
    mu2, s2 = jscores.gaussian_stats(FAKE)
    _close(tscores.frechet_distance(mu1, s1, mu2, s2),
           jscores.frechet_distance(mu1, s1, mu2, s2), NUMPY_RTOL)


@pytest.mark.parametrize("arm", ARMS)
def test_kid_from_features(arm):
    """Same seed, so the same subsets as JAX."""
    to, rtol = ARMS[arm]
    got = tscores.kid_from_features(to(REAL), to(FAKE), subset_size=100, n_subsets=7, seed=3)
    want = jscores.kid_from_features(REAL, FAKE, subset_size=100, n_subsets=7, seed=3)
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert tscores.polynomial_mmd(REAL[:50], FAKE[:60]) == pytest.approx(
        jscores.polynomial_mmd(REAL[:50], FAKE[:60]), rel=NUMPY_RTOL)


@pytest.mark.parametrize("arm", ARMS)
def test_inception_score(arm):
    to, rtol = ARMS[arm]
    np.testing.assert_allclose(tscores.inception_score(to(PROBS)),
                               jscores.inception_score(PROBS), rtol=rtol)


@pytest.mark.parametrize("combine", ["fisher", "mean"])
@pytest.mark.parametrize("arm", ARMS)
def test_relative_mmd_test(arm, combine):
    to, rtol = ARMS[arm]
    got = tscores.relative_mmd_test(to(REAL), to(FAKE), to(BEST), subset_size=150,
                                    n_subsets=3, seed=5, combine=combine)
    want = jscores.relative_mmd_test(REAL, FAKE, BEST, subset_size=150, n_subsets=3,
                                     seed=5, combine=combine)
    assert 0.05 < want[0] < 0.95          # a p-value away from the clamps
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("arm", ARMS)
def test_relative_similarity_test(arm):
    to, _ = ARMS[arm]
    got = tscores.relative_similarity_test(to(REAL), to(FAKE), to(BEST), subset_size=60,
                                           n_subsets=20, seed=2)
    want = jscores.relative_similarity_test(REAL, FAKE, BEST, subset_size=60,
                                            n_subsets=20, seed=2)
    assert 0.0 < want < 1.0 and got == want


def test_fisher_combine_and_mmd_diff_var():
    for ps in ([0.5], [0.01, 0.2, 0.7], [1e-20, 0.3], [0.9] * 7):
        assert tscores.fisher_combine(ps) == pytest.approx(
            jscores.fisher_combine(ps), rel=NUMPY_RTOL)
    blocks = [jscores._poly_kernel(x, y) for x, y in
              ((FAKE[:40], FAKE[:40]), (BEST[:40], BEST[:40]),
               (REAL[:40], FAKE[:40]), (REAL[:40], BEST[:40]))]
    assert tscores.mmd_diff_var(*blocks) == pytest.approx(
        jscores.mmd_diff_var(*blocks), rel=NUMPY_RTOL)


def test_backend_choice():
    assert tscores._resolve_backend("auto", REAL, FAKE) == "numpy"
    assert tscores._resolve_backend("auto", REAL, torch.zeros(1)) == "torch"
    with pytest.raises(ValueError, match="backend"):
        tscores.kid_from_features(REAL, FAKE, backend="jax")
    assert not tscores.use_device_scoring("cpu")
    assert tscores.use_device_scoring(torch.device("cuda", 0))
