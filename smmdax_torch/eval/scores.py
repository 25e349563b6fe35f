"""Score math: Frechet distance, polynomial-kernel MMD (KID), IS and the
three-sample tests of the KID learning-rate scheduler (copy of
``smmdax/eval/scores.py``).

Math sources: Heusel et al. 2017 (FID), Binkowski et al. 2018
arXiv:1801.01401 (KID), Salimans et al. 2016 (IS), Bounliphone et al.
2016 arXiv:1511.04581 (relative-MMD test).

Two arms, picked by the features' type (``backend="auto"``):

* numpy arrays: the float64 numpy arm, copied as it is.  It is the
  oracle.
* torch tensors: the Gram blocks ``(a @ b^T / d + 1)^3`` run in float32
  on the tensors' device (TF32 off), and only the per-subset sums come
  back; the cancellation-sensitive finish (U-statistic means, the zeta
  terms of the variance) stays in float64 numpy on the host.

Both arms draw the same subset indices from ``np.random.default_rng(seed)``
in the same order as the JAX package, so on the same features the scores
equal the JAX package's (numpy arm) or differ from them by float32 Gram
arithmetic (torch arm).  ``sqrtm`` of the covariance product is taken by
eigendecomposition of the symmetrized product S1^(1/2) S2 S1^(1/2).

The statistics, FID, KID, IS and the three-sample tests are spans of
``smmdax_torch.tracing`` (``eval.*``) while tracing is on.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from smmdax_torch import tracing

Array = np.ndarray


def use_device_scoring(device) -> bool:
    """True when ``device`` is a CUDA device: scoring callers then keep the
    features on the card, where the torch arm scores them."""
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _resolve_backend(backend: str, *feats) -> str:
    """'auto' -> 'torch' when any input is a torch tensor, else 'numpy'."""
    if backend == "auto":
        return "torch" if any(isinstance(f, torch.Tensor) for f in feats) else "numpy"
    if backend not in ("numpy", "torch"):
        raise ValueError(f"backend must be auto|numpy|torch, got {backend!r}")
    return backend


def _as_numpy(x) -> Array:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_tensor(x, device) -> torch.Tensor:
    """float32 tensor on ``device``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


def gaussian_stats(feats) -> Tuple[Array, Array]:
    """(mean, covariance) of a (N, d) feature matrix, as float64 numpy.

    A tensor's covariance is computed where it lives (two-pass centered
    form, float32 with TF32 off) and only the O(d^2) statistics come back;
    numpy inputs keep the float64 path."""
    with tracing.span("eval.gaussian_stats"):
        if isinstance(feats, torch.Tensor):
            x = feats.detach().float()
            mu = x.mean(dim=0)
            xc = x - mu
            with _no_tf32():
                sigma = (xc.T @ xc) / (len(x) - 1)
            return (mu.cpu().numpy().astype(np.float64),
                    sigma.cpu().numpy().astype(np.float64))
        feats = np.asarray(feats, np.float64)
        mu = feats.mean(axis=0)
        sigma = np.cov(feats, rowvar=False)
        return mu, sigma


_ROOT_CACHE: dict = {}     # id(sigma) -> (sigma ref, sigma^(1/2))


def _sqrt_eigvals_of_product(s1: Array, s2: Array, eps: float = 1e-10) -> Array:
    """Eigenvalues of sqrtm(s1 @ s2) via the PSD-symmetrized form.

    s1's root is cached (single slot, keyed on array identity with a
    strong reference so ids can't be recycled): the trainer scores a
    FIXED real set every event.  Callers must not mutate sigma in place."""
    ent = _ROOT_CACHE.get(id(s1))
    if ent is not None and ent[0] is s1:
        root1 = ent[1]
    else:
        w1, v1 = np.linalg.eigh(s1)
        w1 = np.clip(w1, 0.0, None)
        root1 = (v1 * np.sqrt(w1)) @ v1.T       # s1^(1/2)
        _ROOT_CACHE.clear()
        _ROOT_CACHE[id(s1)] = (s1, root1)
    m = root1 @ s2 @ root1                       # PSD, similar to s1 s2
    w = np.linalg.eigvalsh(m)
    return np.sqrt(np.clip(w, 0.0, None))


def frechet_distance(mu1: Array, sigma1: Array,
                     mu2: Array, sigma2: Array) -> float:
    """||mu1-mu2||^2 + tr(s1 + s2 - 2 sqrtm(s1 s2))."""
    with tracing.span("eval.frechet"):
        diff = mu1 - mu2
        covmean_trace = float(np.sum(_sqrt_eigvals_of_product(sigma1, sigma2)))
        return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                     - 2.0 * covmean_trace)


def fid_from_features(feats_real, feats_fake) -> float:
    mu1, s1 = gaussian_stats(feats_real)
    mu2, s2 = gaussian_stats(feats_fake)
    return frechet_distance(mu1, s1, mu2, s2)


def polynomial_mmd(x: Array, y: Array, degree: int = 3, gamma: Optional[float] = None,
                   coef0: float = 1.0) -> float:
    """Unbiased MMD^2 with k(a,b) = (gamma a.b + coef0)^degree
    (gamma defaults to 1/d — the KID kernel)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = x.shape[1]
    g = (1.0 / d) if gamma is None else gamma
    k_xx = (g * (x @ x.T) + coef0) ** degree
    k_yy = (g * (y @ y.T) + coef0) ** degree
    k_xy = (g * (x @ y.T) + coef0) ** degree
    m, n = len(x), len(y)
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    sum_xy = k_xy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


# ---------------------------------------------------------------------------
# torch arm of the subset sweeps: per-subset sums of float32 Gram blocks on
# the features' device, stacked and fetched once, finished in float64 on
# the host by the same formulas as the numpy arm


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """KID polynomial kernel block, float32."""
    return (a @ b.T / a.shape[-1] + 1.0) ** 3


def _offdiag_sum(k: torch.Tensor) -> torch.Tensor:
    return k.sum() - torch.trace(k)


def _fetch(stacks) -> list:
    """Per-subset lists of tensors -> float64 numpy arrays, one copy each."""
    return [torch.stack(s).double().cpu().numpy() for s in stacks]


def _subset_tensors(feats_list, idx_lists):
    """The features as float32 tensors on one device (the first tensor's)
    and the subset indices as int64 tensors there."""
    dev = next(f.device for f in feats_list if isinstance(f, torch.Tensor))
    feats = [_as_tensor(f, dev) for f in feats_list]
    idx = [torch.from_numpy(np.stack(ix).astype(np.int64)).to(dev) for ix in idx_lists]
    return feats, idx


def _kid_sums(real, fake, idx_r, idx_f):
    """Per-subset (sum k_xx offdiag, sum k_yy offdiag, sum k_xy)."""
    (real, fake), (ir, jf) = _subset_tensors((real, fake), (idx_r, idx_f))
    out = ([], [], [])
    with torch.no_grad(), _no_tf32():
        for ix, iy in zip(ir, jf):
            x, y = real[ix], fake[iy]
            for acc, v in zip(out, (_offdiag_sum(_gram(x, x)), _offdiag_sum(_gram(y, y)),
                                    _gram(x, y).sum())):
                acc.append(v)
    return _fetch(out)


def _vote_sums(ref, a, b, idx_x, idx_y, idx_z):
    """Per-subset sums for MMD^2(r,a) and MMD^2(r,b) with a shared k_rr."""
    (ref, a, b), (ix_, iy_, iz_) = _subset_tensors((ref, a, b), (idx_x, idx_y, idx_z))
    out = ([], [], [], [], [])
    with torch.no_grad(), _no_tf32():
        for ix, iy, iz in zip(ix_, iy_, iz_):
            r, ya, yb = ref[ix], a[iy], b[iz]
            vals = (_offdiag_sum(_gram(r, r)), _offdiag_sum(_gram(ya, ya)),
                    _gram(r, ya).sum(), _offdiag_sum(_gram(yb, yb)), _gram(r, yb).sum())
            for acc, v in zip(out, vals):
                acc.append(v)
    return _fetch(out)


def _rel_sums(ref, a, b, idx_x, idx_y, idx_z):
    """Per-subset O(m) sufficient statistics of the Bounliphone test: the
    tuple of ``_rel_primitives``, from float32 Gram blocks."""
    (ref, a, b), (ix_, iy_, iz_) = _subset_tensors((ref, a, b), (idx_x, idx_y, idx_z))
    out = tuple([] for _ in range(11))
    with torch.no_grad(), _no_tf32():
        for ix, iy, iz in zip(ix_, iy_, iz_):
            x, y, z = ref[ix], a[iy], b[iz]
            k_yy, k_zz, k_xy, k_xz = _gram(y, y), _gram(z, z), _gram(x, y), _gram(x, z)
            k_yy_nd = k_yy - torch.diag(torch.diagonal(k_yy))
            k_zz_nd = k_zz - torch.diag(torch.diagonal(k_zz))
            h = k_yy_nd - k_zz_nd - k_xy.T - k_xy + k_xz + k_xz.T
            vals = (k_yy_nd.sum(), k_zz_nd.sum(), k_xy.sum(), k_xz.sum(),
                    k_yy_nd.sum(dim=0), k_zz_nd.sum(dim=0),
                    k_xy.sum(dim=1), k_xz.sum(dim=1),
                    k_xy.sum(dim=0), k_xz.sum(dim=0), (h ** 2).sum())
            for acc, v in zip(out, vals):
                acc.append(v)
    return _fetch(out)


def kid_from_features(feats_real, feats_fake, subset_size: int = 1000,
                      n_subsets: int = 50, seed: int = 0,
                      backend: str = "auto") -> Tuple[float, float]:
    """KID: polynomial MMD^2 averaged over random subsets (the
    reference's ``polynomial_mmd_averages``).  Returns (mean, std)."""
    with tracing.span("eval.kid"):
        rng = np.random.default_rng(seed)
        m = min(subset_size, len(feats_real), len(feats_fake))
        idx_r, idx_f = [], []
        for _ in range(n_subsets):
            idx_r.append(rng.choice(len(feats_real), m, replace=False))
            idx_f.append(rng.choice(len(feats_fake), m, replace=False))
        if _resolve_backend(backend, feats_real, feats_fake) == "torch":
            s_xx, s_yy, s_xy = _kid_sums(feats_real, feats_fake, idx_r, idx_f)
            vals = (s_xx / (m * (m - 1)) + s_yy / (m * (m - 1))
                    - 2.0 * s_xy / (m * m))
        else:
            feats_real, feats_fake = _as_numpy(feats_real), _as_numpy(feats_fake)
            vals = np.empty(n_subsets)
            for i in range(n_subsets):
                vals[i] = polynomial_mmd(feats_real[idx_r[i]],
                                         feats_fake[idx_f[i]])
        return float(vals.mean()), float(vals.std())


def inception_score(probs, n_splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over class-probability rows.

    A tensor stays where it lives (float32) and only the per-split
    scalars come back; numpy inputs are computed in float64."""
    with tracing.span("eval.is"):
        on_device = isinstance(probs, torch.Tensor)
        if on_device:
            probs = probs.detach().float()
        else:
            probs = np.asarray(probs, np.float64)
        xp = torch if on_device else np
        scores = []
        n = len(probs)
        for i in range(n_splits):
            part = probs[i * n // n_splits:(i + 1) * n // n_splits]
            if len(part) == 0:
                continue
            py = part.mean(0)[None]
            kl = part * (xp.log(part + 1e-12) - xp.log(py + 1e-12))
            scores.append(xp.exp(kl.sum(1).mean()))
        if on_device:
            scores = torch.stack(scores).double().cpu().numpy()   # one fetch
        scores = np.asarray(scores, np.float64)
        return float(scores.mean()), float(scores.std())


def _norm_cdf(x: float) -> float:
    """Standard normal CDF via erf (no scipy dependency)."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _chi2_sf_even_dof(x: float, dof: int) -> float:
    """Survival function of chi-square with EVEN dof (no scipy): for
    dof = 2k the chi-square is Erlang(k, 1/2), whose sf has the exact
    closed form exp(-x/2) * sum_{i<k} (x/2)^i / i!.  Computed in log
    space so huge Fisher statistics (many tiny p-values) don't
    overflow the h^i terms."""
    k = dof // 2
    if k < 1:
        raise ValueError(f"even dof >= 2 required, got {dof}")
    h = x / 2.0
    if h <= 0.0:
        return 1.0
    logs = [0.0]
    for i in range(1, k):
        logs.append(logs[-1] + np.log(h) - np.log(i))
    mx = max(logs)
    sf = float(np.exp(mx - h) * sum(np.exp(l - mx) for l in logs))
    return min(1.0, max(0.0, sf))


def fisher_combine(ps) -> float:
    """Fisher's method: X = -2 sum ln(p_i) ~ chi^2(2k) under H0 and
    independence.  Subset draws from the same feature pools are
    positively dependent, so the combined value is ANTI-conservative
    (rejects somewhat more often than its nominal level); the
    scheduler's default is a single large-m test, which needs no
    combination at all."""
    ps = [min(1.0, max(float(p), 1e-15)) for p in ps]
    x = -2.0 * float(np.sum(np.log(ps)))
    return _chi2_sf_even_dof(x, 2 * len(ps))


def _poly_kernel(x: Array, y: Array, degree: int = 3,
                 gamma: Optional[float] = None, coef0: float = 1.0) -> Array:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    g = (1.0 / x.shape[1]) if gamma is None else gamma
    return (g * (x @ y.T) + coef0) ** degree


def mmd_diff_var(k_yy: Array, k_zz: Array, k_xy: Array, k_xz: Array) -> float:
    """Variance of MMD^2_u(X,Y) - MMD^2_u(X,Z) under the shared-X
    coupling (Bounliphone et al., ICLR 2016, arXiv:1511.04581): the
    leading 4 zeta_1 covariance built from the three kernel blocks
    (including the cross-covariance terms the shared reference sample
    induces) plus the second-order 2 zeta_2 term, which keeps the
    estimate positive where zeta_1 alone comes out ~zero (the candidates
    are similar, the regime the scheduler tests).

    X is the reference sample; Y, Z the two model samples; all three
    the same size m (the test is defined for equal sizes).
    """
    m = k_xy.shape[0]
    n = k_yy.shape[0]
    r = k_zz.shape[0]
    return _rel_finish(_rel_primitives(k_yy, k_zz, k_xy, k_xz), m, n, r)[1]


def _rel_primitives(k_yy, k_zz, k_xy, k_xz) -> tuple:
    """The 11 sufficient statistics of the Bounliphone test from the
    four dense Gram blocks: ONE definition shared by mmd_diff_var and
    the numpy subset arm (the torch arm's ``_rel_sums`` mirrors it)."""
    k_yy_nd = k_yy - np.diag(np.diagonal(k_yy))
    k_zz_nd = k_zz - np.diag(np.diagonal(k_zz))
    h = k_yy_nd - k_zz_nd - k_xy.T - k_xy + k_xz + k_xz.T
    return (k_yy_nd.sum(), k_zz_nd.sum(), k_xy.sum(), k_xz.sum(),
            k_yy_nd.sum(axis=0), k_zz_nd.sum(axis=0),
            k_xy.sum(axis=1), k_xz.sum(axis=1),
            k_xy.sum(axis=0), k_xz.sum(axis=0),
            (h ** 2).sum())


def _rel_finish(prim, m: int, n: int, r: int) -> Tuple[float, float]:
    """float64 host finishing of the Bounliphone (diff, variance) from the
    O(m) sufficient statistics of the four Gram blocks.

    Every Frobenius-sum of a matrix product in the textbook zeta_1
    form collapses to an inner product of row/column sums —
    sum_{k,l} (A^T B)_{kl} = sum_i rowsum_i(A) rowsum_i(B) — so given
    the primitives the statistic is O(m), and the O(m^2)/O(m^3) Gram
    work can run wherever it is cheapest (device or host) while the
    cancellation-sensitive moment differences stay in float64 here.
    """
    (s_yy, s_zz, s_xy, s_xz, ry, rz, rx_y, rx_z, cy, cz, h2) = [
        np.asarray(p, np.float64) for p in prim]

    u_yy = float(s_yy) / (n * (n - 1))
    u_zz = float(s_zz) / (r * (r - 1))
    u_xy = float(s_xy) / (m * n)
    u_xz = float(s_xz) / (m * r)

    # zeta_1 pieces: variances of the conditional expectations of each
    # U-statistic kernel, then the covariances from the shared X sample
    t1 = (1.0 / n ** 3) * (ry @ ry) - u_yy ** 2
    t2 = (1.0 / (n ** 2 * m)) * (rx_y @ rx_y) - u_xy ** 2
    t3 = (1.0 / (n * m ** 2)) * (cy @ cy) - u_xy ** 2
    t4 = (1.0 / r ** 3) * (rz @ rz) - u_zz ** 2
    t5 = (1.0 / (r * m ** 2)) * (cz @ cz) - u_xz ** 2
    t6 = (1.0 / (r ** 2 * m)) * (rx_z @ rx_z) - u_xz ** 2
    t7 = (1.0 / (n ** 2 * m)) * (ry @ cy) - u_yy * u_xy
    t8 = (1.0 / (n * m * r)) * (rx_y @ rx_z) - u_xy * u_xz
    t9 = (1.0 / (r ** 2 * m)) * (rz @ cz) - u_zz * u_xz

    zeta1 = t1 + t2 + t3 + t4 + t5 + t6 - 2.0 * (t7 + t8 + t9)

    # zeta_2: variance of the full second-order U-statistic kernel
    # h((x_i,y_i,z_i),(x_j,y_j,z_j)) (equal sizes only)
    diff = (u_zz - 2.0 * u_xz) - (u_yy - 2.0 * u_xy)
    zeta2 = (1.0 / (m * (m - 1))) * float(h2) - diff ** 2

    var = (4.0 * (m - 2) / (m * (m - 1))) * zeta1 \
        + (2.0 / (m * (m - 1))) * zeta2
    return float(diff), float(var)


def _three_sample_draws(rng: np.random.Generator, n_subsets: int, m: int,
                        n_ref: int, n_a: int, n_b: int):
    idx_x, idx_y, idx_z = [], [], []
    for _ in range(n_subsets):
        idx_x.append(rng.choice(n_ref, m, replace=False))
        idx_y.append(rng.choice(n_a, m, replace=False))
        idx_z.append(rng.choice(n_b, m, replace=False))
    return idx_x, idx_y, idx_z


def relative_mmd_test(feats_ref, feats_a, feats_b, subset_size: int = 1000,
                      n_subsets: int = 10, seed: int = 0, backend: str = "auto",
                      combine: str = "fisher") -> Tuple[float, float]:
    """Bounliphone et al. relative-MMD three-sample hypothesis test with
    the KID polynomial kernel.

    Statistic: t = [MMD^2_u(ref, B) - MMD^2_u(ref, A)] / sqrt(Var),
    where Var is the shared-X asymptotic variance (mmd_diff_var) and the
    ref-ref block cancels in the difference.  t > 0 favors A.  Returns
    ``(p_value, t)``: SMALL p means candidate A (current samples) is
    significantly closer to the reference than B (best-snapshot samples).

    With ``n_subsets == 1`` this is ONE hypothesis test at size
    ``subset_size``, exactly calibrated.  With several subsets the
    per-subset p-values are combined by ``combine``: ``fisher`` (Fisher's
    method, anti-conservative under subset overlap) or ``mean`` (the mean
    of dependent p-values, not a calibrated p-value).  The returned t is
    always the subset-mean of the t statistics.
    """
    with tracing.span("eval.three_sample_test"):
        if combine not in ("fisher", "mean"):
            raise ValueError(f"combine must be fisher or mean, got {combine!r}")
        m = min(subset_size, len(feats_ref), len(feats_a), len(feats_b))
        rng = np.random.default_rng(seed)
        idx_x, idx_y, idx_z = _three_sample_draws(rng, n_subsets, m, len(feats_ref),
                                                  len(feats_a), len(feats_b))
        if _resolve_backend(backend, feats_ref, feats_a, feats_b) == "torch":
            prims = _rel_sums(feats_ref, feats_a, feats_b, idx_x, idx_y, idx_z)
            stats = [_rel_finish([p[i] for p in prims], m, m, m)
                     for i in range(n_subsets)]
        else:
            feats_ref, feats_a, feats_b = map(_as_numpy, (feats_ref, feats_a, feats_b))
            stats = []
            for i in range(n_subsets):
                x = feats_ref[idx_x[i]]
                y = feats_a[idx_y[i]]
                z = feats_b[idx_z[i]]
                stats.append(_rel_finish(_rel_primitives(
                    _poly_kernel(y, y), _poly_kernel(z, z),
                    _poly_kernel(x, y), _poly_kernel(x, z)), m, m, m))

        ps, ts = [], []
        # diff = MMD^2(X,Z) - MMD^2(X,Y): positive favors A (= Y, the current
        # samples); the common K_XX term cancels in the difference
        for diff, var in stats:
            if var <= 1e-12:
                # degenerate variance estimate: inconclusive, not infinitely
                # significant — never divide by the clamp floor
                ts.append(0.0)
                ps.append(0.5)
                continue
            t = float(diff / np.sqrt(var))
            ts.append(t)
            ps.append(1.0 - _norm_cdf(t))
        if combine == "fisher" and len(ps) > 1:
            return fisher_combine(ps), float(np.mean(ts))
        return float(np.mean(ps)), float(np.mean(ts))


def relative_similarity_test(feats_ref, feats_a, feats_b, subset_size: int = 1000,
                             n_subsets: int = 10, seed: int = 0,
                             backend: str = "auto") -> float:
    """Fraction of subset draws where candidate A (current samples) is
    CLOSER to the reference than B (best-checkpoint samples) by KID's
    MMD^2; > 0.5 means A improved on B (the scheduler's vote arm)."""
    with tracing.span("eval.three_sample_test"):
        rng = np.random.default_rng(seed)
        m = min(subset_size, len(feats_ref), len(feats_a), len(feats_b))
        idx_x, idx_y, idx_z = _three_sample_draws(rng, n_subsets, m, len(feats_ref),
                                                  len(feats_a), len(feats_b))
        if _resolve_backend(backend, feats_ref, feats_a, feats_b) == "torch":
            s_rr, s_aa, s_ra, s_bb, s_rb = _vote_sums(feats_ref, feats_a, feats_b,
                                                      idx_x, idx_y, idx_z)
            off = m * (m - 1)
            mmd_a = s_rr / off + s_aa / off - 2.0 * s_ra / (m * m)
            mmd_b = s_rr / off + s_bb / off - 2.0 * s_rb / (m * m)
            return float((mmd_a < mmd_b).mean())
        feats_ref, feats_a, feats_b = map(_as_numpy, (feats_ref, feats_a, feats_b))
        wins = 0
        for i in range(n_subsets):
            r = feats_ref[idx_x[i]]
            a = feats_a[idx_y[i]]
            b = feats_b[idx_z[i]]
            if polynomial_mmd(r, a) < polynomial_mmd(r, b):
                wins += 1
        return wins / n_subsets
