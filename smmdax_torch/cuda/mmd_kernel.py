"""Fused pairwise-kernel MMD sums on the card (port of
``smmdax/pallas/mmd_kernel.py``, pair-sum half).

Two hand-written CUDA kernels (``smmdax_torch/csrc/pair_sum.cu``):

* ``pair_sum`` replaces ``_fwd_kernel``/``_pair_sum`` (mmd_kernel.py:141-179):
  S(a, b) = sum_ij mask * k(||a_i - b_j||^2) without a Gram matrix in
  device memory; per-block partials plus a fixed-order second pass.
* ``pair_sum_grad_a`` replaces ``_bwd_kernel``/``_pair_sum_grad_a``
  (mmd_kernel.py:186-242): sum_j g_ij (a_i - b_j) [+ (add_dot/2) b_j],
  one block per row block of a, looping over the column tiles of b.

Bound on the card: launch latency at the flagship's 64 x 16 features;
float32 operations (d FMAs plus the mixture's exp/log1p per pair) at
large m, n.  See the source for the design.

Each wrapper launches its kernel for a CUDA tensor (or raises) and uses
its plain PyTorch version (``pair_sum_plain``, ``pair_sum_grad_a_plain``)
only for a tensor on the CPU.  ``<wrapper>.launches`` counts kernel
launches.  Inputs are cast to float32, as ``_tile_pad`` does; no padding
is needed, the kernels mask ragged edges themselves.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from smmdax_torch.cuda import build
from smmdax_torch.kernels.kernels import DIST_EPS, _mix_rbf, _mix_rq
from smmdax_torch.kernels.mmd import MMDSums, mmd2_from_sums

Tensor = torch.Tensor

_KINDS = {"gaussian": 0, "rq": 1, "distance": 2}
_MAX_PARAMS = 8


class _Mix(ctypes.Structure):
    """``struct Mix`` of pair_sum.cu, passed by value."""
    _fields_ = [("kind", ctypes.c_int), ("n", ctypes.c_int),
                ("add_dot", ctypes.c_float),
                ("p", ctypes.c_float * _MAX_PARAMS)]


def kernel_diag(kernel: str, params: Sequence[float]) -> float:
    """The constant k(x, x) of the supported kernels."""
    if kernel in ("gaussian", "rq"):
        return float(len(params))
    if kernel == "distance":
        return -float(DIST_EPS) ** 0.5
    raise ValueError(kernel)


def canon_kernel(kernel: str, params: Sequence[float], add_dot: float):
    """Canonical (kernel, params, add_dot): the dot kernel is an empty rq
    mixture plus the add_dot term at weight 1."""
    if kernel == "dot":
        return "rq", (), 1.0
    return kernel, tuple(float(p) for p in params), float(add_dot)


# ---------------------------------------------------------------------------
# plain versions (dense masked d^2 / k / g)


def _dists(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    dot = a @ b.T
    d2 = (torch.sum(a * a, dim=1, keepdim=True)
          + torch.sum(b * b, dim=1, keepdim=True).T - 2.0 * dot)
    return torch.clamp_min(d2, 0.0), dot


def _mixture_k(d2: Tensor, kernel: str, params, add_dot: float,
               dot: Tensor) -> Tensor:
    if kernel == "gaussian":
        return _mix_rbf(d2, params, None)
    if kernel == "rq":
        return _mix_rq(d2, params, None, add_dot, dot)
    if kernel == "distance":
        return -torch.sqrt(d2 + DIST_EPS)
    raise ValueError(kernel)


def _mixture_g(d2: Tensor, kernel: str, params) -> Tensor:
    """g = dk/d(d2) of the mixture."""
    g = torch.zeros_like(d2)
    if kernel == "gaussian":
        for s in params:
            gamma = 1.0 / (2.0 * float(s) ** 2)
            g = g + (-gamma) * torch.exp(-gamma * d2)
    elif kernel == "rq":
        for a in params:
            a = float(a)
            g = g + (-0.5) * torch.exp(-(a + 1.0) * torch.log1p(d2 / (2.0 * a)))
    elif kernel == "distance":
        g = -0.5 / torch.sqrt(d2 + DIST_EPS)
    else:
        raise ValueError(kernel)
    return g


def _mask(m: int, n: int, exclude_diag: bool, device) -> Tensor:
    if exclude_diag:
        return ~torch.eye(m, n, dtype=torch.bool, device=device)
    return torch.ones(m, n, dtype=torch.bool, device=device)


def pair_sum_plain(a: Tensor, b: Tensor, kernel: str, params,
                   exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """Plain version of the ``pair_sum`` kernel."""
    d2, dot = _dists(a, b)
    k = _mixture_k(d2, kernel, params, add_dot, dot)
    mask = _mask(a.shape[0], b.shape[0], exclude_diag, a.device)
    return torch.sum(torch.where(mask, k, 0.0))


def pair_sum_grad_a_plain(a: Tensor, b: Tensor, kernel: str, params,
                          exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """Plain version of the ``pair_sum_grad_a`` kernel."""
    d2, _ = _dists(a, b)
    g = _mixture_g(d2, kernel, params)
    mask = _mask(a.shape[0], b.shape[0], exclude_diag, a.device)
    grow = torch.where(mask, g, 0.0)
    gmat = grow if not add_dot else torch.where(mask, g - 0.5 * add_dot, 0.0)
    return torch.sum(grow, dim=1, keepdim=True) * a - gmat @ b


# ---------------------------------------------------------------------------
# kernel wrappers


def _prepare(a: Tensor, b: Tensor, kernel: str, params,
             add_dot: float) -> Tuple[Tensor, Tensor]:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"pair sums need (m, d) and (n, d) features, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"features on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-sum kernel for {a.device} tensors")
    if kernel not in _KINDS:
        raise ValueError(f"no fused pair-sum kernel for {kernel!r}")
    if len(params) > _MAX_PARAMS:
        raise ValueError(f"at most {_MAX_PARAMS} mixture terms, got {len(params)}")
    if add_dot and kernel != "rq":
        raise ValueError("add_dot applies to the rq mixture only")
    return a.float().contiguous(), b.float().contiguous()


def _mix(kernel: str, params, add_dot: float) -> _Mix:
    if kernel == "gaussian":
        coeffs = [1.0 / (2.0 * float(s) ** 2) for s in params]
    elif kernel == "rq":
        coeffs = [float(p) for p in params]
    else:
        coeffs = []
    mix = _Mix(kind=_KINDS[kernel], n=len(coeffs), add_dot=float(add_dot))
    for t, c in enumerate(coeffs):
        mix.p[t] = c
    return mix


@functools.cache
def _pair_sum_lib() -> ctypes.CDLL:
    lib = build.library()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.smmdax_pair_sum_partials.argtypes = [ci, ci]
    lib.smmdax_pair_sum_partials.restype = ci
    lib.smmdax_pair_sum_fwd.argtypes = [vp, vp, vp, ci, vp, ci, ci, ci, ci, _Mix, vp]
    lib.smmdax_pair_sum_fwd.restype = ci
    lib.smmdax_pair_sum_grad_a.argtypes = [vp, vp, vp, ci, ci, ci, ci, _Mix, vp]
    lib.smmdax_pair_sum_grad_a.restype = ci
    return lib


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pair_sum(a: Tensor, b: Tensor, kernel: str, params, exclude_diag: bool,
             add_dot: float = 0.0) -> Tensor:
    """S = sum_ij mask * k(d2(a_i, b_j)), a float32 scalar."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    if a.device.type == "cpu":
        return pair_sum_plain(a, b, kernel, params, exclude_diag, add_dot)
    lib = _pair_sum_lib()
    (m, d), n = a.shape, b.shape[0]
    num = lib.smmdax_pair_sum_partials(m, n)
    partials = torch.empty(num, dtype=torch.float32, device=a.device)
    out = torch.empty((), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_sum_fwd(
            a.data_ptr(), b.data_ptr(), partials.data_ptr(), num,
            out.data_ptr(), m, n, d, int(exclude_diag),
            _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_sum")
    pair_sum.launches += 1
    return out


pair_sum.launches = 0


def pair_sum_grad_a(a: Tensor, b: Tensor, kernel: str, params,
                    exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """d/da of sum_ij k(d2(a_i, b_j)) without the cotangent and pair
    factor: sum_j g_ij (a_i - b_j) [+ (add_dot/2) b_j], shape of a."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    if a.device.type == "cpu":
        return pair_sum_grad_a_plain(a, b, kernel, params, exclude_diag,
                                     add_dot)
    lib = _pair_sum_lib()
    (m, d), n = a.shape, b.shape[0]
    da = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_sum_grad_a(
            a.data_ptr(), b.data_ptr(), da.data_ptr(), m, n, d,
            int(exclude_diag), _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_sum_grad_a")
    pair_sum_grad_a.launches += 1
    return da


pair_sum_grad_a.launches = 0


# ---------------------------------------------------------------------------
# public: differentiable sufficient statistics + mmd2


class _FusedMMDSums(torch.autograd.Function):
    """(sum_xx offdiag, sum_yy offdiag, sum_xy), first-order
    differentiable in x and y.  The witness penalty differentiates the
    dense ``kernel_cross`` instead, so this path is never differentiated
    twice."""

    @staticmethod
    def forward(ctx, x, y, kernel, params, add_dot):
        ctx.save_for_backward(x, y)
        ctx.kernel = (kernel, params, add_dot)
        return (pair_sum(x, x, kernel, params, True, add_dot),
                pair_sum(y, y, kernel, params, True, add_dot),
                pair_sum(x, y, kernel, params, False, add_dot))

    @staticmethod
    @once_differentiable
    def backward(ctx, c_xx, c_yy, c_xy):
        x, y = ctx.saved_tensors
        kernel, params, add_dot = ctx.kernel
        dx = dy = None
        # sum_xx counts each unordered pair twice and d(d2)/dx = 2(x_i - x_j):
        # factor 4 on the self-blocks, 2 on the cross block
        if ctx.needs_input_grad[0]:
            dx = (4.0 * c_xx) * pair_sum_grad_a(x, x, kernel, params, True, add_dot)
            dx = dx + (2.0 * c_xy) * pair_sum_grad_a(x, y, kernel, params, False, add_dot)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = (4.0 * c_yy) * pair_sum_grad_a(y, y, kernel, params, True, add_dot)
            dy = dy + (2.0 * c_xy) * pair_sum_grad_a(y, x, kernel, params, False, add_dot)
            dy = dy.to(y.dtype)
        return dx, dy, None, None, None


def make_fused_mmd_sums(kernel: str, params: Sequence[float],
                        add_dot: float = 0.0):
    """Returns fused_sums(x, y) -> (sum_xx_offdiag, sum_yy_offdiag, sum_xy)."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)

    def fused_sums(x: Tensor, y: Tensor):
        return _FusedMMDSums.apply(x, y, kernel, params, add_dot)

    return fused_sums


def fused_mmd2(x: Tensor, y: Tensor, kernel: str = "rq",
               params: Sequence[float] = (0.2, 0.5, 1.0, 2.0, 5.0),
               biased: bool = False, add_dot: float = 0.0) -> Tensor:
    """Unbiased (or biased) MMD^2 through the fused pair sums; the same
    estimator as ``mmd2(kernel_matrices(...))``.  With ``add_dot`` the
    biased path adds the data-dependent diagonal add_dot * ||x||^2 back."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)
    sums = MMDSums(*make_fused_mmd_sums(kernel, params, add_dot)(x, y),
                   float(x.shape[0]), float(y.shape[0]))
    if not biased:
        return mmd2_from_sums(sums)
    k_diag = kernel_diag(kernel, params)
    diag_xx = x.shape[0] * k_diag
    diag_yy = y.shape[0] * k_diag
    if add_dot:
        diag_xx = diag_xx + add_dot * torch.sum(x.float() ** 2)
        diag_yy = diag_yy + add_dot * torch.sum(y.float() ** 2)
    return mmd2_from_sums(sums, biased=True, diag_xx=diag_xx, diag_yy=diag_yy)
