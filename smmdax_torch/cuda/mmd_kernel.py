"""Fused pairwise-kernel MMD sums and block statistics on the card (port
of ``smmdax/pallas/mmd_kernel.py``).

Four hand-written CUDA kernels:

* ``pair_sum`` (``csrc/pair_sum.cu``) replaces ``_fwd_kernel``/``_pair_sum``
  (mmd_kernel.py:141-179): S(a, b) = sum_ij mask * k(||a_i - b_j||^2)
  without a Gram matrix in device memory; one partial per 2D tile plus a
  fixed-order second pass.  Its launches count on ``mmd.pair_sum.launches``.
* the pair-sum gradient (``csrc/pair_sum.cu``) replaces
  ``_bwd_kernel``/``_pair_sum_grad_a`` (mmd_kernel.py:186-242):
  sum_j g_ij (a_i - b_j) [+ (add_dot/2) b_j] for a, and the same for b
  from the same sweep, times scale * c with the cotangent c read on the
  card (``pair_sum_grad``; ``pair_sum_grad_a`` is the da-only call with
  c = 1).  Its launches count on ``mmd.pair_sum_grad_a.launches``.
* the stats forward (``csrc/pair_stats.cu``) replaces
  ``_stats_kernel``/``_pair_stats_fwd`` (mmd_kernel.py:323-384): the row
  sums (m,), optionally the column sums (n,), and the sum of squares of the
  masked Gram block in one sweep over 2D tiles (``pair_block_stats``;
  ``pair_stats`` is the rows-only call).  Its launches count on
  ``mmd.pair_stats.launches``.
* the stats gradient (``csrc/pair_stats.cu``) replaces
  ``_stats_bwd_kernel``/``_pair_stats_grad_a`` (mmd_kernel.py:387-452):
  dS/da and dS/db of S = sum_i u_i row_i + sum_j v_j col_j + c sum k^2 in
  one sweep, coeff = u_i + v_j + 2 c k_ij (``pair_block_stats_grad``;
  ``pair_stats_grad_a`` is the da-only call).  Its launches count on
  ``mmd.pair_stats_grad_a.launches``.

All four run on the tile engine of ``csrc/tiles.cuh``.  Bound on the
card: launch latency at the flagship's 64 x 16 features; float32
operations (d FMAs plus the mixture's exp/log1p per pair) at large m, n.
See the sources for the design.

Each wrapper launches its kernel for a CUDA tensor (or raises) and uses
its plain PyTorch version (``<wrapper>_plain``) only for a tensor on the
CPU.  The launch counters named above are counters of
``smmdax_torch.tracing``, one per TPU kernel: they count launches made from
the host while tracing is on, and ``tracing.drain()`` reads them.  Inputs
are cast to float32, as ``_tile_pad`` does; no padding is needed, the
kernels mask ragged edges themselves.

The differentiable pieces: ``make_fused_mmd_sums``/``fused_mmd2`` (single
device), and ``make_pair_sum``, ``make_row_stats``, ``make_pair_stats``
(the blocks of the ring estimators).  All are first-order only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from smmdax_torch import tracing
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


def pair_sum_grad_plain(a: Tensor, b: Tensor, c, kernel: str, params,
                        exclude_diag: bool, add_dot: float = 0.0, need_a: bool = True,
                        need_b: bool = True, scale: float = 1.0):
    """Plain version of the one-sweep pair-sum gradient ``pair_sum_grad``:
    (da or None, db or None), times scale * c (c None reads as 1)."""
    d2, _ = _dists(a, b)
    g = _mixture_g(d2, kernel, params)
    mask = _mask(a.shape[0], b.shape[0], exclude_diag, a.device)
    grow = torch.where(mask, g, 0.0)
    gmat = grow if not add_dot else torch.where(mask, g - 0.5 * add_dot, 0.0)
    f = scale if c is None else scale * c
    da = f * (torch.sum(grow, dim=1, keepdim=True) * a - gmat @ b) if need_a else None
    db = f * (torch.sum(grow, dim=0)[:, None] * b - gmat.T @ a) if need_b else None
    return da, db


def pair_sum_grad_a_plain(a: Tensor, b: Tensor, kernel: str, params,
                          exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """Plain version of the ``pair_sum_grad_a`` kernel call."""
    return pair_sum_grad_plain(a, b, None, kernel, params, exclude_diag, add_dot,
                               need_b=False)[0]


def pair_block_stats_plain(a: Tensor, b: Tensor, kernel: str, params,
                           exclude_diag: bool, add_dot: float = 0.0,
                           want_cols: bool = True):
    """Plain version of the one-sweep stats forward ``pair_block_stats``."""
    d2, dot = _dists(a, b)
    k = _mixture_k(d2, kernel, params, add_dot, dot)
    k = torch.where(_mask(a.shape[0], b.shape[0], exclude_diag, a.device), k, 0.0)
    return torch.sum(k, dim=1), (torch.sum(k, dim=0) if want_cols else None), torch.sum(k * k)


def pair_block_stats_grad_plain(a: Tensor, b: Tensor, u, v, c_sq: Tensor,
                                kernel: str, params, exclude_diag: bool,
                                add_dot: float = 0.0, need_a: bool = True,
                                need_b: bool = True, scale: float = 1.0):
    """Plain version of the one-sweep stats gradient
    ``pair_block_stats_grad``: (da or None, db or None); u or v None reads
    as zeros."""
    d2, dot = _dists(a, b)
    k = _mixture_k(d2, kernel, params, add_dot, dot)
    g = _mixture_g(d2, kernel, params)
    mask = _mask(a.shape[0], b.shape[0], exclude_diag, a.device)
    coeff = 2.0 * c_sq * k
    if u is not None:
        coeff = coeff + u[:, None]
    if v is not None:
        coeff = coeff + v[None, :]
    t = torch.where(mask, coeff * g, 0.0)
    tmat = t if not add_dot else torch.where(mask, coeff * (g - 0.5 * add_dot), 0.0)
    da = scale * (torch.sum(t, dim=1, keepdim=True) * a - tmat @ b) if need_a else None
    db = scale * (torch.sum(t, dim=0)[:, None] * b - tmat.T @ a) if need_b else None
    return da, db


def pair_stats_plain(a: Tensor, b: Tensor, kernel: str, params,
                     exclude_diag: bool, add_dot: float = 0.0
                     ) -> Tuple[Tensor, Tensor]:
    """Plain version of the ``pair_stats`` kernel."""
    rows, _, sq = pair_block_stats_plain(a, b, kernel, params, exclude_diag,
                                         add_dot, want_cols=False)
    return rows, sq


def pair_stats_grad_a_plain(a: Tensor, b: Tensor, u: Tensor, v: Tensor,
                            c_sq: Tensor, kernel: str, params,
                            exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """Plain version of the ``pair_stats_grad_a`` kernel."""
    return pair_block_stats_grad_plain(a, b, u, v, c_sq, kernel, params,
                                       exclude_diag, add_dot, need_b=False)[0]


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
    """The mixture struct, built once per (kernel, params, add_dot)."""
    return _mix_cached(kernel, tuple(float(p) for p in params), float(add_dot))


@functools.cache
def _mix_cached(kernel: str, params: Tuple[float, ...], add_dot: float) -> _Mix:
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


def _prepare_scalar(a: Tensor, c: Tensor, what: str) -> Tensor:
    """A one-element coefficient as a float32 scalar on a's device."""
    if c.numel() != 1 or c.device != a.device:
        raise ValueError(f"{what} {tuple(c.shape)} on {c.device} for features "
                         f"on {a.device}")
    return c.float().reshape(()).contiguous()


def _prepare_coeffs(a: Tensor, b: Tensor, u, v, c_sq: Tensor):
    """u (m,) or None, v (n,) or None and the scalar c_sq as float32 on
    a's device."""
    for x, rows, what in ((u, a.shape[0], "u"), (v, b.shape[0], "v")):
        if x is not None and (x.shape != (rows,) or x.device != a.device):
            raise ValueError(f"coefficient {what} {tuple(x.shape)} on {x.device} for "
                             f"a {tuple(a.shape)}, b {tuple(b.shape)} on {a.device}")
    return (None if u is None else u.float().contiguous(),
            None if v is None else v.float().contiguous(),
            _prepare_scalar(a, c_sq, "c_sq"))


@functools.cache
def _pair_sum_lib() -> ctypes.CDLL:
    lib = build.library("pair_sum.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, cf = ctypes.c_longlong, ctypes.c_float
    lib.smmdax_pair_sum_fwd_scratch.argtypes = [ci, ci]
    lib.smmdax_pair_sum_fwd_scratch.restype = ll
    lib.smmdax_pair_sum_fwd.argtypes = [vp, vp, vp, vp, ll, ci, ci, ci, ci, _Mix, vp]
    lib.smmdax_pair_sum_fwd.restype = ci
    lib.smmdax_pair_sum_grad_scratch.argtypes = [ci, ci, ci, ci, ci]
    lib.smmdax_pair_sum_grad_scratch.restype = ll
    lib.smmdax_pair_sum_grad.argtypes = [vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, cf,
                                         _Mix, vp]
    lib.smmdax_pair_sum_grad.restype = ci
    return lib


@functools.cache
def _pair_stats_lib() -> ctypes.CDLL:
    lib = build.library("pair_stats.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll, cf = ctypes.c_longlong, ctypes.c_float
    lib.smmdax_pair_stats_fwd_scratch.argtypes = [ci, ci, ci]
    lib.smmdax_pair_stats_fwd_scratch.restype = ll
    lib.smmdax_pair_stats_fwd.argtypes = [vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, _Mix, vp]
    lib.smmdax_pair_stats_fwd.restype = ci
    lib.smmdax_pair_stats_grad_scratch.argtypes = [ci, ci, ci, ci, ci]
    lib.smmdax_pair_stats_grad_scratch.restype = ll
    lib.smmdax_pair_stats_grad.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci,
                                           cf, _Mix, vp]
    lib.smmdax_pair_stats_grad.restype = ci
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
    scratch = lib.smmdax_pair_sum_fwd_scratch(m, n)
    buf = torch.empty(1 + scratch, dtype=torch.float32, device=a.device)
    ptr = buf.data_ptr()
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_sum_fwd(
            a.data_ptr(), b.data_ptr(), ptr, ptr + 4, scratch, m, n, d, int(exclude_diag),
            _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_sum")
    tracing.count("mmd.pair_sum.launches")
    return buf[0]


def _sum_grad(a: Tensor, b: Tensor, c, kernel: str, params, exclude_diag: bool,
              add_dot: float, need_a: bool, need_b: bool, scale: float):
    """One launch of the pair-sum gradient kernel: (da or None, db or
    None); c None reads as 1."""
    lib = _pair_sum_lib()
    (m, d), n = a.shape, b.shape[0]
    md, nd = (m * d if need_a else 0), (n * d if need_b else 0)
    out = torch.empty(md + nd, dtype=torch.float32, device=a.device)
    scratch = lib.smmdax_pair_sum_grad_scratch(m, n, d, int(need_a), int(need_b))
    part = torch.empty(scratch, dtype=torch.float32, device=a.device)
    ptr = out.data_ptr()
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_sum_grad(
            a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
            ptr if need_a else None, ptr + 4 * md if need_b else None, part.data_ptr(),
            scratch, m, n, d, int(exclude_diag), float(scale),
            _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_sum_grad")
    tracing.count("mmd.pair_sum_grad_a.launches")
    return (out[:md].view(m, d) if need_a else None,
            out[md:].view(n, d) if need_b else None)


def pair_sum_grad(a: Tensor, b: Tensor, c, kernel: str, params, exclude_diag: bool,
                  add_dot: float = 0.0, need_a: bool = True, need_b: bool = True,
                  scale: float = 1.0):
    """(d/da, d/db) of S = sum_ij mask * k(d2(a_i, b_j)) times
    ``scale * c``, without the pair factor 2 of d(d2)/da (fold it into
    ``scale``), in one sweep; each is None unless asked for.  ``c`` is a
    one-element tensor on a's device (read there, never on the host), or
    None for 1."""
    if not (need_a or need_b):
        raise ValueError("pair_sum_grad needs need_a or need_b")
    a, b = _prepare(a, b, kernel, params, add_dot)
    c = None if c is None else _prepare_scalar(a, c, "c")
    if a.device.type == "cpu":
        return pair_sum_grad_plain(a, b, c, kernel, params, exclude_diag, add_dot,
                                   need_a, need_b, scale)
    return _sum_grad(a, b, c, kernel, params, exclude_diag, add_dot, need_a, need_b,
                     scale)


def pair_sum_grad_a(a: Tensor, b: Tensor, kernel: str, params,
                    exclude_diag: bool, add_dot: float = 0.0) -> Tensor:
    """d/da of sum_ij k(d2(a_i, b_j)) without the cotangent and pair
    factor: sum_j g_ij (a_i - b_j) [+ (add_dot/2) b_j], shape of a (the
    pair-sum gradient kernel without db, c = 1)."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    if a.device.type == "cpu":
        return pair_sum_grad_a_plain(a, b, kernel, params, exclude_diag,
                                     add_dot)
    return _sum_grad(a, b, None, kernel, params, exclude_diag, add_dot, True, False,
                     1.0)[0]


def _stats_fwd(a: Tensor, b: Tensor, kernel: str, params, exclude_diag: bool,
               add_dot: float, want_cols: bool):
    """One launch of the stats forward kernel: (rows, cols or None,
    sum_sq), outputs and scratch in one allocation."""
    lib = _pair_stats_lib()
    (m, d), n = a.shape, b.shape[0]
    nc = n if want_cols else 0
    scratch = lib.smmdax_pair_stats_fwd_scratch(m, n, int(want_cols))
    buf = torch.empty(m + nc + 1 + scratch, dtype=torch.float32, device=a.device)
    ptr = buf.data_ptr()
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_stats_fwd(
            a.data_ptr(), b.data_ptr(), ptr, ptr + 4 * m if want_cols else None,
            ptr + 4 * (m + nc), ptr + 4 * (m + nc + 1), scratch, m, n, d,
            int(exclude_diag), _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_stats")
    tracing.count("mmd.pair_stats.launches")
    return buf[:m], (buf[m:m + n] if want_cols else None), buf[m + nc]


def _stats_grad(a: Tensor, b: Tensor, u, v, c_sq: Tensor, kernel: str, params,
                exclude_diag: bool, add_dot: float, need_a: bool, need_b: bool,
                scale: float):
    """One launch of the stats gradient kernel: (da or None, db or None)."""
    lib = _pair_stats_lib()
    (m, d), n = a.shape, b.shape[0]
    md, nd = (m * d if need_a else 0), (n * d if need_b else 0)
    out = torch.empty(md + nd, dtype=torch.float32, device=a.device)
    scratch = lib.smmdax_pair_stats_grad_scratch(m, n, d, int(need_a), int(need_b))
    part = torch.empty(scratch, dtype=torch.float32, device=a.device)
    ptr = out.data_ptr()
    with torch.cuda.device(a.device):
        err = lib.smmdax_pair_stats_grad(
            a.data_ptr(), b.data_ptr(), None if u is None else u.data_ptr(),
            None if v is None else v.data_ptr(), c_sq.data_ptr(),
            ptr if need_a else None, ptr + 4 * md if need_b else None,
            part.data_ptr(), scratch, m, n, d, int(exclude_diag), float(scale),
            _mix(kernel, params, add_dot), _stream(a))
    build.check(lib, err, "pair_stats_grad_a")
    tracing.count("mmd.pair_stats_grad_a.launches")
    return (out[:md].view(m, d) if need_a else None,
            out[md:].view(n, d) if need_b else None)


def pair_block_stats(a: Tensor, b: Tensor, kernel: str, params,
                     exclude_diag: bool, add_dot: float = 0.0,
                     want_cols: bool = True):
    """(rows (m,), cols (n,) or None, sum_sq ()) of the masked Gram block
    k(d2(a_i, b_j)) in one sweep, float32."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    if a.device.type == "cpu":
        return pair_block_stats_plain(a, b, kernel, params, exclude_diag, add_dot,
                                      want_cols)
    return _stats_fwd(a, b, kernel, params, exclude_diag, add_dot, want_cols)


def pair_block_stats_grad(a: Tensor, b: Tensor, u, v, c_sq: Tensor, kernel: str,
                          params, exclude_diag: bool, add_dot: float = 0.0,
                          need_a: bool = True, need_b: bool = True,
                          scale: float = 1.0):
    """(d/da, d/db) of S = sum_i u_i rows_i + sum_j v_j cols_j
    + c_sq * sum_sq, times ``scale`` (the pair factor 2 of d(d2)/da is
    left to the caller), in one sweep; each is None unless asked for.  u
    or v None reads as zeros; ``c_sq`` is a one-element tensor on a's
    device (read there, never on the host)."""
    if not (need_a or need_b):
        raise ValueError("pair_block_stats_grad needs need_a or need_b")
    a, b = _prepare(a, b, kernel, params, add_dot)
    u, v, c_sq = _prepare_coeffs(a, b, u, v, c_sq)
    if a.device.type == "cpu":
        return pair_block_stats_grad_plain(a, b, u, v, c_sq, kernel, params,
                                           exclude_diag, add_dot, need_a, need_b,
                                           scale)
    return _stats_grad(a, b, u, v, c_sq, kernel, params, exclude_diag, add_dot,
                       need_a, need_b, scale)


def pair_stats(a: Tensor, b: Tensor, kernel: str, params, exclude_diag: bool,
               add_dot: float = 0.0) -> Tuple[Tensor, Tensor]:
    """(rows, sum_sq): the row sums (m,) and the sum of squared entries of
    the masked Gram block k(d2(a_i, b_j)), float32 (the stats forward
    kernel without its column sums)."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    if a.device.type == "cpu":
        return pair_stats_plain(a, b, kernel, params, exclude_diag, add_dot)
    rows, _, sq = _stats_fwd(a, b, kernel, params, exclude_diag, add_dot, False)
    return rows, sq


def pair_stats_grad_a(a: Tensor, b: Tensor, u: Tensor, v: Tensor, c_sq: Tensor,
                      kernel: str, params, exclude_diag: bool,
                      add_dot: float = 0.0) -> Tensor:
    """d/da of S = sum_i u_i rows_i + sum_j v_j cols_j + c_sq * sum_sq
    without the pair factor 2, shape of a (the stats gradient kernel
    without db).  ``c_sq`` is a one-element tensor on a's device (read
    there, never on the host)."""
    a, b = _prepare(a, b, kernel, params, add_dot)
    u, v, c_sq = _prepare_coeffs(a, b, u, v, c_sq)
    if a.device.type == "cpu":
        return pair_stats_grad_a_plain(a, b, u, v, c_sq, kernel, params,
                                       exclude_diag, add_dot)
    return _stats_grad(a, b, u, v, c_sq, kernel, params, exclude_diag, add_dot,
                       True, False, 1.0)[0]


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
        need_x, need_y = ctx.needs_input_grad[:2]
        dx = dy = None
        # sum_xx counts each unordered pair twice and d(d2)/dx = 2(x_i - x_j):
        # factor 4 on the self blocks, 2 on the cross block, whose one sweep
        # gives the cross terms of dx and dy.  The cotangents stay on the card.
        gx, gy = pair_sum_grad(x, y, c_xy, kernel, params, False, add_dot,
                               need_a=need_x, need_b=need_y, scale=2.0)
        if need_x:
            dx = pair_sum_grad(x, x, c_xx, kernel, params, True, add_dot,
                               need_b=False, scale=4.0)[0]
            dx = (dx + gx).to(x.dtype)
        if need_y:
            dy = pair_sum_grad(y, y, c_yy, kernel, params, True, add_dot,
                               need_b=False, scale=4.0)[0]
            dy = (dy + gy).to(y.dtype)
        return dx, dy, None, None, None


def make_fused_mmd_sums(kernel: str, params: Sequence[float],
                        add_dot: float = 0.0):
    """Returns fused_sums(x, y) -> (sum_xx_offdiag, sum_yy_offdiag, sum_xy)."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)

    def fused_sums(x: Tensor, y: Tensor):
        return _FusedMMDSums.apply(x, y, kernel, params, add_dot)

    return fused_sums


class _PairSum(torch.autograd.Function):
    """S(a, b) = sum_ij mask * k(d2(a_i, b_j)), first-order differentiable
    in a and b (mmd_kernel.py:516-545).  The backward is one launch of the
    pair-sum gradient kernel for whichever of a and b needs a gradient,
    scale 2 from d(d2)/da.  When a and b are one tensor the two gradients
    add up to the factor-4 gradient of a self block."""

    @staticmethod
    def forward(ctx, a, b, kernel, params, exclude_diag, add_dot):
        ctx.save_for_backward(a, b)
        ctx.kernel = (kernel, params, exclude_diag, add_dot)
        return pair_sum(a, b, kernel, params, exclude_diag, add_dot)

    @staticmethod
    @once_differentiable
    def backward(ctx, c):
        a, b = ctx.saved_tensors
        kernel, params, excl, add_dot = ctx.kernel
        da, db = pair_sum_grad(a, b, c, kernel, params, excl, add_dot,
                               need_a=ctx.needs_input_grad[0],
                               need_b=ctx.needs_input_grad[1], scale=2.0)
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None, None, None, None)


def make_pair_sum(kernel: str, params: Sequence[float], exclude_diag: bool,
                  add_dot: float = 0.0):
    """Differentiable fused S(a, b) = sum_ij mask * k(d2(a_i, b_j)): the
    block the ring estimator sums over its rotations."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)

    def pair_sum_fn(a: Tensor, b: Tensor) -> Tensor:
        return _PairSum.apply(a, b, kernel, params, exclude_diag, add_dot)

    return pair_sum_fn


class _RowStats(torch.autograd.Function):
    """(rows (m,), sum_sq) of the masked Gram block, first-order
    differentiable (mmd_kernel.py:455-497).  The backward is one launch of
    the stats gradient kernel with (u, 0, c) for whichever of a and b needs
    a gradient, scale 2 from d(d2)/da."""

    @staticmethod
    def forward(ctx, a, b, kernel, params, exclude_diag, add_dot):
        ctx.save_for_backward(a, b)
        ctx.kernel = (kernel, params, exclude_diag, add_dot)
        return pair_stats(a, b, kernel, params, exclude_diag, add_dot)

    @staticmethod
    @once_differentiable
    def backward(ctx, u, c_sq):
        return _stats_backward(ctx, u, None, c_sq)


class _PairStats(torch.autograd.Function):
    """(rows (m,), cols (n,), sum_sq) of the masked Gram block from one
    sweep, first-order differentiable; the backward is one launch of the
    stats gradient kernel with (u, v, c)."""

    @staticmethod
    def forward(ctx, a, b, kernel, params, exclude_diag, add_dot):
        ctx.save_for_backward(a, b)
        ctx.kernel = (kernel, params, exclude_diag, add_dot)
        return pair_block_stats(a, b, kernel, params, exclude_diag, add_dot)

    @staticmethod
    @once_differentiable
    def backward(ctx, u, v, c_sq):
        return _stats_backward(ctx, u, v, c_sq)


def _stats_backward(ctx, u, v, c_sq):
    a, b = ctx.saved_tensors
    kernel, params, excl, add_dot = ctx.kernel
    need_a, need_b = ctx.needs_input_grad[:2]
    da = db = None
    if need_a or need_b:
        da, db = pair_block_stats_grad(a, b, u, v, c_sq, kernel, params, excl, add_dot,
                                       need_a=need_a, need_b=need_b, scale=2.0)
    return (None if da is None else da.to(a.dtype),
            None if db is None else db.to(b.dtype), None, None, None, None)


def make_row_stats(kernel: str, params: Sequence[float], exclude_diag: bool,
                   add_dot: float = 0.0):
    """Differentiable fused block statistics
    ``row_stats(a, b) -> (row_sums (m,), sum_sq ())`` of the masked
    mixture Gram block (no column sums)."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)

    def row_stats(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
        return _RowStats.apply(a, b, kernel, params, exclude_diag, add_dot)

    return row_stats


def make_pair_stats(kernel: str, params: Sequence[float], exclude_diag: bool,
                    add_dot: float = 0.0):
    """Differentiable ``stats(a, b) -> (row_sums, col_sums, sum_sq)`` of a
    masked Gram block, all three from one sweep of the stats kernel."""
    kernel, params, add_dot = canon_kernel(kernel, params, add_dot)

    def stats(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _PairStats.apply(a, b, kernel, params, exclude_diag, add_dot)

    return stats


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
