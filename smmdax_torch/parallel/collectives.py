"""The port's counterpart of a named mesh axis: ``DataAxis``.

Inside JAX's ``shard_map`` a function names the data axis and calls
``psum``, ``pmean``, ``all_gather`` and ``ppermute`` over it.  Here each
rank is one process of the default ``torch.distributed`` process group
and a ``DataAxis`` wraps that group.  Every collective is a
``torch.autograd.Function`` whose backward is JAX's transpose rule, itself
a collective (so the backward can be differentiated again):

* ``psum``  -> ``psum`` of the cotangents;
* tiled ``all_gather`` -> the sum-reduce-scatter (and back);
* ``ppermute_next`` (ring shift i -> i+1) -> the reverse shift.

The convention this gives is JAX's under ``shard_map``: a loss made
global by a ``psum`` is differentiated by each rank on its own, and the
``pmean`` of the ranks' gradients is the gradient of the global loss.

``init_data_axis`` sets up the default process group from an explicit
store (a ``FileStore`` path, or a ``HashStore`` for one rank), with NCCL
for a CUDA device and gloo for the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class DataAxis:
    """A 1-D data axis over the ranks of the default process group.
    ``device`` is where this rank's tensors live."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = dist.get_world_size()
        self.index = dist.get_rank()
        self._nccl = dist.get_backend() == "nccl"

    def psum(self, x: Tensor) -> Tensor:
        return _PSum.apply(x, self)

    def pmean(self, x: Tensor) -> Tensor:
        return self.psum(x) / self.size

    def all_gather(self, x: Tensor) -> Tensor:
        """(b, ...) on each rank -> (size * b, ...), rank order."""
        return _AllGather.apply(x, self)

    def ppermute_next(self, x: Tensor) -> Tensor:
        """Ring shift: rank i's ``x`` arrives on rank i + 1 (mod size);
        the identity on one rank (nothing is sent to self)."""
        if self.size == 1:
            return x
        return _Shift.apply(x, self, 1)

    def close(self) -> None:
        """Destroy the default process group."""
        dist.destroy_process_group()


def init_data_axis(device, rank: int = 0, world_size: int = 1,
                   store_path: Optional[str] = None) -> DataAxis:
    """Join the default process group as ``rank`` of ``world_size`` and
    return its ``DataAxis`` on ``device``.

    ``store_path``: a file every rank of the group names (``FileStore``);
    None only for one rank (``HashStore``).  NCCL for a CUDA device, gloo
    for the CPU."""
    device = torch.device(device)
    if store_path is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need a FileStore path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("name the CUDA device of this rank, e.g. cuda:0")
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=store, rank=rank,
                                world_size=world_size, device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)
    else:
        raise ValueError(f"no collectives for {device} tensors")
    return DataAxis(device)


# ---------------------------------------------------------------------------
# the collectives and their transposes


def _all_reduce(x: Tensor, axis: DataAxis) -> Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out)
    return out


def _all_gather(x: Tensor, axis: DataAxis) -> Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0)


def _reduce_scatter(x: Tensor, axis: DataAxis) -> Tensor:
    """Sum over ranks, then this rank's block of dim 0."""
    b = x.shape[0] // axis.size
    if axis._nccl:
        out = torch.empty((b,) + x.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous())
        return out
    # gloo has no reduce-scatter: all-reduce, then take this rank's block
    return _all_reduce(x, axis)[axis.index * b:(axis.index + 1) * b]


def _shift(x: Tensor, axis: DataAxis, step: int) -> Tensor:
    """Rank i's x to rank i + step (mod size), over more than one rank."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (axis.index + step) % axis.size),
           dist.P2POp(dist.irecv, out, (axis.index - step) % axis.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, ct):
        return _PSum.apply(ct, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, ct):
        return _ReduceScatter.apply(ct, ctx.axis), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        if x.shape[0] % axis.size:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"over {axis.size} ranks")
        ctx.axis = axis
        return _reduce_scatter(x, axis)

    @staticmethod
    def backward(ctx, ct):
        return _AllGather.apply(ct, ctx.axis), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, step):
        ctx.axis, ctx.step = axis, step
        return _shift(x, axis, step)

    @staticmethod
    def backward(ctx, ct):
        return _Shift.apply(ct, ctx.axis, -ctx.step), None, None
