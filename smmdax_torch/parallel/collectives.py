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
for a CUDA device and gloo for the CPU.  ``rank_device`` names a rank's
device as the launcher places it: ``cuda:<rank>``, one process per card.

Host-side coordination of the trainer (a barrier, "did any rank see a
signal", rank 0's decision broadcast, each rank's small object gathered)
runs over a gloo group of its own on CPU tensors, so it never waits on the
card's stream.  The transport of each collective is a method of
``DataAxis`` (``_all_reduce``, ``_all_gather``, ``_reduce_scatter``,
``_shift``), so a subclass may carry the tensors another way.  Each
collective is a span of ``smmdax_torch.tracing`` (``dp.all_reduce``,
``dp.all_gather``, ``dp.reduce_scatter``, ``dp.shift``) and adds its
input's bytes to the counter ``dp.bytes``, while tracing is on.
"""

from __future__ import annotations

import datetime
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from smmdax_torch import tracing

Tensor = torch.Tensor


class DataAxis:
    """A 1-D data axis over the ranks of the default process group.
    ``device`` is where this rank's tensors live."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = dist.get_world_size()
        self.index = dist.get_rank()
        self.backend = dist.get_backend()
        self._host_group = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.index == 0

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

    # -- host-side coordination (no autograd, CPU tensors over gloo) ------

    def _host(self):
        """The gloo group of host collectives, made at the first use (every
        rank reaches its first host collective at the same point)."""
        if self._host_group is None:
            self._host_group = (dist.group.WORLD if self.backend == "gloo"
                                else dist.new_group(backend="gloo"))
        return self._host_group

    def barrier(self) -> None:
        dist.barrier(group=self._host())

    def any(self, *flags: bool) -> List[bool]:
        """For each flag: whether it is set on any rank."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host())
        return [bool(v) for v in t.tolist()]

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj if self.index == src else None]
        dist.broadcast_object_list(box, src=src, group=self._host())
        return box[0]

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self._host())
        return out

    def all_gather_rows(self, x: Tensor) -> Tensor:
        """Every rank's (b_r, ...) rows concatenated in rank order on every
        rank, for blocks of unequal length (no gradient)."""
        sizes = self.gather_objects(int(x.shape[0]))
        top = max(sizes)
        pad = torch.zeros((top - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        with torch.no_grad():
            full = _collective("dp.all_gather", self._all_gather,
                               torch.cat([x, pad]).to(self.device)).to(x.device)
        return torch.cat([full[r * top:r * top + b] for r, b in enumerate(sizes)])

    def close(self) -> None:
        """Destroy the default process group."""
        dist.destroy_process_group()

    # -- the transport of the collectives (no autograd) -------------------

    def _all_reduce(self, x: Tensor) -> Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    def _all_gather(self, x: Tensor) -> Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim=0)

    def _reduce_scatter(self, x: Tensor) -> Tensor:
        """Sum over ranks, then this rank's block of dim 0."""
        b = x.shape[0] // self.size
        if self.backend == "nccl":
            out = torch.empty((b,) + x.shape[1:], dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, x.contiguous())
            return out
        # gloo has no reduce-scatter: all-reduce, then take this rank's block
        return self._all_reduce(x)[self.index * b:(self.index + 1) * b]

    def _shift(self, x: Tensor, step: int) -> Tensor:
        """Rank i's x to rank i + step (mod size), over more than one rank."""
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.index + step) % self.size),
               dist.P2POp(dist.irecv, out, (self.index - step) % self.size)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:<rank>`` (one process per card) for
    a CUDA device type, the CPU for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank)
    if device.type == "cpu":
        return device
    raise ValueError(f"no ranks on {device}")


def init_data_axis(device, rank: int = 0, world_size: int = 1,
                   store_path: Optional[str] = None,
                   timeout: Optional[float] = None) -> DataAxis:
    """Join the default process group as ``rank`` of ``world_size`` and
    return its ``DataAxis`` on ``device``.

    ``store_path``: a file every rank of the group names (``FileStore``);
    None only for one rank (``HashStore``).  NCCL for a CUDA device, gloo
    for the CPU.  ``timeout``: seconds a collective may wait for the other
    ranks before it raises (PyTorch's default when None)."""
    device = torch.device(device)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
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
                                world_size=world_size, device_id=device, **kw)
    elif device.type == "cpu":
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        raise ValueError(f"no collectives for {device} tensors")
    return DataAxis(device)


# ---------------------------------------------------------------------------
# the collectives and their transposes


def _collective(name: str, transport, x: Tensor, *args) -> Tensor:
    """``transport(x, *args)`` as the span ``name``, its payload counted."""
    if tracing.counting():
        tracing.count("dp.bytes", x.numel() * x.element_size())
    with tracing.span(name):
        return transport(x, *args)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _collective("dp.all_reduce", axis._all_reduce, x)

    @staticmethod
    def backward(ctx, ct):
        return _PSum.apply(ct, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _collective("dp.all_gather", axis._all_gather, x)

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
        return _collective("dp.reduce_scatter", axis._reduce_scatter, x)

    @staticmethod
    def backward(ctx, ct):
        return _AllGather.apply(ct, ctx.axis), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, step):
        ctx.axis, ctx.step = axis, step
        return _collective("dp.shift", axis._shift, x, step)

    @staticmethod
    def backward(ctx, ct):
        return _Shift.apply(ct, ctx.axis, -ctx.step), None, None
