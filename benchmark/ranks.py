"""A cell whose cards belong to rank processes: ``run`` starts one rank
per card through the port's own launcher (``smmdax_torch.parallel.launch.
RankGroup``: NCCL on ``cuda:r``, gloo on the CPU for a rehearsal), runs
``fn(axis, *args)`` on every rank and returns what rank 0's ``fn``
returned.

The port's CUDA kernels are built in this process first, so that the
ranks of a fresh checkout load them and never run ``nvcc`` side by side.
A rank that fails ends the others and the command: its traceback goes to
standard error and no result is printed.  A collective that waits longer
than ``timeout`` fails its rank; a group that outlives the caller's
``deadline`` is ended the same way, and a rank whose parent dies is
killed with it (``PR_SET_PDEATHSIG``), so no rank outlives the command.
``LOADED``: when this module was imported, in a rank after ``torch``
and before the rank joins its group (``time.perf_counter``, the host's
monotonic clock, which every process shares).
"""

from __future__ import annotations

import ctypes
import glob
import os
import pickle
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

LOADED = time.perf_counter()

from benchmark import common  # noqa: E402

_PR_SET_PDEATHSIG = 1


def _rank(axis, fn: Callable, tmp: str, parent: int, args: tuple) -> None:
    """One rank: die with the parent, share the host's cores, run ``fn``;
    rank 0 writes its result.  A rank that raises leaves its traceback
    beside it, so that the first failure, and not the collectives it
    broke on the other ranks, is the one reported."""
    try:
        _run_rank(axis, fn, tmp, parent, args)
    except BaseException:
        with open(os.path.join(tmp, f"rank{axis.index}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run_rank(axis, fn: Callable, tmp: str, parent: int, args: tuple) -> None:
    import torch
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        raise SystemExit("the command that started this rank has ended")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // axis.size))
    out = fn(axis, *args)
    if axis.index == 0:
        with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def run(fn: Callable, world: int, device: str, args: Sequence[Any] = (),
        timeout: float = 120.0, deadline: Optional[float] = None,
        mark: Callable[[str], None] = lambda name: None) -> Any:
    """Rank 0's ``fn(axis, *args)`` over ``world`` ranks on ``device``
    (``cuda`` or ``cpu``).  ``timeout``: seconds a collective waits for the
    other ranks; ``deadline``: seconds from the ranks' start to the last
    one's end (None: none); ``mark(name)`` once the kernels are built
    (``built``) and once the ranks are started (``spawned``)."""
    from smmdax_torch.parallel.launch import RankFailed, RankGroup
    if device == "cuda":
        from smmdax_torch.cuda import build
        build.build()
    mark("built")
    with tempfile.TemporaryDirectory(prefix="benchmark_ranks_") as tmp:
        rank_args = [(fn, tmp, os.getpid(), tuple(args))] * world
        end = None if deadline is None else time.perf_counter() + deadline

        def poll() -> None:
            time.sleep(0.2)
            if end is not None and time.perf_counter() > end:
                raise common.Refused(f"the {world} ranks did not end within {deadline:.0f} s")

        with RankGroup(_rank, world, device, rank_args, timeout=timeout) as group:
            group.start()
            mark("spawned")
            try:
                group.wait(poll=poll)
            except RankFailed as e:
                raise common.Refused(_failure(tmp, e)) from None
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _failure(tmp: str, e) -> str:
    """The first rank to fail, with its traceback, and the others that
    stopped after it; a rank that ended without one (a signal) first."""
    errs = sorted((os.stat(p).st_mtime_ns, p) for p in glob.glob(os.path.join(tmp, "rank*.err")))
    if not errs or not os.path.exists(os.path.join(tmp, f"rank{e.rank}.err")):
        return f"rank {e.rank} of {e.world} failed; the others were stopped:\n{e.text}"
    first = errs[0][1]
    rank = int(os.path.basename(first)[4:-4])
    later = [os.path.basename(p)[4:-4] for _, p in errs[1:]]
    with open(first) as f:
        text = f.read()
    after = f" (then rank {', '.join(later)})" if later else ""
    return f"rank {rank} of {e.world} failed first{after}; the others were stopped:\n{text}"
