"""A group of spawned rank processes: the start, the watch and the
clean-up that the training command line (``main.launch``) and the dry run
(``graft_entry.dryrun_multichip``) share.

Rank r of ``world`` joins the default process group on
``rank_device(device, r)`` (NCCL on ``cuda:r``, gloo on the CPU) over a
FileStore in a temporary directory, runs ``target(axis, *rank_args[r])``
and leaves the group.  A rank that raises writes its traceback to a file
and exits 1.  ``wait`` returns the ranks' exit codes; when a rank exits
with a code outside ``ok_codes`` it kills the others and raises
``RankFailed`` with that rank's traceback.  What differs between the
callers (forwarding signals to the ranks, reading a pipe, a deadline)
is theirs: ``signal`` sends one to the live ranks, and ``wait``'s
``poll`` is called between checks and may raise to stop the group.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

POLL_S = 0.2


class RankFailed(RuntimeError):
    """Rank ``rank`` of ``world`` exited with a code outside the ok codes;
    ``codes`` are every rank's after the others were stopped, ``text``
    the failed rank's traceback (or its exit code)."""

    def __init__(self, rank: int, world: int, codes: List[int], text: str):
        super().__init__(f"rank {rank} of {world} failed; the others were stopped:\n{text}")
        self.rank, self.world, self.codes, self.text = rank, world, codes, text


def _rank_entry(target: Callable, rank: int, world: int, device: str, store: str,
                timeout: Optional[float], err_path: str, args: tuple) -> None:
    """One rank: join the group on its device, run ``target``, leave."""
    from smmdax_torch.parallel.collectives import init_data_axis, rank_device
    try:
        dev = rank_device(device, rank)
        if dev.type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        axis = init_data_axis(dev, rank, world, store, timeout=timeout)
        try:
            target(axis, *args)
        finally:
            axis.close()
    except Exception:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class RankGroup:
    """``world`` spawned ranks running ``target`` (a top-level function, as
    spawn imports it), rank r with ``rank_args[r]``.  ``timeout``: seconds
    a collective waits for the other ranks (PyTorch's default when None).
    Use as a context manager: leaving it kills the ranks still running and
    removes the store's directory."""

    def __init__(self, target: Callable, world: int, device, rank_args: Sequence[tuple],
                 timeout: Optional[float] = None):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self._tmp = tempfile.mkdtemp(prefix="smmdax_torch_ranks_")
        store = os.path.join(self._tmp, "store")
        self._errs = [os.path.join(self._tmp, f"rank{r}.err") for r in range(world)]
        self.procs = [ctx.Process(target=_rank_entry,
                                  args=(target, r, world, str(device), store, timeout,
                                        self._errs[r], tuple(rank_args[r])))
                      for r in range(world)]

    def __enter__(self) -> "RankGroup":
        return self

    def __exit__(self, *exc) -> None:
        self._stop()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def start(self) -> None:
        for p in self.procs:
            p.start()

    def signal(self, signum: int) -> None:
        """Send ``signum`` to every rank still running."""
        for p in self.procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    def wait(self, poll: Optional[Callable[[], None]] = None,
             ok_codes: Sequence[int] = (0,)) -> List[int]:
        """Every rank's exit code once all have exited, checking every
        POLL_S (or after each ``poll()``); raises ``RankFailed`` when one
        exits with a code outside ``ok_codes``."""
        ok = (None,) + tuple(ok_codes)
        while any(p.exitcode is None for p in self.procs):
            if poll is None:
                time.sleep(POLL_S)
            else:
                poll()
            failed = next((r for r, p in enumerate(self.procs) if p.exitcode not in ok), None)
            if failed is not None:
                code = self.procs[failed].exitcode
                self._stop()
                text = f"exit code {code}\n"
                if os.path.exists(self._errs[failed]):
                    with open(self._errs[failed]) as f:
                        text = f.read()
                raise RankFailed(failed, self.world, [p.exitcode for p in self.procs], text)
        for p in self.procs:
            p.join()
        return [p.exitcode for p in self.procs]

    def _stop(self) -> None:
        for p in self.procs:
            if p.pid is not None and p.exitcode is None:
                p.kill()
        for p in self.procs:
            if p.pid is not None:
                p.join()
