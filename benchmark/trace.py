"""Reading ``torch.profiler`` over a short steady window.

Two windows, so that the profiler's host-side cost stays out of what the
first reads:

* ``device_window``: CUDA activity alone.  Busy seconds are the union of
  the intervals in which an operation (kernel, copy or fill) ran on the
  card; the window is the host clock from a synchronize before to one
  after.  It also counts kernel launches, sums device time by name and
  sums NCCL kernels' time.
* ``host_window``: CPU and CUDA activity.  Each idle gap of the card is
  labelled by the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

TOP = 10
LOOK_BACK = 256


def _is_cuda(e) -> bool:
    import torch
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _profile(fn: Callable[[], None], cpu: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def device_window(fn: Callable[[], None]) -> Dict:
    """Profile ``fn`` with CUDA activity only; seconds throughout."""
    prof, wall = _profile(fn, cpu=False)
    dev = [e for e in prof.events() if _is_cuda(e)]
    spans = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in dev]
    busy = sum(e - s for s, e in _union(spans))
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    kernels = [e for e in dev if not _is_copy(e.name)]
    nccl = sum((e.time_range.end - e.time_range.start) * 1e-6 for e in kernels
               if "nccl" in e.name.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": wall, "launches": len(kernels),
            "nccl_s": nccl, "device_ops": [[n, s] for n, s in top]}


def host_window(fn: Callable[[], None]) -> List[List]:
    """Profile ``fn`` with CPU and CUDA activity; the card's idle gaps
    summed by the host operation running at each gap's middle."""
    prof, _ = _profile(fn, cpu=True)
    events = list(prof.events())
    dev = _union([(e.time_range.start, e.time_range.end) for e in events if _is_cuda(e)])
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _is_cuda(e)), key=lambda t: t[0])
    gaps = [(a[1], b[0]) for a, b in zip(dev, dev[1:]) if b[0] > a[1]]
    by_label: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "python between operations"
        # on one thread host ops nest: the latest-started op that still
        # runs at the middle is the innermost; a gap that no recent op
        # covers is the interpreter's own time between operations
        i = bisect.bisect_right(starts, mid) - 1
        for _ in range(LOOK_BACK):
            if i < 0:
                break
            s, e, name = host[i]
            if e >= mid:
                label = name
                break
            i -= 1
        by_label[label] += (g1 - g0) * 1e-6
    return [[n, s] for n, s in sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]]
