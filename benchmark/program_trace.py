"""The program's own spans and counters (``smmdax_torch.tracing``) in a
traced run, for the per-layer metrics that read them.

The cell's windows run with program tracing off and stay as they were.
After the cell's run, the first of these metrics to be read sets the
cell's program up again from the same seed, in the process the cell's run
has warmed, and runs two more windows:

* window A: program tracing on, no profiler: ``trace_dispatches``
  dispatches, or one scoring event.  Its spans, on the host's clock, give
  the host-time metrics.  Its rate is written beside the untraced
  window's, but the two differ by more than tracing: the cell's profiler
  windows leave the process's launching slower for the rest of the run.
* window B: program tracing on under the CPU and CUDA profiler:
  ``label_dispatches`` dispatches, or one event.  Each kernel is credited
  to the innermost program span around the host operation that launched
  it (the profiler's kernel-to-launch correlation), each idle gap of the
  card to the innermost program span open on the launching thread at the
  gap's middle, or to ``outside program spans``.

A cell over ranks (``train4``) runs both windows itself, on every rank
and on the cell's own state, with only rank 0 under the profiler
(``dispatch_windows``), and carries rank 0's as ``run["program"]``.

The per-span table (count, host ms, launches, device ms, idle ms) is
written to ``benchmark/_cache/`` and its path printed on standard error.
A program without ``smmdax_torch.tracing`` gives nothing to read.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from benchmark import common

OUTSIDE = "outside program spans"
TOP = 10
_DONE: Dict[int, tuple] = {}       # id(run) -> (run, windows)


class Ev(NamedTuple):
    """One profiler event: ``device`` False for host events (operations,
    runtime calls, program spans), True for device operations."""

    name: str
    device: bool
    thread: int
    start: int          # ns
    end: int
    corr: int           # the event's correlation id
    linked: int         # a device operation's launching host event, else 0


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def events_of(prof) -> List[Ev]:
    """The profiler's raw events, in nanoseconds on its clock."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == torch.autograd.DeviceType.CUDA
        out.append(Ev(e.name(), device, e.start_thread_id(), e.start_ns(), e.end_ns(),
                      e.correlation_id(), e.linked_correlation_id()))
    return out


class _Innermost:
    """The innermost program span open at a time on each thread: the
    spans' edges swept into change points per thread."""

    def __init__(self, spans: List[Ev]):
        self.spans = spans
        self.parent: List[int] = [-1] * len(spans)
        self.points: Dict[int, List[int]] = defaultdict(list)
        self.labels: Dict[int, List[int]] = defaultdict(list)
        edges = defaultdict(list)
        for i, s in enumerate(spans):
            # at one instant ends come before starts, an inner span's end
            # before its parent's, an outer span's start before its child's
            edges[s.thread] += [(s.start, 1, -s.end, i), (s.end, 0, -s.start, i)]
        for thread, ev in edges.items():
            stack: List[int] = []
            for t, opens, _, i in sorted(ev):
                if opens:
                    self.parent[i] = stack[-1] if stack else -1
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                self.points[thread].append(t)
                self.labels[thread].append(stack[-1] if stack else -1)

    def at(self, thread: int, t: int) -> int:
        """Index of the innermost span open on ``thread`` at ``t``, or -1."""
        pts = self.points.get(thread)
        if not pts:
            return -1
        j = bisect.bisect_right(pts, t) - 1
        return self.labels[thread][j] if j >= 0 else -1

    def chain(self, i: int) -> List[str]:
        """The names of span ``i`` and its enclosing spans, once each."""
        names: List[str] = []
        while i >= 0:
            if self.spans[i].name not in names:
                names.append(self.spans[i].name)
            i = self.parent[i]
        return names


def _busy_ms(intervals) -> float:
    """Milliseconds covered by the union of (start, end) ns intervals:
    kernels of one stream may overlap (programmatic dependent launch)."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def attribute(events: List[Ev], span_names) -> Dict:
    """Credit the device's work and idle gaps to program spans.

    Returns ``spans`` {name: {count, launches, device_ms, launches_in,
    device_ms_in, idle_ms}} (kernel launches, and the device time covered
    by the operations, whose innermost span it is, then of those under it
    at any depth; idle ms of the gaps credited to it) and ``idle_spans``,
    the top gaps' owners as ``[[name, seconds], ...]``."""
    spans = [e for e in events if not e.device and e.name in span_names]
    # operations and spans; runtime calls link to an operation themselves
    host = {e.corr: e for e in events if not e.device and not e.linked}
    # the device's operations, without the profiler's device-side copies
    # of the program spans
    dev = sorted((e for e in events if e.device and e.name not in span_names),
                 key=lambda e: e.start)
    inner = _Innermost(spans)
    threads = defaultdict(int)
    table: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(
        ("count", "launches", "device_ms", "launches_in", "device_ms_in", "idle_ms"), 0))
    for s in spans:
        table[s.name]["count"] += 1
    own, under = defaultdict(list), defaultdict(list)

    def owner(e: Ev):
        op = host.get(e.linked)
        return (op.thread, inner.at(op.thread, op.start)) if op is not None else (None, -1)

    owners = []
    for e in dev:
        thread, i = owner(e)
        owners.append(thread)
        if thread is not None:
            threads[thread] += 1
        kernel = not _is_copy(e.name)
        name = spans[i].name if i >= 0 else OUTSIDE
        table[name]["launches"] += kernel
        own[name].append((e.start, e.end))
        for up in (inner.chain(i) if i >= 0 else [OUTSIDE]):
            table[up]["launches_in"] += kernel
            under[up].append((e.start, e.end))
    for name in table:
        table[name]["device_ms"] = _busy_ms(own[name])
        table[name]["device_ms_in"] = _busy_ms(under[name])
    main = max(threads, key=threads.get) if threads else None
    idle: Dict[str, float] = defaultdict(float)
    busy_end = None
    for e, thread in zip(dev, owners):
        if busy_end is not None and e.start > busy_end:
            mid = (busy_end + e.start) // 2
            t = thread if thread is not None else main
            i = inner.at(t, mid) if t is not None else -1
            name = spans[i].name if i >= 0 else OUTSIDE
            idle[name] += (e.start - busy_end) * 1e-9
            table[name]["idle_ms"] += (e.start - busy_end) * 1e-6
        busy_end = e.end if busy_end is None else max(busy_end, e.end)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"spans": {k: dict(v) for k, v in table.items()},
            "idle_spans": [[n, s] for n, s in top]}


def host_ms(records, main_thread: int) -> Dict[str, Dict[str, float]]:
    """Window A's drained spans by name: count and host ms, all threads and
    off the main (launching) thread."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "host_ms": 0.0, "off_main_count": 0, "off_main_ms": 0.0})
    for r in records:
        ms = (r.end_ns - r.start_ns) * 1e-6
        row = out[r.name]
        row["count"] += 1
        row["host_ms"] += ms
        if r.thread != main_thread:
            row["off_main_count"] += 1
            row["off_main_ms"] += ms
    return {k: dict(v) for k, v in out.items()}


def _profile(fn, dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    common.sync(dev)
    with profile(activities=acts) as prof:
        fn()
        common.sync(dev)
    return prof


def _traced(fn, dev, profiled: bool):
    """``fn`` with program tracing on, under the profiler when
    ``profiled``: (wall s, drained spans, counters, the profiler's events
    or None, this thread's ident)."""
    import threading
    from smmdax_torch import tracing
    tracing.drain()
    common.sync(dev)
    tracing.enable()
    try:
        t0 = time.perf_counter()
        prof = _profile(fn, dev) if profiled else fn()
        common.sync(dev)
        wall = time.perf_counter() - t0
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    evs = events_of(prof) if profiled else None
    return wall, spans, counters, evs, threading.get_ident()


def dispatch_windows(dispatches, n_a: int, n_b: int, k: int, dev, profile: bool = True
                     ) -> dict:
    """Windows A and B of a training program: ``dispatches(n)`` runs n
    dispatches of K = ``k`` macro-steps.  ``profile=False`` runs window B
    with the spans on but without the profiler (a rank that keeps pace
    with the profiled one) and reads no device table."""
    wall_a, spans_a, counters_a, _, main = _traced(dispatches(n_a), dev, False)
    _, _, counters_b, evs, _ = _traced(dispatches(n_b), dev, profile)
    return {"unit": "macro_step", "units_a": n_a * k, "units_b": n_b * k, "wall_a": wall_a,
            "host": host_ms(spans_a, main), "counters_a": counters_a,
            "counters_b": counters_b,
            "device": attribute(evs, _span_names()) if profile else None}


def _train_windows(run: dict, seed: int, dev) -> dict:
    """The training cell's program as ``train_cell.start`` builds it, but
    for the checked steps (the process is warm from the cell's run): one
    dispatch with tracing off, then windows A and B."""
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.train import create_state, dispatch_train_step
    from benchmark.feed import Feed, images
    c, t = run["config"], run["traffic"]
    k, per_step = c["steps_per_dispatch"], c["dsteps"] + c["gsteps"]
    cfg = common.port_config(c, seed)
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    box = {"state": create_state(cfg, seed=seed, device=dev)}
    step = dispatch_train_step(cfg, c["dsteps"], c["gsteps"], steps_per_dispatch=k)
    feed = Feed(ArraySource(data, seed=seed), per_step, c["real_batch_size"], k)

    def dispatches(n):
        def go():
            for _ in range(n):
                box["state"], _ = step(box["state"], feed.dispatch_batch(record=False))
        return go

    try:
        dispatches(1)()
        return dispatch_windows(dispatches, t["trace_dispatches"], t["label_dispatches"], k,
                                dev)
    finally:
        feed.close()


def _score_windows(run: dict, seed: int, dev) -> dict:
    """The scoring cell's event as ``score_cell.start`` builds it, on a
    fresh state (an event's work does not depend on the weights) and
    without its set-up event: the FID of the real set against itself
    caches the real set's root, as the cell's set-up event does; then
    windows A and B."""
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.eval import InceptionFeatures, extract_features, frechet_distance
    from smmdax_torch.train import create_state
    from benchmark import score_cell
    from benchmark.feed import images
    c, n = run["config"], run["config"]["no_of_samples"]
    cfg = common.port_config(c, seed)
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    path = score_cell.weights_path()
    try:
        score_cell.write_inception_weights(path, seed, dev)
        extractor = InceptionFeatures(path, device=dev)
        real = ArraySource(data, seed=seed).batch(n, key=score_cell.REAL_KEY)
        real_feats = extract_features(extractor, real, fetch=dev.type != "cuda")
        event = score_cell.Event(cfg, c, create_state(cfg, seed=seed, device=dev), extractor,
                                 real_feats, dev)
        frechet_distance(*event.real_stats, *event.real_stats)
        wall_a, spans_a, counters_a, _, main = _traced(lambda: event(seed + 2, real_feats),
                                                       dev, False)
        _, _, counters_b, evs, _ = _traced(lambda: event(seed + 3, real_feats), dev, True)
    finally:
        os.remove(path)
    return {"unit": "event", "units_a": 1, "units_b": 1, "wall_a": wall_a,
            "host": host_ms(spans_a, main), "counters_a": counters_a,
            "counters_b": counters_b, "device": attribute(evs, _span_names())}


def _span_names():
    from smmdax_torch import tracing
    return set(tracing.SPANS)


def measure(run: dict, seed: int, dev) -> dict:
    """Windows A and B of ``run``'s cell, set up anew from ``seed`` on
    ``dev``; the program is freed after."""
    import torch
    gc.collect()
    t0 = time.perf_counter()
    out = (_train_windows if run["kind"] == "train" else _score_windows)(run, seed, dev)
    out["seconds"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rate = run["rate"]
    out["untraced_per_s"] = rate["macro_steps" if run["kind"] == "train" else "events"] / rate[
        "window_s"]
    out["traced_per_s"] = out["units_a"] / out["wall_a"]
    return out


def _seed_and_cell():
    """The run's ``--seed`` and ``--workload``, from the benchmark's own
    command line."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workload", default="cell")
    args, _ = p.parse_known_args(sys.argv[1:])
    return args.seed, args.workload


def record(out: dict) -> None:
    """Write a run's windows to ``benchmark/_cache/`` and say where."""
    seed, cell = _seed_and_cell()
    path = os.path.join(common.HERE, "_cache", f"program_spans_{cell}_{seed}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"program spans: {path}; idle_spans {json.dumps(out['device']['idle_spans'])}; "
          f"tracing on: {out['traced_per_s']!r} against {out['untraced_per_s']!r} "
          f"{out['unit']}s/s; {out['seconds']!r} s", file=sys.stderr)


def windows(run: dict) -> Optional[dict]:
    """Windows A and B of this traced run, measured once for all the
    metrics that read them; None without a card, in a run with nothing to
    set up, or for a program without ``smmdax_torch.tracing``.  A cell
    that measured them on its own state (``train4``) carries them as
    ``run["program"]``."""
    if "program" in run:
        return run["program"]
    if run.get("kind") not in ("train", "score") or not run.get("trace"):
        return None
    if id(run) in _DONE:
        return _DONE[id(run)][1]
    import torch
    if not torch.cuda.is_available() or importlib.util.find_spec("smmdax_torch.tracing") is None:
        _DONE[id(run)] = (run, None)
        return None
    seed, _ = _seed_and_cell()
    out = measure(run, seed, torch.device("cuda"))
    record(out)
    _DONE[id(run)] = (run, out)
    return out


def per_unit(w: dict, names, key: str, window: str = "b") -> float:
    """The sum of ``key`` over the spans ``names`` in window B's device
    table (or ``host`` for window A), per macro-step or event."""
    table = w["device"]["spans"] if window == "b" else w["host"]
    return sum(table.get(n, {}).get(key, 0) for n in names) / w[f"units_{window}"]
