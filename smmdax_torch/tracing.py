"""Program spans and counters of ``smmdax_torch``.

A span names one phase of the program (``SPANS``) and a counter counts
host calls of one kind (``COUNTERS``).  Both are off unless a caller turns
them on with ``enable()``: the benchmark's traced windows and the
trainer's profiler window (``Config.profile_steps``) do.  Off, ``span()``
returns one shared no-op context after a single flag test and ``count()``
returns at once.  ``enable(spans=False)`` turns the counters on alone: the
spans stay the no-op, so a timed or profiled run that counts launches
carries no span and no ``record_function``.

On, each span records its name, its thread (``threading.get_ident()``),
its start and end, the id of its parent span on that thread and the id of
its root, the outermost span open on that thread when it began (a
dispatch, a scoring event or a producer batch): the spans of one root
share its id.  Each span also opens ``torch.profiler.record_function``
under its name, so it sits in any active profiler's trace beside the
kernels it launched.  The timestamps are ``time.time_ns()``, the Unix
clock onto which ``torch.profiler`` converts its CPU and CUDA events, so
a drained span and its ``record_function`` event line up.

Records stay in memory, in a store of ``CAPACITY`` spans that drops the
oldest when full and counts what it dropped (the counter
``tracing.dropped_spans``); ``drain()`` hands the caller every record and
counter and empties the store, and ``counters()`` reads the counters
without emptying them.  Spans and counters touch no tensor and
never synchronize the device.

Counters count host calls.  A CUDA-graph capture runs the host calls
once and launches nothing, so it holds its counts aside (``recording()``)
and each of its replays adds them (``smmdax_torch.train``'s graphed
macro-step does).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

SPANS: Dict[str, str] = {
    "train.dispatch": "one call of the step dispatch_train_step returns (K macro-steps)",
    "train.h2d": "the batch's copy to the device (once per dispatch) and normalize_uint8",
    "train.noise": "draw_noise: every random draw of one macro-step",
    "train.d_update": "one critic update (the five train.d_* spans below)",
    "train.d_generate": "the critic update's fakes: the generator forward, no gradient",
    "train.sn_refresh": "_refresh_spectral: the dummy critic forward that moves every SN u",
    "train.d_loss": "critic_loss: the critic forwards, MMD^2, sigma's create-graph pass",
    "train.d_grad": "the critic's autograd.grad (sigma's double backward, the backward "
                    "through W / sigma) and the ranks' mean of the gradients",
    "train.d_adam": "Adam on the critic's parameters",
    "train.g_update": "one generator update (the four train.g_* / train.ema spans below)",
    "train.g_loss": "the generator forward and generator_loss",
    "train.g_grad": "the generator's autograd.grad (the backward through W / sigma) "
                    "and the ranks' mean of the gradients",
    "train.g_adam": "the ranks' mean of the BN averages and Adam on the generator",
    "train.ema": "the EMA of the generator's weights and BN averages",
    "train.graph_replay": "the batch's copy into a captured macro-step's buffer and one replay "
                          "of it (every train.d_* / train.g_* phase, on the card alone)",
    "train.sample": "sample: eval-mode images from the EMA generator",
    "nn.spectral": "an SN layer's forward side of spectral norm: the power iteration "
                   "and W / sigma (its backward falls under train.d_grad / train.g_grad)",
    "losses.sigma": "sobolev_scale: the SMMD normalizer sigma",
    "losses.mmd": "mmd2_objective: the MMD^2 (the fused CUDA pair sums when dispatched)",
    "data.macro_batch": "macro_batch_at: one macro-step's batch, on the calling thread",
    "eval.inception": "extract_features / extract_with_probs: the feature network's sweep",
    "eval.gaussian_stats": "gaussian_stats: a feature set's mean and covariance",
    "eval.frechet": "frechet_distance: FID from two sets' statistics",
    "eval.kid": "kid_from_features: KID over subsets",
    "eval.is": "inception_score",
    "eval.three_sample_test": "relative_mmd_test / relative_similarity_test",
    "dp.all_reduce": "one all-reduce over the data axis (NCCL or gloo)",
    "dp.all_gather": "one all-gather over the data axis",
    "dp.reduce_scatter": "one reduce-scatter over the data axis",
    "dp.shift": "one ring shift over the data axis",
    "trainer.wait_batch": "the trainer's wait on its producer's queue for a dispatch",
    "trainer.log": "a log row: the metrics' float() syncs and the writer",
    "trainer.checkpoint": "a checkpoint save inside the loop",
    "trainer.samples": "a sample grid",
    "trainer.score": "a scoring event (_score)",
}

# every counter counts host calls; a CUDA-graph replay adds its capture's counts
COUNTERS: Dict[str, str] = {
    "mmd.pair_sum.launches": "host launches of the pair-sum kernel",
    "mmd.pair_sum_grad_a.launches": "host launches of the pair-sum gradient kernel",
    "mmd.pair_stats.launches": "host launches of the pair-stats kernel",
    "mmd.pair_stats_grad_a.launches": "host launches of the pair-stats gradient kernel",
    "train.graph.captures": "macro-steps captured into a CUDA graph",
    "train.graph.replays": "macro-steps run as a replay of a captured CUDA graph",
    "dp.bytes": "payload bytes of the collectives called (each rank's input)",
    "tracing.dropped_spans": "span records the full store dropped",
}

CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    name: str
    thread: int          # threading.get_ident() of the thread it ran on
    start_ns: int        # time.time_ns(), the profiler's clock
    end_ns: int
    id: int
    parent: Optional[int]
    root: int


_on = False                   # spans
_counting = False             # counters
_lock = threading.Lock()
_records: "collections.deque[SpanRecord]" = collections.deque(maxlen=CAPACITY)
_counters: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The shared no-op span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()
_record_function = None       # torch.profiler.record_function, bound by enable()


def enable(spans: bool = True) -> None:
    """Turn the counters on, and the spans too unless ``spans`` is False."""
    global _on, _counting, _record_function
    if spans:
        from torch.profiler import record_function
        _record_function = record_function
    _on = spans
    _counting = True


def disable() -> None:
    global _on, _counting
    _on = _counting = False


def enabled() -> bool:
    """Whether spans are recorded."""
    return _on


def counting() -> bool:
    """Whether counters count."""
    return _counting


def _stack() -> List[Tuple[int, int]]:
    """This thread's open spans as (id, root), outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent, self.root = stack[-1] if stack else (None, self.id)
        stack.append((self.id, self.root))
        self.rf = _record_function(self.name)
        self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        rec = SpanRecord(self.name, threading.get_ident(), self.start, end, self.id,
                         self.parent, self.root)
        with _lock:
            if len(_records) == _records.maxlen:
                _counters["tracing.dropped_spans"] = _counters.get("tracing.dropped_spans", 0) + 1
            _records.append(rec)
        return False


def span(name: str):
    """A context manager that records the phase ``name`` (a key of
    ``SPANS``) while tracing is on, and does nothing otherwise."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (a key of ``COUNTERS``) while
    the counters are on; inside ``recording()`` on this thread, to its
    dict instead, whether or not they are on."""
    into = getattr(_local, "into", None)
    if into is not None:
        into[name] = into.get(name, 0) + n
        return
    if not _counting:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording(into: Dict[str, int]):
    """Counts made on this thread inside the block go to ``into`` and not
    to the counters: a CUDA-graph capture keeps them for its replays."""
    outer = getattr(_local, "into", None)
    _local.into = into
    try:
        yield into
    finally:
        _local.into = outer


def drain() -> Tuple[List[SpanRecord], Dict[str, int]]:
    """Every span record (in the order they ended) and counter since the
    last drain; the store is left empty."""
    with _lock:
        spans = list(_records)
        _records.clear()
        counters = dict(_counters)
        _counters.clear()
    return spans, counters


def counters() -> Dict[str, int]:
    """Every counter since the last drain, the store left as it is."""
    with _lock:
        return dict(_counters)
