"""The port's program spans and counters (``smmdax_torch.tracing``), on
the CPU: off they cost a flag test and record nothing; on they change no
value, nest as ``SPANS`` documents, carry their thread, share the
profiler's clock, and the store is bounded.  The ``dp.*`` spans and the
``dp.bytes`` counter are read on a 2-rank gloo group."""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch

import _torch_dist
from smmdax_torch import checkpoint, tracing
from smmdax_torch.configs import Config
from smmdax_torch.data import SyntheticImages, macro_batch_at
from smmdax_torch.train import create_state, dispatch_train_step
from smmdax_torch.trainer import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

# a tiny flagship: sn-smmd, hutchinson sigma, EMA, K macro-steps a dispatch
CFG = dict(dataset="synthetic", architecture="resnet", model="sn-smmd", kernel="rq",
           scaling_grad_estimator="hutchinson", gf_dim=8, df_dim=8, dof_dim=4, z_dim=8,
           batch_size=8, real_batch_size=8, ema_decay=0.5, dsteps=2, gsteps=1)
K = 2
# a drained span lies inside its record_function event: at most this far
# outside it (the profiler's approximate clock is converted to Unix ns)
CLOCK_SLACK_NS = 50_000
# and the median distance between their edges stays under this
CLOCK_MEDIAN_NS = 200_000


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _reals(seed=0):
    per_step = CFG["dsteps"] + CFG["gsteps"]
    return np.random.default_rng(seed).integers(
        0, 256, (K, per_step, CFG["real_batch_size"], 32, 32, 3), dtype=np.uint8)


def _dispatch(traced: bool):
    cfg = Config(**CFG)
    state = create_state(cfg, seed=3, device="cpu")
    step = dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, steps_per_dispatch=K)
    if traced:
        tracing.enable()
    try:
        state, metrics = step(state, _reals())
    finally:
        tracing.disable()
    return state, metrics, tracing.drain()


@pytest.fixture(scope="module")
def traced_and_plain():
    torch.set_num_threads(1)
    return _dispatch(True), _dispatch(False)


def test_off_is_one_shared_noop_and_records_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("train.dispatch"), tracing.span("nn.spectral")
    assert a is b
    with a:
        tracing.count("dp.bytes", 8)
    assert tracing.drain() == ([], {})


def test_tracing_changes_no_value(traced_and_plain):
    (s_on, m_on, _), (s_off, m_off, (spans_off, counters_off)) = traced_and_plain
    assert spans_off == [] and counters_off == {}
    _assert_same(checkpoint.state_dict(s_on), checkpoint.state_dict(s_off), "state")
    _assert_same(m_on, m_off, "metrics")


def _assert_same(a, b, where):
    """Bit-identical nested state dicts (tensors, arrays, plain values)."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def test_span_tree_of_a_dispatch(traced_and_plain):
    (_, _, (spans, _)), _ = traced_and_plain
    assert set(s.name for s in spans) <= set(tracing.SPANS)
    by_id = {s.id: s for s in spans}
    counts = collections.Counter(s.name for s in spans)
    dsteps, gsteps = CFG["dsteps"], CFG["gsteps"]
    assert counts["train.dispatch"] == 1
    assert counts["train.h2d"] == 1 + K         # the stack's copy, then each macro-step's
    assert counts["train.noise"] == K
    assert counts["train.d_update"] == K * dsteps
    assert counts["train.g_update"] == K * gsteps
    (dispatch,) = [s for s in spans if s.name == "train.dispatch"]
    assert dispatch.parent is None and dispatch.root == dispatch.id
    assert all(s.root == dispatch.id for s in spans)
    assert all(s.thread == threading.get_ident() for s in spans)
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s.name)
    for s in spans:
        if s.name == "train.d_update":
            assert s.parent == dispatch.id
            assert sorted(children[s.id]) == sorted(
                ["train.d_generate", "train.sn_refresh", "train.d_loss", "train.d_grad",
                 "train.d_adam"])
        if s.name == "train.g_update":
            assert sorted(children[s.id]) == sorted(
                ["train.g_loss", "train.g_grad", "train.g_adam", "train.ema"])
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # spectral norm runs in the critic's forwards only: the refresh, the
    # critic loss (features, sigma) and the generator loss's critic
    spectral = [s for s in spans if s.name == "nn.spectral"]
    assert spectral
    for s in spectral:
        up = _ancestors(s, by_id)
        assert up[0] in ("train.sn_refresh", "train.d_loss", "losses.sigma", "train.g_loss")
        assert "train.d_generate" not in up
    assert {by_id[s.parent].name for s in spans if s.name == "losses.sigma"} == {
        "train.d_loss", "train.g_loss"}
    assert {by_id[s.parent].name for s in spans if s.name == "losses.mmd"} == {
        "train.d_loss", "train.g_loss"}


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    cfg = Config(**CFG)
    state = create_state(cfg, seed=3, device="cpu")
    step = dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, steps_per_dispatch=K)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _reals())
    tracing.disable()
    spans, _ = tracing.drain()
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in tracing.SPANS:
            events[e.name()].append((e.start_ns(), e.end_ns()))
    drained = collections.defaultdict(list)
    for s in spans:
        drained[s.name].append((s.start_ns, s.end_ns))
    assert drained.keys() == events.keys()
    gaps = []
    for name in drained:
        ours, theirs = sorted(drained[name]), sorted(events[name])
        assert len(ours) == len(theirs), name
        for (s0, s1), (e0, e1) in zip(ours, theirs):
            assert e0 - CLOCK_SLACK_NS <= s0 and s1 <= e1 + CLOCK_SLACK_NS, name
            gaps += [abs(s0 - e0), abs(e1 - s1)]
    assert float(np.median(gaps)) < CLOCK_MEDIAN_NS


def test_counters_alone_record_no_span_and_read_without_emptying():
    tracing.enable(spans=False)
    assert tracing.counting() and not tracing.enabled()
    assert tracing.span("train.dispatch") is tracing.span("nn.spectral")
    with tracing.span("train.dispatch"):
        tracing.count("mmd.pair_sum.launches")
        tracing.count("mmd.pair_sum.launches", 2)
    assert tracing.counters() == {"mmd.pair_sum.launches": 3}
    assert tracing.counters() == {"mmd.pair_sum.launches": 3}
    tracing.disable()
    assert not tracing.counting()
    tracing.count("mmd.pair_sum.launches")
    assert tracing.drain() == ([], {"mmd.pair_sum.launches": 3})


def test_macro_batch_spans_carry_their_thread():
    src = SyntheticImages(size=8, channels=3, seed=1)
    idents = []

    def produce():
        idents.append(threading.get_ident())
        for s in range(3):
            macro_batch_at(src, s, 2, 4, u8=True)

    tracing.enable()
    t = threading.Thread(target=produce)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    tracing.disable()
    spans, _ = tracing.drain()
    assert [s.name for s in spans] == ["data.macro_batch"] * 3
    assert all(s.thread == idents[0] != threading.get_ident() for s in spans)
    assert all(s.parent is None and s.root == s.id for s in spans)


def test_the_store_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=4))
    tracing.enable()
    for _ in range(10):
        with tracing.span("train.noise"):
            pass
    tracing.count("dp.bytes", 3)
    tracing.count("dp.bytes", 4)
    spans, counters = tracing.drain()
    ids = [s.id for s in spans]
    assert len(spans) == 4 and ids == sorted(ids)
    assert counters == {"tracing.dropped_spans": 6, "dp.bytes": 7}
    assert tracing.drain() == ([], {})


def test_collectives_are_spans_with_their_bytes(tmp_path):
    ranks = _torch_dist.run(2, "tracing_suite", {}, tmp_path)
    for names, counters, expect in ranks:
        assert collections.Counter(names) == collections.Counter(
            ["dp.all_reduce", "dp.all_gather", "dp.shift", "dp.reduce_scatter",
             "dp.all_gather"])
        assert counters == {"dp.bytes": expect}


def _profiled_trainer_cfg(tmp_path):
    return Config(**{**CFG, "max_iteration": 3, "steps_per_dispatch": 1, "log_every": 0,
                     "sample_every": 0, "checkpoint_every": 0, "profile_steps": 1,
                     "profile_start": 1, "MMD_lr_scheduler": False,
                     "checkpoint_dir": str(tmp_path / "ck"), "sample_dir": str(tmp_path / "s"),
                     "log_dir": str(tmp_path / "l")})


def test_the_trainers_profiler_window_carries_the_spans(tmp_path):
    cfg = _profiled_trainer_cfg(tmp_path)
    Trainer(cfg, device="cpu").train()
    assert not tracing.enabled() and tracing.drain() == ([], {})
    path = os.path.join(cfg.log_dir, "profile", cfg.run_name(), "trace_1.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.dispatch", "train.d_grad", "nn.spectral"} <= names


def test_the_profiler_window_leaves_a_callers_counters_on(tmp_path):
    tracing.enable(spans=False)
    tracing.count("dp.bytes", 5)
    Trainer(_profiled_trainer_cfg(tmp_path), device="cpu").train()
    assert tracing.counting() and not tracing.enabled()
    assert tracing.counters() == {"dp.bytes": 5}
