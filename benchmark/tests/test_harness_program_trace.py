"""The program-span windows (``benchmark.program_trace``): the attribution
of kernels and idle gaps to program spans on a synthetic event list, each
new reader on a synthetic window, and a CPU rehearsal in which the new
windows leave every reading of the cell's own windows as it was."""

import pathlib
import time

import pytest
import torch

from benchmark import common, program_trace, score_cell, train_cell
from benchmark.program_trace import OUTSIDE, Ev
from benchmark.tests._tiny import score_config, threads, train_config

SEED = 2_147_483_659 * 5
NAMES = {"train.d_update", "train.d_grad", "nn.spectral"}
US = 1000                     # ns


def _host(name, start, end, corr, thread=1, linked=0):
    return Ev(name, False, thread, start * US, end * US, corr, linked)


def _dev(name, start, end, linked):
    return Ev(name, True, 0, start * US, end * US, 9000 + start, linked)


EVENTS = [
    # thread 1: train.d_update [0, 100] holds train.d_grad [10, 50];
    # nn.spectral [200, 300] alone
    _host("train.d_update", 0, 100, 1),
    _host("train.d_grad", 10, 50, 2),
    _host("nn.spectral", 200, 300, 3),
    # operations: one inside the child span, one in the parent only, one
    # outside every span; a runtime call on another thread linked to the first
    _host("aten::mul", 12, 14, 11),
    _host("aten::add", 60, 61, 12),
    _host("aten::sum", 500, 501, 13),
    _host("cudaLaunchKernel", 12, 13, 11, thread=77, linked=11),
    # the device: a kernel of the child's operation, one of the parent's
    # and its copy, one launched by the span itself (no operation), one
    # outside; the profiler's device-side copy of a span is left out
    _dev("k_child", 20, 30, 11),
    _dev("k_child_next", 25, 35, 11),          # overlaps the one before it
    _dev("k_parent", 72, 80, 12),
    _dev("Memcpy DtoD", 80, 84, 12),
    _dev("k_span", 400, 410, 3),
    _dev("k_outside", 600, 610, 13),
    _dev("train.d_update", 0, 610, 0),
]


def test_kernels_and_gaps_go_to_the_innermost_span():
    out = program_trace.attribute(EVENTS, NAMES)
    s = out["spans"]
    assert s["train.d_grad"]["launches"] == 2 and s["train.d_update"]["launches"] == 1
    assert s["train.d_update"]["launches_in"] == 3
    assert s["train.d_grad"]["device_ms"] == pytest.approx(0.015)         # the union
    assert s["train.d_update"]["device_ms"] == pytest.approx(0.012)       # kernel + copy
    assert s["train.d_update"]["device_ms_in"] == pytest.approx(0.027)
    assert s["nn.spectral"]["launches"] == 1 and s[OUTSIDE]["launches"] == 1
    assert {k: v["count"] for k, v in s.items() if v["count"]} == {
        "train.d_update": 1, "train.d_grad": 1, "nn.spectral": 1}
    # gaps: 35-72 (middle 53: train.d_grad has closed), 84-400 (middle
    # 242: nn.spectral), 410-600 (middle 505: no span open)
    assert dict((n, v) for n, v in out["idle_spans"]) == pytest.approx(
        {"nn.spectral": 316e-6, OUTSIDE: 190e-6, "train.d_update": 37e-6})
    assert s["nn.spectral"]["idle_ms"] == pytest.approx(0.316)
    assert [n for n, _ in out["idle_spans"]] == ["nn.spectral", OUTSIDE, "train.d_update"]


def test_nested_spans_sharing_an_instant():
    evs = [_host("train.d_update", 0, 100, 1), _host("train.d_grad", 0, 100, 2),
           _host("aten::mul", 0, 1, 11), _dev("k", 5, 6, 11)]
    s = program_trace.attribute(evs, NAMES)["spans"]
    assert s["train.d_grad"]["launches"] == 1 and s["train.d_update"]["launches_in"] == 1


WINDOW = {
    "unit": "macro_step", "units_a": 8, "units_b": 4,
    "host": {"data.macro_batch": {"count": 9, "host_ms": 20.0, "off_main_count": 8,
                                  "off_main_ms": 16.0},
             "eval.gaussian_stats": {"count": 1, "host_ms": 30.0},
             "eval.frechet": {"count": 1, "host_ms": 90.0},
             "eval.three_sample_test": {"count": 2, "host_ms": 50.0}},
    "counters_a": {"dp.bytes": 800.0},
    "device": {"spans": {"nn.spectral": {"launches": 400, "idle_ms": 8.0},
                         "train.sn_refresh": {"launches": 200, "idle_ms": 4.0},
                         "dp.all_reduce": {"device_ms": 4.0}, "dp.shift": {"device_ms": 2.0},
                         "losses.mmd": {"device_ms": 1.2},
                         "train.d_grad": {"device_ms_in": 60.0, "launches": 7}},
               "idle_spans": []},
}
SCORE_WINDOW = dict(WINDOW, unit="event", units_a=1, units_b=1)


@pytest.mark.parametrize("name,kind,window,want", [
    ("train.spectral.launches_per_macro_step", "train", WINDOW, 150.0),
    ("train.critic_backward.device_ms_per_macro_step", "train", WINDOW, 15.0),
    ("data.produce_ms_per_macro_step", "train", WINDOW, 2.0),
    ("train.spectral.launches_per_macro_step", "train4", WINDOW, 150.0),
    ("train.critic_backward.device_ms_per_macro_step", "train4", WINDOW, 15.0),
    ("data.produce_ms_per_macro_step", "train4", WINDOW, 2.0),
    ("score.fid_ms_per_event", "score", SCORE_WINDOW, 120.0),
    ("score.test_ms_per_event", "score", SCORE_WINDOW, 50.0),
    ("dp.collective_ms_per_macro_step", "train4", WINDOW, 1.5),
    ("dp.ring_mmd.device_ms_per_macro_step", "train4", WINDOW, 0.3),
    ("dp.bytes_per_macro_step", "train4", WINDOW, 100.0),
])
def test_new_readers(monkeypatch, name, kind, window, want):
    run = {"kind": kind, "trace": {}}
    monkeypatch.setattr(program_trace, "windows", lambda r: window if r is run else None)
    assert common.read_metric(name, run) == pytest.approx(want)
    # the other kind of cell, and a program without tracing, read nothing
    other = {"kind": "score" if kind in ("train", "train4") else "train", "trace": {}}
    monkeypatch.setattr(program_trace, "windows", lambda r: window)
    assert common.read_metric(name, other) is None
    monkeypatch.setattr(program_trace, "windows", lambda r: None)
    assert common.read_metric(name, run) is None


# what the one-card training readers need of a run, at made-up values
TRAIN_RUN = {"trace": {"macro_steps": 8, "launches": 800, "busy_s": 1.0, "window_s": 4.0},
             "rate": {"macro_steps": 8, "window_s": 2.0, "images": 384},
             "spans": {"data.wait": [0.002, 0.004]}, "peaks": {"bf16": 1e15}, "chips": 4,
             "config": {"flops_per_macro_step": 1e13, "steps_per_dispatch": 4}}
TRAIN4_COPIES = sorted(m["name"] for m in common.benchmark_file()["per_layer"]
                       if m["name"].endswith(".train4") and m["name"] != "train.images_per_s.train4")


@pytest.mark.parametrize("name", TRAIN4_COPIES)
def test_train4_readers_read_the_one_card_ones(monkeypatch, name):
    """``<metric>.train4`` reads in the ``train4`` cell what ``<metric>``
    reads there, and nothing in a one-card training cell."""
    monkeypatch.setattr(program_trace, "windows", lambda r: dict(WINDOW, counters_b={}))
    shared = name[:-len(".train4")]
    run, one = dict(TRAIN_RUN, kind="train4"), dict(TRAIN_RUN, kind="train")
    want = common.read_metric(shared, run)
    assert want is not None and common.read_metric(name, run) == want
    assert common.read_metric(shared, one) is not None and common.read_metric(name, one) is None


def test_train4_rate_reader():
    run = dict(TRAIN_RUN, kind="train4")
    assert common.read_metric("train.images_per_s.train4", run) == pytest.approx(192.0)
    assert common.read_metric("train.images_per_s.train4", dict(run, kind="train")) is None
    assert common.read_metric("train.images_per_s.train4", dict(run, rate=None)) is None


def test_windows_need_a_traced_run_on_a_card():
    assert program_trace.windows({}) is None
    assert program_trace.windows({"kind": "train"}) is None


@pytest.mark.parametrize("cell_module,config,traffic", [(train_cell, train_config, "train"),
                                                   (score_cell, score_config, "score")],
                         ids=["train", "score"])
def test_new_windows_leave_the_old_readings(monkeypatch, tmp_path, cell_module, config, traffic):
    # Inception's weights at a path of this test's own: other tests' runs
    # remove the shared one
    monkeypatch.setattr(score_cell, "weights_path", lambda: str(tmp_path / "inception.npz"))
    bench = common.benchmark_file()
    ctx = {"config": config(), "traffic": common.load_traffic(traffic), "seed": SEED,
           "seconds": 0.5, "trace": True, "device": "cpu", "chips": 1, "peaks": None,
           "t0": time.perf_counter()}
    new = {f.stem for f in pathlib.Path(common.HERE, "metrics").glob("*.py")
           if "program_trace" in f.read_text()}
    old = [m["name"] for m in bench["per_layer"] if m["name"] not in new]
    with threads():
        run = cell_module.run(ctx)["run"]
        before = {m: common.read_metric(m, run) for m in old}
        w = program_trace.measure(run, SEED, torch.device("cpu"))
        after = {m: common.read_metric(m, run) for m in old}
    assert before == after and any(v is not None for v in before.values())
    assert w["units_a"] >= 1 and w["traced_per_s"] > 0
    names = set(w["host"])
    if traffic == "train":
        assert {"train.dispatch", "train.d_grad", "nn.spectral", "data.macro_batch"} <= names
        assert w["host"]["data.macro_batch"]["off_main_count"] >= 1
    else:
        assert {"eval.inception", "eval.gaussian_stats", "eval.frechet",
                "eval.three_sample_test"} <= names
