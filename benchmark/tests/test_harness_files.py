"""BENCHMARK.json and the files it names: every configuration, traffic
mix and per-layer metric loads by its name, and every name, unit and
line keeps to the benchmark's character rules."""

import json
import math
import os
import re

import pytest

from benchmark import common

BENCH = common.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= E2E_KEYS and metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= LAYER_KEYS and _line(metric["layer"])
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        path = os.path.join(common.HERE, "metrics", f"{metric['name']}.py")
        assert os.path.exists(path)
        # a reader that finds nothing to read returns nothing
        assert common.read_metric(metric["name"], {}) is None
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= names
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    c = common.load_config(cell["config"])
    t = common.load_traffic(cell["traffic"])
    # a kind of traffic is a cell module, benchmark/<kind>_cell.py, with its limits
    assert common.has_cell_module(t["kind"]) and t["kind"] in c["limits"]
    e2e = common.cell_metrics(BENCH, cell["name"], trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = common.cell_metrics(BENCH, cell["name"], trace=True)
    assert layer and {m["moves"] for m in layer} <= names


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    c = common.load_config(entry["name"])
    assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    assert c["reduced"] == entry["reduced"]
    # every reduced key states its published value, and no width is cut
    assert set(c["published"]) == set(entry["reduced"])
    for k in entry["reduced"]:
        assert not k.endswith(("_dim", "_rank", "_size")) or k == "no_of_samples"
    assert c["script"].startswith("exp/") and "arXiv:1805.11565" in c["paper"]
    assert c["assumed"] and c["flops_basis"]
    assert math.isfinite(c["flops_per_macro_step"]) and c["flops_per_macro_step"] > 0
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_config_matches_its_script():
    """Each configuration holds its exp/ script's flags as published,
    apart from the keys it lists under ``reduced``."""
    root = common.ROOT
    for entry in BENCH["configs"]:
        c = common.load_config(entry["name"])
        # the flags, without the scripts' `# ...` comments
        text = re.sub(r"`[^`]*`", "", open(os.path.join(root, c["script"])).read())
        for flag, value in re.findall(r"--(\w+) ([^\s\\`]+)", text):
            if flag in c["reduced"] or flag not in c or "$" in value:
                continue
            want = c[flag]
            got = (value == "true") if isinstance(want, bool) else type(want)(value)
            assert got == want, (entry["name"], flag)
