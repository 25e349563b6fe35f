"""The port's asset-day protocol (``python -m smmdax_torch.tools.parity_day``)
against the JAX package's ``tools/parity_day.py`` on the same directories,
the port on ``device="cpu"``: blocked mode gives the same (check, status)
list and says what is missing; the happy path (random Inception weights,
fixture CIFAR-10, a populated reference tree, generated samples) gives the
same list as the JAX tool's report on the same inputs, recorded by
``tests/fixtures/port_parity_day/make_fixtures.py`` (which runs the JAX
tool), with FID and KID equal to its at the tolerance below;
``main(["--json", ...])`` prints a parseable report; without a card the
tool refuses the default device instead of falling back.

FID tolerance: 16 samples of 2,048-d pool3 features leave both covariances
of rank 15, and ``sqrtm`` of their product amplifies the float32 rounding
by which the two Inception networks differ (their pool3 agree to ~1e-6,
``tests/test_torch_inception.py``).  The report prints FID to 3 decimals and
KID to 6, so the numbers are compared at rel 1e-3 plus that rounding."""

import json
import os
import re
import sys

import numpy as np
import pytest

from smmdax_torch.tools import parity_day as port_tool

from _torch_threads import one_torch_thread, one_torch_thread_module  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import parity_day as jax_tool  # noqa: E402

FID_RTOL, FID_ATOL = 1e-3, 1e-3
KID_RTOL, KID_ATOL = 1e-3, 2e-6


def _pairs(report):
    return [(c, s) for c, s, _ in report]


def _scores(detail):
    fid = float(re.search(r"FID (-?[0-9.]+)", detail).group(1))
    kid = float(re.search(r"KID (-?[0-9.]+)", detail).group(1))
    return fid, kid


def test_blocked_mode_names_every_missing_asset(tmp_path):
    ref = tmp_path / "empty_ref"
    ref.mkdir()
    data = str(tmp_path / "no_data")
    want = jax_tool.run(str(ref), data)
    got = port_tool.run(str(ref), data, device="cpu")
    assert _pairs(got) == _pairs(want)
    st = dict(_pairs(got))
    for check in ("reference-mount", "inception-weights", "dataset-cifar10", "real-fid-kid"):
        assert st[check] == "BLOCKED"
    for c, s, d in got:
        if s == "BLOCKED":
            assert len(d) > 20, (c, d)
    # the details name the same missing things (the empty mount's up to
    # its last sentence, which the port words as a step of the protocol)
    cut = [d.split(" When populated")[0] for _, _, d in got]
    assert cut == [d.split(" When populated")[0] for _, _, d in want]
    assert got[0][2].startswith(f"{ref} is EMPTY")


def _recorder():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_parity_day_fixtures", os.path.join(ROOT, "tests", "fixtures", "port_parity_day",
                                                 "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def happy(tmp_path_factory):
    """Random weights, fixture CIFAR-10, a populated reference tree and
    generated samples: what the port's tool reports there, and the JAX
    tool's recorded report on the same inputs."""
    rec = _recorder()
    args, samples = rec.happy_inputs(str(tmp_path_factory.mktemp("happy")))
    want = rec.recorded_report(args, samples)
    got = port_tool.run(*args, samples_path=samples, score_n=rec.SCORE_N, device="cpu")
    return dict(args=args, samples=samples, want=want, got=got)


def test_happy_path_runs_every_check(happy):
    got, want = happy["got"], happy["want"]
    assert _pairs(got) == _pairs(want)
    st = dict(_pairs(got))
    assert st == {"reference-mount": "PASS", "reference-inventory": "INFO",
                  "reference-loss-oracle": "INFO", "inception-weights": "PASS",
                  "dataset-cifar10": "PASS", "dataset-imagenet64": "BLOCKED",
                  "dataset-celeba": "BLOCKED", "dataset-lsun": "BLOCKED",
                  "real-fid-kid-selfcheck": "PASS", "model-fid-kid": "PASS"}
    details = dict((c, d) for c, _, d in got)
    assert details["inception-weights"] == dict((c, d) for c, _, d in want)["inception-weights"]
    assert details["dataset-cifar10"] == "ArraySource, sample (32, 32, 3)"


@pytest.mark.parametrize("check", ["real-fid-kid-selfcheck", "model-fid-kid"])
def test_scores_equal_jax(happy, check):
    got = _scores(dict((c, d) for c, _, d in happy["got"])[check])
    want = _scores(dict((c, d) for c, _, d in happy["want"])[check])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], want[0], rtol=FID_RTOL, atol=FID_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=KID_RTOL, atol=KID_ATOL)


def _port_lines(out):
    """The port's printed lines, its data layer named as the JAX package's."""
    return out.replace("[smmdax_torch.data]", "[smmdax.data]").splitlines()


def test_cli_json_parsed(happy, tmp_path, capsys):
    """Weights but no dataset: the JSON report (the last line; the data
    layer prints its substitutions before it, in both tools)."""
    ref, data_dir = happy["args"]
    os.symlink(os.path.join(data_dir, "inception_v3.npz"), tmp_path / "inception_v3.npz")
    argv = ["--json", "--reference", ref, "--data_dir", str(tmp_path), "--score_n", "48"]
    assert port_tool.main(argv + ["--device", "cpu"]) == 0
    got = _port_lines(capsys.readouterr().out)
    assert jax_tool.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]
    rows, jrows = json.loads(got[-1]), json.loads(want[-1])
    assert all(set(r) == {"check", "status", "detail"} for r in rows)
    assert [(r["check"], r["status"]) for r in rows] == [
        (r["check"], r["status"]) for r in jrows]
    assert dict((r["check"], r["status"]) for r in rows)["inception-weights"] == "PASS"
    assert rows[-1] == {"check": "real-fid-kid", "status": "BLOCKED",
                        "detail": "no real cifar10 assets (above)"}


def test_cli_prints_report(tmp_path, capsys):
    ref = tmp_path / "ref"
    ref.mkdir()
    rc = port_tool.main(["--reference", str(ref), "--data_dir", str(tmp_path / "nope"),
                         "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "parity-day report" in out and "BLOCKED" in out
    jax_tool.main(["--reference", str(ref), "--data_dir", str(tmp_path / "nope")])
    want = capsys.readouterr().out.splitlines()
    assert [line.split(" When populated")[0] for line in _port_lines(out)] == [
        line.split(" When populated")[0] for line in want]


def test_refuses_the_cpu_fallback(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_tool.main(["--reference", str(tmp_path), "--data_dir", str(tmp_path)])
