"""The port's bench (``python -m smmdax_torch.bench``) and its two tools
on the CPU, as tests/test_bench.py and tests/test_bench_signals.py hold
the JAX package's ``bench.py``: the whole flow on a tiny config with the
module's constants cut, the progressive-JSON contract, the key set of the
JAX bench's last line, the signal contract in a real subprocess, and no
fallback to the CPU.  Real numbers come from the card (``chip_smoke.py
--only bench``); this pins the plumbing.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX bench's last line with every arm run, on a device without a
# listed peak (tests/test_bench.py's tiny config, jax 0.9.0 on the CPU)
JAX_LAST_LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "vs_prev_round", "steps_per_dispatch",
    "data_placement", "windows", "min", "max", "pool_samples", "final_mmd2",
    "flops_per_macro_step", "tflops_per_sec", "device_resident", "sampling", "host_fed",
    "batch_sweep", "dispatch_sweep", "skipped_arms", "total_bench_time_s"}
JAX_ARM_KEYS = {"device_resident": {"images_per_sec", "min", "max"},
                "host_fed": {"images_per_sec", "min", "max"},
                "sampling": {"images_per_sec", "batch", "windows"}}
# tools/bench_large.py's and tools/profile_ablation.py's rows without a peak
JAX_LARGE_KEYS = {"on_device_data": {"macro_step_ms", "images_per_sec", "window_ms",
                                     "spread_pct", "compile_s", "tflops_per_step",
                                     "tflops_per_sec"},
                  "tunneled_u8": {"macro_step_ms", "images_per_sec", "window_ms",
                                  "spread_pct"}}
JAX_ABLATION_KEYS = {"ablation", "macro_step_ms", "window_ms", "spread_pct",
                     "images_per_sec", "tflops", "tflops_per_sec"}
JAX_ABLATIONS = ["flagship_sn_smmd", "no_sn (smmd)", "no_sigma (mmd+sn)", "plain_mmd",
                 "sigma_exact", "f32_convs", "gp_witness"]

_TINY = dict(gf_dim=8, df_dim=8, dof_dim=4, z_dim=8, dsteps=1)


def _tiny(batch_size: int = 8, k: int = 1):
    from smmdax_torch.configs import Config
    return Config(model="sn-smmd", kernel="rq", architecture="dcgan",
                  dataset="synthetic", output_size=32,
                  batch_size=batch_size, real_batch_size=batch_size,
                  gsteps=1, random_seed=0, steps_per_dispatch=k, **_TINY)


@pytest.fixture()
def tiny_bench(monkeypatch):
    from smmdax_torch import bench
    monkeypatch.setattr(bench, "_flagship_cfg", _tiny)
    monkeypatch.setattr(bench, "HEADLINE_K", 2)
    monkeypatch.setattr(bench, "HOST_K", 2)
    monkeypatch.setattr(bench, "HEADLINE_BATCH", 8)
    monkeypatch.setattr(bench, "POOL_SAMPLES", 64)
    monkeypatch.setattr(bench, "SAMPLING_BATCH", 8)
    monkeypatch.setattr(bench, "DISPATCH_SWEEP", (1,))
    monkeypatch.setattr(bench, "BATCH_SWEEP", (8,))
    monkeypatch.setattr(bench, "N_WINDOWS", 2)
    monkeypatch.setattr(bench, "STEPS_PER_WINDOW", 4)
    monkeypatch.setattr(bench, "HEADLINE_WINDOWS", 2)
    monkeypatch.setattr(bench, "HEADLINE_STEPS_PER_WINDOW", 4)
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    # a loaded host must not skip arms: "nothing skipped" is deterministic
    monkeypatch.setattr(bench, "BUDGET_S", 10_000_000.0)
    return bench


def _json_lines(out: str):
    """Every JSON line of captured output (stripped: the signal-time line
    starts with a newline of its own)."""
    return [json.loads(line) for line in out.splitlines()
            if line.strip().startswith("{")]


def test_bench_main_emits_progressive_json(tiny_bench, capsys):
    tiny_bench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    lines = _json_lines(out)
    assert len(lines) >= 2, "headline line + at least one enriched line"

    first, last = lines[0], lines[-1]
    # the FIRST line is already a complete headline
    assert first["value"] > 0 and first["unit"] == "images/sec"
    assert first["vs_baseline"] is None and first["vs_prev_round"] is None
    assert first["data_placement"] == "device"
    assert first["steps_per_dispatch"] == 2
    assert first["flops_per_macro_step"] > 0 and first["tflops_per_sec"] >= 0
    assert all(line["value"] == first["value"] for line in lines)

    # the LAST line carries every optional arm, with the JAX bench's keys
    assert last["skipped_arms"] == []
    assert set(last) == JAX_LAST_LINE_KEYS
    for arm, keys in JAX_ARM_KEYS.items():
        assert set(last[arm]) == keys, arm
        assert last[arm]["images_per_sec"] > 0
    assert set(last["batch_sweep"]) == {"8"}
    assert last["batch_sweep"]["8"]["mfu"] is None
    # the sweep includes the host-fed K alongside the swept points
    assert set(last["dispatch_sweep"]) == {"1", "2"}
    assert last["total_bench_time_s"] > 0
    # no peak on the CPU: no mfu anywhere, and the device line says why
    assert "mfu" not in json.dumps(last).replace('"mfu": null', "")
    assert "# device=cpu platform=cpu (no mfu" in out


def test_bench_budget_gate_skips_arms(tiny_bench, capsys, monkeypatch):
    """With a zero budget every optional arm is skipped, yet the headline
    still lands."""
    monkeypatch.setattr(tiny_bench, "BUDGET_S", 0.0)
    tiny_bench.main(["--device", "cpu"])
    lines = _json_lines(capsys.readouterr().out)
    assert lines, "headline must be emitted even with zero budget"
    last = lines[-1]
    assert last["value"] > 0
    assert "host_fed" not in last and "sampling" not in last
    skipped = " ".join(last["skipped_arms"])
    assert "sampling" in skipped and "host_fed" in skipped


def test_failed_optional_arm_is_listed(tiny_bench, capsys, monkeypatch):
    def broken(*args, **kwargs):
        raise ValueError("broken arm")

    monkeypatch.setattr(tiny_bench, "_measure_sampling", broken)
    monkeypatch.setattr(tiny_bench, "BATCH_SWEEP", ())
    monkeypatch.setattr(tiny_bench, "DISPATCH_SWEEP", ())
    tiny_bench.main(["--device", "cpu"])
    last = _json_lines(capsys.readouterr().out)[-1]
    assert last["skipped_arms"] == ["sampling (failed: ValueError)"]
    assert last["host_fed"]["images_per_sec"] > 0


def test_device_resident_arm_standalone(tiny_bench):
    out = tiny_bench._measure_device_resident(8, 2, pool=64, device="cpu")
    assert out["images_per_sec"] > 0
    assert len(out["windows"]) == 2
    assert out["pool_samples"] == 64
    assert out["flops_per_macro_step"] > 0 and "mfu" not in out


def test_sampling_arm_standalone(tiny_bench):
    out = tiny_bench._measure_sampling(8, windows=2, device="cpu")
    assert out["images_per_sec"] > 0
    assert len(out["windows"]) == 2 and out["batch"] == 8
    # rates only where the device has a listed peak
    assert "tflops_per_sec" not in out and "mfu" not in out


def test_peak_table_names_the_h100():
    from smmdax_torch import bench
    assert bench.PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989.4e12}
    assert bench.peak_flops(torch.device("cpu")) is None


@pytest.mark.parametrize("module", ["smmdax_torch.bench", "smmdax_torch.tools.bench_large",
                                    "smmdax_torch.tools.profile_ablation"])
def test_main_refuses_cpu_fallback(module, monkeypatch):
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(module).main([])


def test_bench_large_rows(monkeypatch, capsys):
    from smmdax_torch.tools import bench_large
    base = _tiny()
    monkeypatch.setattr(bench_large, "_configs", lambda: {
        "tiny_b8": base, "tiny_b8_remat": base.replace(remat=True)})
    bench_large.main(["--quick", "--device", "cpu"])
    rows = _json_lines(capsys.readouterr().out)
    assert [r["config"] for r in rows] == ["tiny_b8", "tiny_b8_remat"]
    assert all(r["device"] == "cpu" for r in rows)
    assert set(rows[0]) == {"config", "device", "on_device_data", "tunneled_u8"}
    assert set(rows[1]) == {"config", "device", "on_device_data"}
    for name, keys in JAX_LARGE_KEYS.items():
        assert set(rows[0][name]) == keys, name
        assert rows[0][name]["images_per_sec"] > 0 and len(rows[0][name]["window_ms"]) == 3


def test_bench_large_configs_are_jax_tools():
    from smmdax_torch.tools import bench_large
    cfgs = bench_large._configs()
    assert list(cfgs) == ["resnet64_b64", "celeba160_b64", "resnet64_b64_remat",
                          "celeba160_b64_remat"]
    assert (cfgs["celeba160_b64"].output_size, cfgs["celeba160_b64"].gf_dim) == (160, 32)
    assert cfgs["resnet64_b64_remat"] == cfgs["resnet64_b64"].replace(remat=True)


def test_profile_ablation_rows(monkeypatch, capsys):
    from smmdax_torch.tools import profile_ablation
    full = profile_ablation._ablations
    assert list(full(256)) == JAX_ABLATIONS
    monkeypatch.setattr(profile_ablation, "_ablations", lambda b: {
        name: cfg.replace(**_TINY) for name, cfg in full(b).items()})
    monkeypatch.setattr(profile_ablation, "WINDOW_STEPS", 1)
    profile_ablation.main(["--batch", "8", "--passes", "1", "--device", "cpu"])
    rows = _json_lines(capsys.readouterr().out)
    assert [r["ablation"] for r in rows] == JAX_ABLATIONS
    for r in rows:
        assert set(r) == JAX_ABLATION_KEYS, r["ablation"]
        assert r["macro_step_ms"] > 0 and len(r["window_ms"]) == 1 and r["tflops"] >= 0


# ---------------------------------------------------------------------------
# the signal contract, in a real subprocess (tests/test_bench_signals.py)

_SCRIPT = r"""
import sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from smmdax_torch import bench
from smmdax_torch.configs import Config

def _tiny(batch_size=8, k=1):
    return Config(model="sn-smmd", kernel="rq", architecture="dcgan",
                  dataset="synthetic", output_size=32, batch_size=8,
                  real_batch_size=8, gf_dim=8, df_dim=8, dof_dim=4,
                  z_dim=8, dsteps=1, gsteps=1, random_seed=0,
                  steps_per_dispatch=2)

bench._flagship_cfg = _tiny
bench.HEADLINE_K = 2; bench.HOST_K = 2
bench.HEADLINE_BATCH = 8; bench.POOL_SAMPLES = 64
bench.SAMPLING_BATCH = 8; bench.DISPATCH_SWEEP = (); bench.BATCH_SWEEP = ()
bench.N_WINDOWS = 2; bench.STEPS_PER_WINDOW = 2; bench.WARMUP_STEPS = 1
bench.HEADLINE_WINDOWS = 2; bench.HEADLINE_STEPS_PER_WINDOW = 2
bench.BUDGET_S = 10_000_000.0
mode = sys.argv[1]
if mode == "hang_optional":      # the signal lands mid-OPTIONAL-arm
    bench._measure_sampling = lambda *a, **k: time.sleep(600)
elif mode == "hang_required":    # the signal lands mid-REQUIRED-arm
    bench._measure_device_resident = lambda *a, **k: time.sleep(600)
bench.main(["--device", "cpu"])
"""

_HANDLERS_MARKER = "signal handlers installed"


def _pump(proc, q):
    for line in iter(proc.stdout.readline, b""):
        q.put(line.decode())
    q.put(None)


def _launch(mode, tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(_SCRIPT.format(repo=_REPO))
    proc = subprocess.Popen([sys.executable, str(script), mode],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=_REPO)
    q = queue.Queue()
    threading.Thread(target=_pump, args=(proc, q), daemon=True).start()
    return proc, q


def _read_until(q, predicate, timeout_s):
    """Pumped stdout lines until predicate(lines), EOF or the deadline,
    which holds even when the subprocess goes silent."""
    lines = []
    deadline = time.time() + timeout_s
    while True:
        wait = deadline - time.time()
        if wait <= 0:
            return lines
        try:
            line = q.get(timeout=min(1.0, wait))
        except queue.Empty:
            continue
        if line is None:  # EOF: the subprocess exited
            return lines
        lines.append(line)
        if predicate(lines):
            return lines


def test_sigterm_after_headline_emits_final_json_and_exits_zero(tmp_path):
    proc, q = _launch("hang_optional", tmp_path)
    try:
        lines = _read_until(q, lambda ls: bool(_json_lines("".join(ls))), timeout_s=300)
        assert _json_lines("".join(lines)), "headline never appeared"
        time.sleep(1.0)  # let it settle into the hanging optional arm
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        lines += _read_until(q, lambda ls: False, 60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    emitted = _json_lines("".join(lines))
    assert len(emitted) >= 2, "bail line missing after SIGTERM"
    last = emitted[-1]
    assert last["value"] == emitted[0]["value"] > 0
    assert any(s.startswith(f"<signal {int(signal.SIGTERM)} ") for s in last["skipped_arms"])


def test_sigterm_before_headline_exits_three_without_json(tmp_path):
    proc, q = _launch("hang_required", tmp_path)
    try:
        # synchronise on the handlers' installation, never on a fixed sleep
        lines = _read_until(q, lambda ls: any(_HANDLERS_MARKER in line for line in ls),
                            timeout_s=300)
        assert any(_HANDLERS_MARKER in line for line in lines)
        time.sleep(0.5)  # inside the hanging required arm now
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        lines += _read_until(q, lambda ls: False, 60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 3
    assert not _json_lines("".join(lines)), "nothing useful existed to emit"
