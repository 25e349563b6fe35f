"""The budget and signal contract of the port's dry run
(``smmdax_torch.graft_entry.dryrun_multichip``), driven as a real
subprocess on the CPU, as tests/test_dryrun_signals.py drives JAX's:

* budget exhausted: the core runs, the optional modes are skipped with a
  printed line, the summary prints, exit 0;
* SIGTERM after the core has passed: the summary with the signal line,
  exit 0;
* SIGTERM before the core has passed: exit 3, no OK line.

Each case runs at 1 rank (in the process) and at 2 gloo ranks (spawned;
the launcher keeps the tally and takes the signal).  At 2 ranks the
hanging mode leaves rank 1 blocked inside a gloo collective, where no
Python handler can run, and the ranks the launcher started must be gone
when it has exited.  The modes are stand-ins, top-level functions of the
test script, which the launcher hands to the spawned ranks.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import torch
from smmdax_torch import graft_entry as g


def fast_a(ctx):
    return "a=1"


def fast_b(ctx):
    return "b=1"


def fast_c(ctx):
    return "c=1"


def hang(ctx):
    # rank 0 sleeps; every other rank waits for it inside a collective
    with open(os.path.join(os.environ["PID_DIR"], str(os.getpid())), "w"):
        pass
    if ctx.axis.index == 0:
        time.sleep(600)
    else:
        ctx.axis.psum(torch.ones(1))


if __name__ == "__main__":
    case, n = sys.argv[1], int(sys.argv[2])
    core = [("c1", fast_a), ("c2", fast_b), ("c3", fast_c)]
    if case == "budget_skip":
        g._MODES = core + [("opt1", hang), ("opt2", hang)]
        g.DRYRUN_BUDGET_S = 0.0          # the core still runs; optional skipped
    elif case == "hang_after_core":
        g._MODES = core + [("opt_hang", hang)]
        g.DRYRUN_BUDGET_S = 10_000.0
    elif case == "hang_before_core":
        g._MODES = [("core_hang", hang)]
        g.DRYRUN_BUDGET_S = 10_000.0
    g.dryrun_multichip(n, device="cpu")
"""


def _pump(proc, q):
    for line in iter(proc.stdout.readline, b""):
        q.put(line.decode())
    q.put(None)


def _launch(case, n, tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(_SCRIPT.format(repo=_REPO))
    pids = tmp_path / "pids"
    pids.mkdir()
    env = dict(os.environ, PID_DIR=str(pids))
    proc = subprocess.Popen([sys.executable, str(script), case, str(n)],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            env=env, cwd=str(tmp_path))
    q = queue.Queue()
    threading.Thread(target=_pump, args=(proc, q), daemon=True).start()
    return proc, q, pids


def _read_until(q, predicate, timeout_s):
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
        if line is None:
            return lines
        lines.append(line)
        if predicate(lines):
            return lines


def _drain(q, timeout_s=60.0):
    return _read_until(q, lambda ls: False, timeout_s)


def _n_ok(lines):
    return sum(1 for line in lines if ": OK" in line)


def _stop(proc):
    """A script still running after a failed check: SIGTERM first (its
    launcher stops its ranks), then SIGKILL."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _wait_for_ranks(pids, n):
    """Until every rank has entered the hanging mode, then a second more."""
    deadline = time.time() + 60
    while len(os.listdir(pids)) < n and time.time() < deadline:
        time.sleep(0.1)
    time.sleep(1.0)
    assert len(os.listdir(pids)) == n


def _assert_ranks_gone(pids):
    """Every process that ran a hanging mode has ended (the launcher's
    ranks, reaped when it exited; at one rank the script itself)."""
    for name in os.listdir(pids):
        with pytest.raises(ProcessLookupError):
            os.kill(int(name), 0)


@pytest.mark.parametrize("n", [1, 2])
def test_budget_exhaustion_skips_optional_and_exits_zero(tmp_path, n):
    proc, q, _ = _launch("budget_skip", n, tmp_path)
    try:
        lines = _read_until(q, lambda ls: any("modes OK" in line for line in ls),
                            timeout_s=300)
        proc.wait(timeout=60)
        lines += _drain(q)
    finally:
        _stop(proc)
    out = "".join(lines)
    assert proc.returncode == 0, out
    assert _n_ok(lines) == 3, out            # the required core ran
    assert out.count("# skipping") == 2, out  # both optional modes gated
    assert "3/5 modes OK" in out, out
    assert "opt1" in out and "opt2" in out


@pytest.mark.parametrize("n", [1, 2])
def test_sigterm_after_core_prints_summary_and_exits_zero(tmp_path, n):
    proc, q, pids = _launch("hang_after_core", n, tmp_path)
    try:
        lines = _read_until(q, lambda ls: _n_ok(ls) >= 3, timeout_s=300)
        assert _n_ok(lines) == 3, "".join(lines)
        _wait_for_ranks(pids, n)     # inside the hanging optional mode
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        lines += _drain(q)
    finally:
        _stop(proc)
    out = "".join(lines)
    assert proc.returncode == 0, out
    assert "3/4 modes OK" in out, out
    assert "dryrun signal" in out, out
    _assert_ranks_gone(pids)


@pytest.mark.parametrize("n", [1, 2])
def test_sigterm_before_core_exits_three(tmp_path, n):
    proc, q, pids = _launch("hang_before_core", n, tmp_path)
    try:
        # the start banner prints AFTER the handlers are installed
        lines = _read_until(q, lambda ls: any(
            f"# dryrun_multichip({n}):" in line for line in ls), timeout_s=300)
        assert any(f"# dryrun_multichip({n}):" in line for line in lines)
        _wait_for_ranks(pids, n)     # inside the hanging core mode
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        lines += _drain(q)
    finally:
        _stop(proc)
    out = "".join(lines)
    assert proc.returncode == 3, out
    assert _n_ok(lines) == 0, out
    _assert_ranks_gone(pids)
