"""The port's entry point and multichip dry run (``smmdax_torch.graft_entry``)
against the JAX package's ``__graft_entry__``.

* ``entry(device="cpu")`` against JAX's ``entry()`` at the flagship's full
  width, on JAX's weights converted (``convert.load_module``): on the
  example arguments (zeros) and on one seeded set of inputs;
* the mode list: JAX's 13 names in JAX's order, and the same core;
* the shared context's macro-batch bit-equal to JAX's ``_dryrun_ctx(2)``;
* the 13 modes on 2 gloo ranks through ``tests/_torch_dist.py`` (a
  caller's ``DataAxis``): every mode passes with its asserts, rank 0 prints
  the OK lines and the summary; the three core modes start from JAX's
  ``create_state(PRNGKey(0))`` converted, with JAX's draws replayed, and
  their metrics match JAX's same modes on a 2-device sub-mesh
  (``jit_train_step``; states, draws and metrics recorded by
  ``tests/fixtures/port_dryrun/make_fixtures.py``);
* ``dryrun_multichip(2, device="cpu")`` through its launcher in a fresh
  process: 13 OK lines in order, the summary, exit 0;
* ``python -m smmdax_torch.graft_entry --device cpu``: the entry's finite
  (loss, mmd2, sigma), then the dry run on one rank, 13/13;
* no fallback: without a card ``entry`` and ``dryrun_multichip`` raise,
  and more ranks than cards are refused, both naming ``device='cpu'``.

Tolerances: ``entry`` rtol 1e-4 / atol 1e-6 as tests/test_torch_losses.py;
the core modes' metrics as tests/test_torch_gspmd.py (GSPMD, rtol 2e-3 /
atol 2e-5) and tests/test_torch_train_dp.py (shard_map, rtol 1e-3 / atol
1e-6).
"""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import _torch_dist
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_parity import port_state
from smmdax_torch import convert, graft_entry
from smmdax_torch.configs import Config as TConfig
from smmdax_torch.train import create_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
ENTRY_TOL = dict(rtol=1e-4, atol=1e-6)
GSPMD_TOL = dict(rel=2e-3, abs=2e-5)
SHARD_MAP_TOL = dict(rel=1e-3, abs=1e-6)
NAMES = [name for name, _ in jentry._MODES]


def _port_cfg(jcfg) -> TConfig:
    return TConfig(**{f: getattr(jcfg, f) for f in TConfig.__dataclass_fields__})


def _entry_inputs(example):
    r = np.random.default_rng(3)
    real = (r.standard_normal(example[4].shape) * 0.5).astype(np.float32)
    z = r.uniform(-1.0, 1.0, example[5].shape).astype(np.float32)
    return real, z


def test_entry_matches_jax_entry_on_converted_weights():
    jfn, jargs = jentry.entry()
    fn, targs = graft_entry.entry(device="cpu")
    assert [tuple(a.shape) for a in targs[4:]] == [tuple(a.shape) for a in jargs[4:6]]
    # JAX's weights in a port state of the same config, then as fn's arguments
    state = create_state(graft_entry.flagship_cfg(), 0, "cpu")
    convert.load_module(state.gen, jargs[0], jargs[1])
    convert.load_module(state.disc, jargs[2], jargs[3])
    weights = tuple({n: t.detach() for n, t in items} for items in (
        state.gen.named_parameters(), state.gen.named_buffers(),
        state.disc.named_parameters(), state.disc.named_buffers()))
    for names, got in zip(weights, targs[:4]):
        assert set(names) == set(got)
    jf = jax.jit(jfn)
    for real, z in ((np.zeros(jargs[4].shape, np.float32), np.zeros(jargs[5].shape, np.float32)),
                    _entry_inputs(jargs)):
        want = jf(*jargs[:4], jnp.asarray(real), jnp.asarray(z), jargs[6])
        with torch.no_grad():
            got = fn(*weights, torch.from_numpy(real), torch.from_numpy(z))
        for name, g, w in zip(("loss", "mmd2", "sigma"), got, want):
            np.testing.assert_allclose(float(g), float(w), err_msg=name, **ENTRY_TOL)


def test_modes_are_jax_modes():
    assert [name for name, _ in graft_entry._MODES] == NAMES
    assert len(NAMES) == 13
    assert graft_entry.N_CORE_MODES == jentry.N_CORE_MODES == 3
    assert graft_entry.DRYRUN_BUDGET_S == jentry.DRYRUN_BUDGET_S


def test_context_matches_jax_context():
    jctx = jentry._dryrun_ctx(N)
    ctx = graft_entry.dryrun_context(types.SimpleNamespace(size=N))
    assert ctx.real.dtype == np.float32
    np.testing.assert_array_equal(ctx.real, np.asarray(jctx["real"]))
    # the port's one changed default: its fused kernels' row threshold
    assert _port_cfg(jctx["cfg"]).replace(pallas_min_rows=0) == ctx.cfg


def _core_cfgs(cfg):
    """(name, JAX config, JAX mode) of the three core modes, as
    __graft_entry__.py:160-182 builds them."""
    return [("gspmd", cfg, None),
            ("shard_map+ring", cfg.replace(use_ring_mmd=True), "shard_map"),
            ("shard_map+ring tmmd", cfg.replace(model="tmmd", use_ring_mmd=True, with_sn=False,
                                                with_scaling=False), "shard_map")]


def _reference(core_cfgs) -> dict:
    """JAX's core modes on a 2-device mesh (states, draws and metrics),
    recorded by ``tests/fixtures/port_dryrun/make_fixtures.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_dryrun_fixtures", os.path.join(REPO, "tests", "fixtures", "port_dryrun",
                                             "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load(core_cfgs)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The 13 modes on one 2-rank gloo group, the core modes from JAX's
    states and draws; JAX's core modes on a 2-device mesh (recorded)."""
    core = _core_cfgs(jentry._dryrun_ctx(N)["cfg"])
    ref = _reference(core)
    inputs, want = {}, {}
    for name, jcfg, _ in core:
        ts = port_state(_port_cfg(jcfg), ref[name]["state"])
        inputs[name] = dict(gen=ts.gen.state_dict(), disc=ts.disc.state_dict(),
                            noise=ref[name]["noise"])
        want[name] = ref[name]["metrics"]
    ranks = _torch_dist.run(N, "dryrun_suite", dict(inputs=inputs),
                            tmp_path_factory.mktemp("dryrun"))
    return dict(ranks=ranks, want=want)


def test_dryrun_on_two_ranks_passes_every_mode(dryrun):
    for rank in dryrun["ranks"]:
        records = rank["records"]
        assert [r["name"] for r in records] == NAMES
        assert all(r["status"] == "ok" for r in records), records
    lines = dryrun["ranks"][0]["printed"].splitlines()
    assert lines[0] == "# dryrun_multichip(2): 13 modes, budget 480s, core 3"
    assert [line.split(":")[0] for line in lines[1:14]] == [
        f"dryrun_multichip(2) {name}" for name in NAMES]
    assert all(": OK — " in line for line in lines[1:14])
    assert lines[14].startswith("dryrun_multichip: 13/13 modes OK in ")
    assert dryrun["ranks"][1]["printed"] == ""
    # each mode names the program it ran: the ranks' programs, never one device's
    progs = {r["name"]: r["detail"].split("; ")[-1] for r in dryrun["ranks"][0]["records"]}
    assert progs["gspmd"] == "GSPMD program on 2 rank(s)"
    assert progs["shard_map+ring tmmd"] == "per-rank shard_map program on 2 rank(s)"
    # the modes' metrics are global: the ranks agree
    assert ([r["metrics"] for r in dryrun["ranks"][0]["records"]]
            == [r["metrics"] for r in dryrun["ranks"][1]["records"]])


@pytest.mark.parametrize("name", NAMES[:3])
def test_core_modes_match_jax_modes(dryrun, name):
    got = next(r for r in dryrun["ranks"][0]["records"] if r["name"] == name)["metrics"]
    want = dryrun["want"][name]
    tol = GSPMD_TOL if name == "gspmd" else SHARD_MAP_TOL
    assert set(got) == set(want)
    for k in ("d_loss_mmd2", "d_sigma", "d_ratio", "g_mmd2", "g_loss"):
        assert got[k] == pytest.approx(want[k], **tol), k


def test_dryrun_launcher_on_two_cpu_ranks():
    code = ("from smmdax_torch import graft_entry as g\n"
            "print(len(g.dryrun_multichip(2, device='cpu')), 'records')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("SMMDAX_DRYRUN_BUDGET", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    oks = [line for line in lines if ": OK — " in line]
    assert [line.split(":")[0] for line in oks] == [f"dryrun_multichip(2) {n}" for n in NAMES]
    assert lines[-2].startswith("dryrun_multichip: 13/13 modes OK in "), out.stdout
    assert lines[-1] == "13 records"


def test_command_line_on_the_cpu():
    # torch on one thread in the process, as tests/_torch_threads.py runs it here
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("SMMDAX_DRYRUN_BUDGET", None)
    out = subprocess.run([sys.executable, "-m", "smmdax_torch.graft_entry", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("entry: [")
    values = [float(v) for v in lines[0][len("entry: ["):-1].split(",")]
    assert len(values) == 3 and all(np.isfinite(values))
    assert lines[1] == "# dryrun_multichip(1): 13 modes, budget 480s, core 3"
    oks = [line for line in lines if ": OK — " in line]
    assert [line.split(":")[0] for line in oks] == [f"dryrun_multichip(1) {n}" for n in NAMES]
    assert lines[-1].startswith("dryrun_multichip: 13/13 modes OK in "), out.stdout


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)
