"""The train step under a CUDA graph (``smmdax_torch.train``'s
``dispatch_train_step``): the Adam table and device count it needs, its
cache key, its counters, and on the card the graphed macro-steps held bit
for bit to eager ones.

The file imports neither JAX nor the JAX package, so its card tests run
on a machine without them:

    python -m pytest tests/test_torch_graph.py -m cuda --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` configures JAX).  Here
they skip; the CPU tests fake the graph where they need one.
"""

import contextlib
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from smmdax_torch import tracing
from smmdax_torch import train as ttrain
from smmdax_torch.checkpoint import load_state_dict, state_dict
from smmdax_torch.configs import Config

DEV_CPU = torch.device("cpu")


def flagship_cfg(**kw) -> Config:
    """``exp/cifar10_sn_smmd_resnet.sh``'s step (sn-smmd, rq, SN ResNet,
    bf16, hutchinson sigma, EMA, 5 + 1) at small widths."""
    base = dict(dataset="cifar10", architecture="resnet", model="sn-smmd", kernel="rq",
                rq_alphas=(0.2, 0.5, 1.0, 2.0, 5.0), batch_size=16, real_batch_size=16,
                output_size=32, c_dim=3, gf_dim=16, df_dim=16, z_dim=32, dof_dim=16,
                learning_rate=1e-4, beta1=0.5, beta2=0.9, dsteps=5, gsteps=1,
                scaling_coeff=10.0, sn_iters=1, compute_dtype="bfloat16",
                scaling_grad_estimator="hutchinson", ema_decay=0.9999)
    base.update(kw)
    return Config(**base)


def batches(cfg: Config, n: int, seed: int = 0) -> np.ndarray:
    """``n`` macro-steps' uint8 batches, (n, dsteps + gsteps, B, H, W, C)."""
    rng = np.random.default_rng(seed)
    shape = (n, cfg.dsteps + cfg.gsteps, cfg.real_batch_size) + cfg.image_shape
    return rng.integers(0, 256, shape, dtype=np.uint8)


def parent_adam_div(tensors, decay: float, count: int):
    """The division of the moments as the step made it before the table:
    by the host float ``_bias_correction``."""
    return torch._foreach_div(tensors, ttrain._bias_correction(decay, count))


@pytest.fixture
def counting():
    tracing.drain()
    tracing.enable(spans=False)
    yield
    tracing.disable()
    tracing.drain()


# -- the Adam table and the device count (CPU) ------------------------------


@pytest.mark.parametrize("count", [1, 2, 500, 150_000])
@pytest.mark.parametrize("b1,b2", [(0.5, 0.9), (0.9, 0.999)])
def test_adam_table_at_the_device_count_is_bias_correction(count, b1, b2):
    """The CPU table's row read at a device count holds the host floats
    bit for bit (150,000 lies past the table's end: its last row)."""
    table = ttrain._adam_table(b1, b2, DEV_CPU)
    row = ttrain._adam_row(table, torch.tensor(count))
    assert row.dtype == torch.float32
    assert float(row[0]) == ttrain._bias_correction(b1, count)
    assert float(row[1]) == ttrain._bias_correction(b2, count)


def test_adam_table_is_made_once_and_ends_saturated():
    """One table per (b1, b2, device), never moved: it ends at 0.999's
    first saturated count (~20.8k), and every count, before its end and
    far past it, reads the host floats."""
    b1, b2 = 0.5, 0.999
    table = ttrain._adam_table(b1, b2, DEV_CPU)
    assert ttrain._adam_table(b1, b2, DEV_CPU) is table
    n = table.shape[0]
    assert 20_000 < n < 21_000 and table[-1].tolist() == [1.0, 1.0]
    assert np.float32(b2) ** np.float32(n - 1) < 2 ** -30 <= np.float32(b2) ** np.float32(n - 2)
    counts = np.r_[1:3000, n - 3:n + 3, 40_000, 750_000]
    for decay, col in ((b1, 0), (b2, 1)):
        want = np.array([ttrain._bias_correction(decay, int(c)) for c in counts], np.float32)
        np.testing.assert_array_equal(table[np.minimum(counts, n - 1), col].numpy(), want)
        assert float(ttrain._adam_row(table, torch.tensor(2 ** 40))[col]) == 1.0


@pytest.mark.parametrize("decay", [1.0, -0.1, float("nan")])
def test_adam_table_refuses_a_decay_outside_0_1(decay):
    with pytest.raises(ValueError, match="decay"):
        ttrain._bias_corrections(decay)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_adam_update_equals_host_float_division(device):
    """The moments' division at the device count equals the division by
    the host float on both devices (the card multiplies by the float32
    reciprocal there), bit for bit, so eager updates did not change."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    moments = [torch.randn(n, generator=gen).to(dev) for n in (1, 7, 1000, 65_536 * 3)]
    b1, b2 = 0.5, 0.999
    table = ttrain._adam_table(b1, b2, dev)
    unbias = torch._foreach_mul if dev.type == "cuda" else torch._foreach_div
    for count in (1, 2, 3, 17, 500, 4999, 30_000):
        row = ttrain._adam_row(table, torch.tensor(count, device=dev))
        for col, decay in ((0, b1), (1, b2)):
            got = unbias(moments, row[col])
            want = parent_adam_div(moments, decay, count)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (count, decay)


def test_adam_states_carry_the_device_count():
    cfg = flagship_cfg(gf_dim=8, df_dim=8, batch_size=4, real_batch_size=4, dsteps=1,
                       compute_dtype="float32")
    state = ttrain.create_state(cfg, seed=1, device="cpu")
    for opt in (state.d_opt, state.g_opt):          # fresh
        assert opt.device_count.dtype == torch.int64 and opt.device_count.dim() == 0
        assert int(opt.device_count) == opt.count == 0
    step = ttrain.build_train_step(cfg, 1, 1)
    for real in batches(cfg, 2):
        state, _ = step(state, real)
    assert int(state.d_opt.device_count) == state.d_opt.count == 2
    loaded = load_state_dict(ttrain.create_state(cfg, seed=2, device="cpu"), state_dict(state))
    for opt in (loaded.d_opt, loaded.g_opt):        # loaded
        assert int(opt.device_count) == opt.count == 2
    built = ttrain.AdamState(count=7, mu={}, nu={})   # built by hand
    assert int(built.device_count) == 7 and built.device_count.device == DEV_CPU
    assert int(copy.deepcopy(loaded.g_opt).device_count) == 2


# -- the cache key (CPU) ------------------------------------------------------


@pytest.fixture
def small():
    cfg = flagship_cfg(gf_dim=8, df_dim=8, batch_size=4, real_batch_size=4, dsteps=1,
                       compute_dtype="float32")
    state = ttrain.create_state(cfg, seed=3, device="cpu")
    real = torch.as_tensor(batches(cfg, 1)[0])
    return cfg, state, real


def test_graph_key_follows_what_a_capture_binds(small):
    cfg, state, real = small

    def key(st, r=real):
        return ttrain._graph_key(cfg, 1, 1, st, r)

    before = key(state)
    # in-place updates keep it: two eager macro-steps, an lr decayed in place
    step = ttrain.build_train_step(cfg, 1, 1)
    for _ in range(2):
        state, _ = step(state, real)
    state.lr_d.mul_(0.5)
    assert key(state) == before
    # a rebound learning rate (the trainer's decay), another state, another
    # generator, loaded Adam moments, another batch shape: another key
    lr = state.lr_d
    state.lr_d = state.lr_d * 0.5
    assert key(state) != before
    state.lr_d = lr
    assert key(state) == before
    twin = load_state_dict(ttrain.create_state(cfg, seed=3, device="cpu"), state_dict(state))
    assert key(twin) != before
    gen = state.generator
    state.generator = torch.Generator().manual_seed(0)
    assert key(state) != before
    state.generator = gen
    opt = state.d_opt
    state.d_opt = ttrain.AdamState(opt.count, dict(opt.mu), {n: v.clone() for n, v in opt.nu.items()})
    assert key(state) != before
    state.d_opt = opt
    assert key(state, real[:, :2]) != before
    assert key(state) == before


def test_graph_key_does_not_follow_the_counts(small):
    """The Adam table never moves, so no count, however far, changes the
    key: a capture replays at every count."""
    cfg, state, real = small
    before = ttrain._graph_key(cfg, 1, 1, state, real)
    state.d_opt.count = state.g_opt.count = 10 ** 6
    state.d_opt.device_count.fill_(10 ** 6)
    assert ttrain._graph_key(cfg, 1, 1, state, real) == before


# -- counters and the capture's course, the graph faked (CPU) ---------------


class FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: a replay does nothing."""

    made = []

    def __init__(self):
        self.replays, self.generators = 0, []
        FakeGraph.made.append(self)

    def register_generator_state(self, generator):
        self.generators.append(generator)

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA calls of the graph path replaced: capture runs its block
    eagerly, streams are no-ops."""
    class Stream:
        def wait_stream(self, other):
            pass

    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(ttrain, "_capture_stream", lambda dev: Stream())
    return FakeGraph


def test_replays_add_the_counts_their_capture_recorded(fake_cuda, counting):
    """A capture's host calls count into the entry, not the counters; each
    replay adds them (the MMD launch counters count what runs)."""
    launches = {"mmd.pair_sum.launches": 18, "mmd.pair_sum_grad_a.launches": 17}

    def step(state, real):
        for name, n in launches.items():
            tracing.count(name, n)
        return state, {"g_loss": real.float().sum()}

    entry = ttrain._Graphed(("key",), torch.Generator())
    state = type("S", (), {"device": DEV_CPU, "generator": entry.generator})()
    entry.capture(step, state, torch.ones(3))
    assert entry.counts == launches
    assert tracing.counters() == {"train.graph.captures": 1}
    for i in range(1, 4):
        entry.replay(torch.full((3,), float(i)))
        got = tracing.counters()
        assert got["mmd.pair_sum.launches"] == 18 * i
        assert got["mmd.pair_sum_grad_a.launches"] == 17 * i
        assert got["train.graph.replays"] == i
    assert torch.equal(entry.real, torch.full((3,), 3.0))
    assert fake_cuda.made[0].replays == 3 and fake_cuda.made[0].generators == [entry.generator]


def test_recording_keeps_counts_off_the_counters(counting):
    into = {}
    with tracing.recording(into):
        tracing.count("mmd.pair_sum.launches", 2)
    tracing.count("mmd.pair_sum.launches")
    assert into == {"mmd.pair_sum.launches": 2}
    assert tracing.counters() == {"mmd.pair_sum.launches": 1}
    tracing.disable()
    with tracing.recording(into):                   # counters off: still recorded
        tracing.count("mmd.pair_sum.launches")
    assert into == {"mmd.pair_sum.launches": 3} and not tracing.counting()


@pytest.mark.parametrize("spans,profiler,want", [(False, False, False), (True, False, False),
                                                 (False, True, False), (True, True, True)])
def test_profiled_means_spans_on_under_a_recording_profiler(spans, profiler, want):
    """The graph stands aside only where a caller asks which phase
    launched each kernel: program spans on and a profiler recording."""
    from torch.profiler import ProfilerActivity, profile
    if spans:
        tracing.enable()
    try:
        ctx = profile(activities=[ProfilerActivity.CPU]) if profiler else contextlib.nullcontext()
        with ctx:
            assert ttrain._profiled() is want
    finally:
        tracing.disable()
        tracing.drain()


def test_a_key_warms_up_captures_then_replays(fake_cuda, counting, small):
    """The capture's course: a new key runs eagerly, its next call
    captures and replays, later calls replay; a rebound learning rate or
    another build recaptures and drops the capture it replaces; host
    counts move one macro-step a call in every mode; each state holds its
    own capture, which goes with the state."""
    cfg, state, real = small
    inner = ttrain.build_train_step(cfg, 1, 1)
    graphs_at_call = []

    def step(st, r, noise=None):
        graphs_at_call.append(len(FakeGraph.made))
        return inner(st, r, noise)

    run = ttrain._graphed(cfg, 1, 1, step)
    static = []
    for i in range(4):
        state, _, s = run(state, real)
        static.append(s)
        assert state.step == i + 1 and state.d_opt.count == state.g_opt.count == i + 1
    # eager (no graph yet), the capture (under graph 1), two replays
    assert graphs_at_call == [0, 1] and static == [False, True, True, True]
    assert FakeGraph.made[0].replays == 3 and tracing.counters()["train.graph.replays"] == 3
    first = weakref.ref(state.graph)
    state.lr_d = state.lr_d * 0.5
    for _ in range(3):
        state, _, _ = run(state, real)
    assert graphs_at_call == [0, 1, 1, 2] and state.step == 7
    gc.collect()
    assert first() is None and state.graph.graph is FakeGraph.made[1]
    assert tracing.counters()["train.graph.captures"] == 2
    # another build of the same state (the trainer's warm-up dsteps end)
    # takes the state's capture over
    run2 = ttrain._graphed(cfg, 2, 1, ttrain.build_train_step(cfg, 2, 1))
    state, _, s = run2(state, torch.cat([real[:1], real]))
    assert not s and state.graph.key[0] == (cfg, 2, 1) and state.graph.graph is None
    # each state holds its own capture, and a dropped state's goes with it
    other = ttrain.create_state(cfg, seed=4, device="cpu")
    for _ in range(2):
        other, _, _ = run(other, real)
    assert other.graph.graph is FakeGraph.made[2] and other.graph is not state.graph
    held = weakref.ref(other.graph)
    del other
    gc.collect()
    assert held() is None


# -- on the card --------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_same(a, b):
    """Every tensor of two states, their steps, counts and generators,
    bit for bit."""
    sa, sb = state_dict(a), state_dict(b)
    assert sa.pop("step") == sb.pop("step")
    for key in ("g_opt", "d_opt"):
        assert sa[key]["count"] == sb[key]["count"]
    for key in ("generator", "gen", "disc", "g_opt", "d_opt", "lr_g", "lr_d", "g_params_ema",
                "g_stats_ema"):
        _walk(sa[key], sb[key], key)
    for st in (a, b):
        for opt in (st.d_opt, st.g_opt):
            assert int(opt.device_count) == opt.count


def _walk(x, y, where):
    if isinstance(x, dict):
        assert set(x) == set(y), where
        for k in x:
            _walk(x[k], y[k], f"{where}.{k}")
    elif isinstance(x, torch.Tensor):
        assert torch.equal(x, y), where
    else:
        assert x == y, where


def _eager(cfg, state, reals):
    step = ttrain.build_train_step(cfg, cfg.dsteps, cfg.gsteps)
    out = []
    for real in reals:
        state, m = step(state, real)
        out.append({k: v.clone() for k, v in m.items()})
    return state, out


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_graphed_macro_steps_equal_eager_ones(counting, remat):
    """Three macro-steps, dispatches of one (eager, capture, replay),
    against three eager ones: every state tensor, the noise generator's
    state and the metrics bit for bit; the MMD launch counters count what
    ran."""
    dev = _cuda()
    cfg = flagship_cfg(remat=remat)
    reals = batches(cfg, 3)
    want, want_m = _eager(cfg, ttrain.create_state(cfg, seed=5, device=dev), reals)
    mmd_eager = tracing.counters()
    tracing.drain()
    state = ttrain.create_state(cfg, seed=5, device=dev)
    single = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1)
    got_m = []
    for real in reals:
        state, m = single(state, real)
        got_m.append(m)
    _assert_same(state, want)
    assert all(torch.equal(g[k], w[k]) for g, w in zip(got_m, want_m) for k in w)
    counters = tracing.counters()
    assert counters["train.graph.captures"] == 1 and counters["train.graph.replays"] == 2
    assert {k: v for k, v in counters.items() if k.startswith("mmd.")} == mmd_eager


@pytest.mark.cuda
def test_dispatch_of_four_equals_four_dispatches_of_one(counting):
    """K = 4 (eager, capture, replay, replay; then four replays) with K = 1
    calls between, against eager macro-steps; metrics already returned
    stay as they were."""
    dev = _cuda()
    cfg = flagship_cfg()
    reals = batches(cfg, 10, seed=1)
    want, want_m = _eager(cfg, ttrain.create_state(cfg, seed=6, device=dev), reals)
    state = ttrain.create_state(cfg, seed=6, device=dev)
    multi = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 4)
    single = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1)
    state, m4 = multi(state, reals[0:4])
    state, m5 = single(state, reals[4])
    state, m6 = single(state, reals[5])
    state, m10 = multi(state, reals[6:10])
    _assert_same(state, want)
    for got, i in ((m4, 3), (m5, 4), (m6, 5), (m10, 9)):
        assert all(torch.equal(got[k], want_m[i][k]) for k in got), i
    assert tracing.counters()["train.graph.replays"] == 9


@pytest.mark.cuda
def test_a_rebound_learning_rate_recaptures(counting):
    """The trainer's decay rebinds ``lr_d`` / ``lr_g``: the next
    macro-steps run at the new rates, as eager ones do."""
    dev = _cuda()
    cfg = flagship_cfg()
    reals = batches(cfg, 6, seed=2)
    single = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1)
    eager = ttrain.build_train_step(cfg, cfg.dsteps, cfg.gsteps)
    got = ttrain.create_state(cfg, seed=7, device=dev)
    want = ttrain.create_state(cfg, seed=7, device=dev)
    for i, real in enumerate(reals):
        if i == 3:
            for st in (got, want):
                st.lr_d, st.lr_g = st.lr_d * 0.8, st.lr_g * 0.8
        got, m = single(got, real)
        want, _ = eager(want, real)
        assert float(m["lr_d"]) == float(want.lr_d)
    _assert_same(got, want)
    assert tracing.counters()["train.graph.captures"] == 2


@pytest.mark.cuda
def test_a_checkpoint_saved_after_replays_resumes_exactly(counting):
    """Six graphed macro-steps against three, a checkpoint, and three more
    from it in a new state: the same state, and the noise generator's
    state after the replays equals that after as many eager macro-steps."""
    dev = _cuda()
    cfg = flagship_cfg()
    reals = batches(cfg, 6, seed=3)
    single = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1)
    whole = ttrain.create_state(cfg, seed=8, device=dev)
    for real in reals:
        whole, _ = single(whole, real)
    half = ttrain.create_state(cfg, seed=8, device=dev)
    for real in reals[:3]:
        half, _ = single(half, real)
    eager, _ = _eager(cfg, ttrain.create_state(cfg, seed=8, device=dev), reals[:3])
    assert torch.equal(half.generator.get_state(), eager.generator.get_state())
    saved = state_dict(half)
    del half
    resumed = load_state_dict(ttrain.create_state(cfg, seed=9, device=dev), saved)
    for real in reals[3:]:
        resumed, _ = single(resumed, real)
    _assert_same(resumed, whole)


@pytest.mark.cuda
def test_a_profiled_macro_step_runs_eagerly_and_keeps_the_capture(counting):
    """With program spans on under the profiler, a dispatch runs its
    macro-step eagerly: the benchmark's attribution
    (``benchmark.program_trace.attribute``) credits its kernels to the
    phases an eager step's go to, launch for launch; the capture stays, the
    next macro-step replays it, and the state equals eager steps'."""
    from benchmark.program_trace import attribute, events_of
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    cfg = flagship_cfg()
    reals = batches(cfg, 4, seed=4)
    eager = ttrain.build_train_step(cfg, cfg.dsteps, cfg.gsteps)
    single = ttrain.dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1)
    a = ttrain.create_state(cfg, seed=10, device=dev)
    b = ttrain.create_state(cfg, seed=10, device=dev)
    for real in reals[:2]:                  # b: eager, then the capture
        a, _ = eager(a, real)
        b, _ = single(b, real)
    graph = b.graph.graph

    def profiled(fn):
        tracing.enable()
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        finally:
            tracing.disable()
            tracing.enable(spans=False)
        return attribute(events_of(prof), set(tracing.SPANS))["spans"]

    want = profiled(lambda: eager(a, reals[2]))
    replays = tracing.counters()["train.graph.replays"]
    got = profiled(lambda: single(b, reals[2]))
    assert tracing.counters()["train.graph.replays"] == replays
    for name in ("nn.spectral", "train.sn_refresh", "train.d_loss", "losses.sigma",
                 "train.d_grad", "train.d_generate", "train.g_loss", "train.g_grad"):
        assert got[name]["count"] == want[name]["count"], name
        assert got[name]["launches_in"] == want[name]["launches_in"] > 0, name
    a, _ = eager(a, reals[3])
    b, _ = single(b, reals[3])
    assert b.graph.graph is graph and tracing.counters()["train.graph.replays"] == replays + 1
    assert tracing.counters()["train.graph.captures"] == 1
    _assert_same(b, a)
