"""The weights converter: port modules loaded from a JAX state hold
exactly the transformed arrays (HWIO -> OIHW, (in, out) -> (out, in),
BN/SN/bias as they are), and so do the optimizer and EMA state."""

import numpy as np
import pytest

from _torch_parity import configs, jax_state, port_state
from smmdax_torch import convert


@pytest.fixture(scope="module")
def states():
    jcfg, tcfg = configs(ema_decay=0.9)
    js = jax_state(jcfg)
    return js, port_state(tcfg, js)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _expected(path, arr):
    name = ".".join(path[:-1] + ("weight" if path[-1] == "kernel" else path[-1],))
    if path[-1] == "kernel":
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    return name, arr


@pytest.mark.parametrize("module,trees", [
    ("gen", ("g_params", "g_batch_stats")),
    ("disc", ("d_params", "d_spectral")),
])
def test_modules_hold_transformed_arrays(states, module, trees):
    js, ts = states
    sd = getattr(ts, module).state_dict()
    expected = {}
    for tree in trees:
        for path, arr in _leaves(getattr(js, tree)):
            name, want = _expected(path, arr)
            expected[name] = want
    assert set(expected) == set(sd)
    for name, want in expected.items():
        assert sd[name].shape == want.shape, name
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)


def test_conv_and_dense_layouts(states):
    js, ts = states
    k = np.asarray(js.d_params["block1"]["conv1"]["kernel"])     # HWIO
    w = ts.disc.block1.conv1.weight.detach().numpy()               # OIHW
    assert w[2, 1, 0, 2] == k[0, 2, 1, 2]
    k = np.asarray(js.g_params["project"]["kernel"])               # (in, out)
    w = ts.gen.project.weight.detach().numpy()                     # (out, in)
    assert w[5, 3] == k[3, 5]
    u = np.asarray(js.d_spectral["head"]["u"])
    assert ts.disc.head.u.shape == u.shape == (ts.disc.head.weight.shape[0],)


def test_optimizer_ema_and_scalars(states):
    js, ts = states
    for opt_j, opt_t in ((js.g_opt_state, ts.g_opt), (js.d_opt_state, ts.d_opt)):
        assert opt_t.count == int(opt_j.count) == int(opt_t.device_count)
        for tree, got in ((opt_j.mu, opt_t.mu), (opt_j.nu, opt_t.nu)):
            want = convert.flatten(tree)
            assert set(want) == set(got)
            for name in want:
                np.testing.assert_array_equal(got[name].numpy(), want[name])
    for tree, got in ((js.g_params_ema, ts.g_params_ema),
                      (js.g_stats_ema, ts.g_stats_ema)):
        want = convert.flatten(tree)
        assert set(want) == set(got)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name])
    assert float(ts.lr_g) == float(js.lr_g) and float(ts.lr_d) == float(js.lr_d)
    assert ts.step == int(js.step) and ts.sched_fails == int(js.sched_fails)
