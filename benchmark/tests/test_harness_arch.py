"""The reference's networks by architecture (``benchmark/reference/arch``):
every configuration finds its file, every file keeps the contract of
``arch/__init__.py``, and what the reference cannot follow is refused."""

import inspect
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import common, run
from benchmark.reference import gan, gan_dp
from benchmark.reference.arch import dcgan
from benchmark.tests._tiny import TRAIN_CELL, threads, train4_config, train_config

ARCH_FILES = sorted(f[:-3] for f in os.listdir(gan.ARCH_DIR)
                    if f.endswith(".py") and f != "__init__.py")
CONTRACT = {"init_weights": ["c", "seed"],
            "generator": ["c", "p", "z", "train", "cast", "update"],
            "critic": ["c", "p", "x", "cast", "new_u"]}


@pytest.fixture(autouse=True)
def _few_threads():
    with threads():
        yield


@pytest.mark.parametrize("entry", common.benchmark_file()["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_its_networks(entry):
    name = common.load_config(entry["name"])["architecture"]
    assert name in ARCH_FILES
    assert gan.arch({"architecture": name}).__name__ == f"benchmark.reference.arch.{name}"


@pytest.mark.parametrize("name", ARCH_FILES)
def test_every_network_file_keeps_the_contract(name):
    mod = gan.arch({"architecture": name})
    for fn, params in CONTRACT.items():
        assert list(inspect.signature(getattr(mod, fn)).parameters) == params, (name, fn)
    c = train_config(architecture=name)
    gp, dp = mod.init_weights(c, 5)
    z = torch.rand((3, c["z_dim"]), generator=torch.Generator().manual_seed(1)) * 2 - 1
    update, new_u = {}, {}
    with torch.no_grad():
        x = mod.generator(c, gp, z, True, None, update)
        f = mod.critic(c, dp, x, None, new_u)
    assert x.shape == (3, c["output_size"], c["output_size"], c["c_dim"])
    assert x.dtype == torch.float32 and float(x.abs().max()) <= 1.0
    assert f.shape == (3, c["dof_dim"]) and f.dtype == torch.float32
    # the BN running averages and spectral-norm vectors named as the weights' buffers
    assert set(update) == {k for k in gp if k.endswith((".mean", ".var"))}
    assert set(new_u) == {k for k in dp if k.endswith(".u")} != set()


def test_dcgan_transposed_convolution_is_flaxs():
    """``dcgan.deconv`` against its definition: the input dilated by 2 and
    padded by 2, correlated with the HWIO kernel unflipped, where the
    port's (in, out, 4, 4) weight holds that kernel flipped in H and W."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 4, 6), generator=g)
    p = {"d.weight": torch.randn((5, 7, 4, 4), generator=g), "d.bias": torch.randn(7, generator=g)}
    hwio = p["d.weight"].flip(2, 3).permute(2, 3, 0, 1)
    dilated = torch.zeros((2, 5, 7, 11))
    dilated[:, :, ::2, ::2] = x
    want = F.conv2d(F.pad(dilated, (2, 2, 2, 2)), hwio.permute(3, 2, 0, 1)) + p["d.bias"][:, None,
                                                                                           None]
    got = dcgan.deconv(p, "d", x, None)
    assert got.shape == (2, 7, 8, 12)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


# -- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["nonesuch", "../gan", "__init__"])
def test_an_architecture_without_networks_is_refused(name):
    c = train_config(architecture=name)
    with pytest.raises(ValueError, match=f"benchmark/reference/arch/{name}.py"):
        gan.init_weights(c, 0)
    with pytest.raises(SystemExit, match="has no plain reference networks"):
        run.drive(TRAIN_CELL, 1, 0.5, False, device="cpu", config=c)


REFUSED = [{"scaling_grad_estimator": "exact"}, {"kernel": "gaussian"}, {"model": "smmd"},
           {"gradient_penalty": 1.0}, {"scaling_variant": "value_and_grad"}]


@pytest.mark.parametrize("change", REFUSED, ids=lambda d: "-".join(map(str, *d.items())))
def test_an_objective_the_step_does_not_implement_is_refused(change):
    key = next(iter(change))
    c = train_config(**change)
    st = gan.State(c, 0, "cpu")
    real = torch.zeros((c["dsteps"] + c["gsteps"], 8, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match=f"implements {key} "):
        gan.macro_step(c, st, real, c["dsteps"], c["gsteps"], None)
    with pytest.raises(SystemExit, match=f"implements {key} "):
        run.drive(TRAIN_CELL, 1, 0.5, False, device="cpu", config=c)


def test_the_data_parallel_step_refuses_it_too():
    c = train4_config(scaling_grad_estimator="exact")
    st = gan_dp.State(c, 0, "cpu")
    real = torch.zeros((c["dsteps"] + c["gsteps"], 8, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="implements scaling_grad_estimator "):
        gan_dp.macro_step(c, st, real, c["dsteps"], c["gsteps"], None)


def test_the_cells_objectives_are_the_steps():
    for entry in common.benchmark_file()["configs"]:
        gan.check_objective(common.load_config(entry["name"]))
