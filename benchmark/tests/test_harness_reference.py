"""The plain reference against the port at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import common, train_check as tc
from benchmark.feed import images
from benchmark.reference import gan
from benchmark.reference import inception as ri
from benchmark.tests._tiny import score_config, threads, train_config

SEED = 3_000_000_123


@pytest.fixture(autouse=True)
def _few_threads():
    with threads():
        yield


def _port_state(c):
    from smmdax_torch.train import create_state
    return create_state(common.port_config(c, SEED), seed=SEED, device="cpu")


ARCHITECTURES = ["resnet", "dcgan"]


@pytest.mark.parametrize("architecture", ARCHITECTURES)
def test_initial_weights_are_the_ports(architecture):
    c = train_config(architecture=architecture)
    st = _port_state(c)
    gp, dp = gan.init_weights(c, SEED)
    for module, ref in ((st.gen, gp), (st.disc, dp)):
        port = {**dict(module.named_parameters()), **dict(module.named_buffers())}
        assert set(port) == set(ref)
        for k in ref:
            assert torch.equal(port[k].detach(), ref[k]), k


@pytest.mark.parametrize("architecture", ARCHITECTURES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_macro_step_follows_the_port(dtype, architecture):
    """The port's first macro-step (a dispatch of one) against the
    reference: the losses and the Adam moments.  float32 to 1e-5 (float32
    summation order); bfloat16 to its rounding."""
    from smmdax_torch.data.pipeline import ArraySource, macro_batch_at
    from smmdax_torch.train import dispatch_train_step
    c = train_config(compute_dtype=dtype, architecture=architecture)
    cfg = common.port_config(c, SEED)
    st = _port_state(c)
    data = images(SEED, c["dataset_images"], 32)
    per = c["dsteps"] + c["gsteps"]
    step = dispatch_train_step(cfg, c["dsteps"], c["gsteps"], steps_per_dispatch=1)
    st, m = step(st, macro_batch_at(ArraySource(data, seed=SEED), 0, per, 8, u8=True))
    ref = tc.reference_readings(c, SEED, data, 1, "cpu",
                                cast=None if dtype == "float32" else gan.to_bf16)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for key in tc.LOSS_KEYS:
        assert abs(float(m[key]) - ref.losses[0][key]) <= tol * abs(ref.losses[0][key])
    numbers = tc.compare(_readings(st, m, c), ref)
    assert numbers["loss_gap"] <= tol
    assert numbers["grad_gap"] <= (1e-4 if dtype == "float32" else 2e-2)


def _readings(st, m, c):
    r = tc.Readings()
    r.losses = [{key: float(m[key]) for key in tc.LOSS_KEYS}]
    r.grads = tc.program_grads(st, c["beta1"])
    return r


def test_real_batches_are_the_feeds():
    from smmdax_torch.data.pipeline import ArraySource, macro_batch_at
    data = images(SEED, 100, 32)
    src = ArraySource(data, seed=SEED)
    for step in (0, 7):
        assert np.array_equal(gan.real_batches(data, SEED, step, 6, 8),
                              macro_batch_at(src, step, 6, 8, u8=True))


def test_eval_generator_is_the_ports_sample():
    from smmdax_torch.train import sample
    c = score_config()
    st = _port_state(c)
    cfg = common.port_config(c, SEED)
    got = sample(cfg, st, torch.Generator().manual_seed(5), 16)
    gp, _ = gan.init_weights(c, SEED)
    g = torch.Generator().manual_seed(5)
    zs = [torch.rand((8, c["z_dim"]), generator=g) * 2.0 - 1.0 for _ in range(2)]
    with torch.no_grad():
        want = torch.cat([gan.generator(c, gp, z, False, gan.to_bf16) for z in zs])
    assert torch.equal(got, want)


def test_inception_is_the_ports(tmp_path):
    from smmdax_torch.eval import InceptionFeatures
    from benchmark.score_cell import write_inception_weights
    path = str(tmp_path / "w.npz")
    write_inception_weights(path, SEED, torch.device("cpu"))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    feats, probs = InceptionFeatures(path, device="cpu").features_and_probs(x, fetch=False)
    f, p = ri.features(ri.load(path, "cpu"), x)
    assert torch.allclose(f, feats, rtol=1e-4, atol=1e-5)
    assert torch.allclose(p, probs, rtol=1e-4, atol=1e-7)


def test_scores_are_the_ports():
    from smmdax_torch.eval import (frechet_distance, gaussian_stats, inception_score,
                                   kid_from_features)
    g = torch.Generator().manual_seed(2)
    real, fake = torch.randn((300, 16), generator=g), torch.randn((300, 16), generator=g) + 0.3
    probs = torch.softmax(torch.randn((300, 10), generator=g), 1)
    fid = frechet_distance(*gaussian_stats(real.numpy()), *gaussian_stats(fake.numpy()))
    assert abs(ri.fid(real, fake) - fid) <= 1e-9 * abs(fid) + 1e-9
    kid = kid_from_features(real.numpy(), fake.numpy(), subset_size=100, n_subsets=5)[0]
    assert abs(ri.kid(real, fake, 100, 5) - kid) <= 1e-9 * abs(kid) + 1e-12
    assert abs(ri.inception_score(probs) - inception_score(probs.numpy())[0]) < 1e-6


def test_moved_eval_generator_is_the_ports():
    """After the score cell's set-up steps the EMA differs from the live
    generator, and the reference's EMA samples are the port's."""
    from benchmark import score_cell, score_check
    from smmdax_torch.train import sample
    c = score_config(compute_dtype="float32")
    t = common.load_traffic("score")
    cfg = common.port_config(c, SEED)
    data = images(SEED, c["dataset_images"], 32)
    st = score_cell.moved_state(cfg, c, t, SEED, data, "cpu")
    got = sample(cfg, st, torch.Generator().manual_seed(5), 16)
    live = sample(cfg, st, torch.Generator().manual_seed(5), 16, use_ema=False)
    gp = score_check.eval_weights(c, t, SEED, data, "cpu")
    g = torch.Generator().manual_seed(5)
    zs = [torch.rand((8, c["z_dim"]), generator=g) * 2.0 - 1.0 for _ in range(2)]
    with torch.no_grad():
        want = torch.cat([gan.generator(c, gp, z, False, None) for z in zs])
    assert float((got - want).abs().max()) < 1e-5 < float((live - want).abs().max())
