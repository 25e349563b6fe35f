"""The ``train4`` cell, whose cards belong to rank processes, rehearsed on
the CPU: four gloo ranks at tiny shapes (64 px, gf/df 8, 2 rows a rank)
through ``benchmark.ranks`` and ``train4_cell``, the plain reference of
the data-parallel step (``reference/gan_dp.py``) against the port's
shard_map step, faults planted in the ranks, a failing rank, and the
control.  The command itself never runs without four cards."""

import time

import pytest
import torch

from benchmark import common, ranks, run, train4_cell, train_check as tc
from benchmark.feed import images
from benchmark.reference import gan, gan_dp
from benchmark.tests._tiny import TRAIN4_CELL, threads, train4_config

SEED = 2_147_483_659 * 7
SEEDS = (17, 2**33 + 5, 2**40 + 3)


def _ctx(config, hook=None, trace=False):
    return {"config": config, "traffic": common.load_traffic("train4"), "seed": SEED,
            "seconds": 0.5, "trace": trace, "device": "cpu", "chips": 4, "peaks": None,
            "t0": time.perf_counter(), "rank_hook": hook}


def _correct(out) -> bool:
    return all(v["value"] <= v["limit"] for v in out["checks"].values())


@pytest.fixture(scope="module")
def rehearsal():
    with threads():
        return run.drive(TRAIN4_CELL, SEED, 0.5, False, device="cpu", config=train4_config())


def test_rehearsal_is_correct(rehearsal):
    r = rehearsal["result"]
    assert set(r) == {"correct", "attempted", "failed", "metrics", "device"}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 2
    # the card's memory peak is the other end-to-end metric, and a CPU has none
    assert {m["name"] for m in common.cell_metrics(common.benchmark_file(), TRAIN4_CELL, False)} \
        == {"memory_peak_bytes", "setup_s"}
    assert set(r["metrics"]) == {"setup_s"}
    assert r["device"]["platform"] == "cpu"
    assert set(rehearsal["checks"]) == {"first_loss_gap", "grad_gap", "change_gap", "dispatch_gap",
                                        "rank_gap", "block_gap"}
    assert rehearsal["checks"]["block_gap"]["value"] == 0


def test_reference_follows_the_ports_shard_map_step():
    """In float32 the reference of the data-parallel step reads the port's
    first macro-step on four gloo ranks (its losses and the gradients Adam
    holds after it) to float32 rounding, and the ranks stay equal bit for
    bit."""
    ctx = _ctx(train4_config())
    ctx["traffic"] = dict(ctx["traffic"], check_steps=1)
    with threads():
        checks = {k: v["value"] for k, v in train4_cell.run(ctx)["checks"].items()}
    assert checks["first_loss_gap"] <= 1e-5 and checks["grad_gap"] <= 1e-5
    assert checks["dispatch_gap"] == 0 and checks["rank_gap"] == 0 and checks["block_gap"] == 0


# -- faults planted in the ranks (top-level functions: spawn imports them) --


def _rank1_fed_rank0(axis):
    """Rank 1's feed builds rank 0's block of every batch: the
    calibration's plant, left in place for the rank's life."""
    from benchmark import calibrate
    calibrate.rank1_fed_rank0()


def _half_batch(axis):
    """Every rank's step leaves half of its block out, its means over the
    rest (the feed's blocks stay sound)."""
    import smmdax_torch.train as train
    from benchmark.tests import test_harness_rehearsal as one_card
    train.dispatch_train_step = one_card._half_batch(train.dispatch_train_step)


def _unchanged(axis):
    """Every rank's step returns its state unchanged (the losses computed)."""
    import smmdax_torch.train as train
    from benchmark.tests import test_harness_rehearsal as one_card
    train.dispatch_train_step = one_card._unchanged(train.dispatch_train_step)


def _gradients_not_averaged(axis):
    """The ranks' gradients left un-averaged (the BN averages still are)."""
    import smmdax_torch.train as train
    real = train._pmean_
    train._pmean_ = lambda tensors, ax: None if isinstance(tensors, tuple) else real(tensors, ax)


@pytest.mark.parametrize("config,hook,trace", [
    ({"global_batch_mmd": False}, None, False),
    ({}, _rank1_fed_rank0, True),
    ({}, _gradients_not_averaged, False),
    ({}, _half_batch, False),
    ({}, _unchanged, False),
], ids=["own_mmd", "rank1_fed_rank0_traced", "gradients_not_averaged", "half_batch",
        "unchanged"])
def test_faults_are_caught(config, hook, trace):
    with threads():
        out = train4_cell.run(_ctx(train4_config(**config), hook, trace))
    assert not _correct(out)
    if hook is _gradients_not_averaged:
        assert out["checks"]["rank_gap"]["value"] > 0
    if hook is _rank1_fed_rank0:
        assert out["checks"]["block_gap"]["value"] > 0


def _fails_on_rank_2(axis):
    if axis.index == 2:
        raise RuntimeError("planted failure on rank 2")


def test_a_failing_rank_ends_the_command():
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e, threads():
        ranks.run(train4_cell.rank_main, 4, "cpu", (_ctx(train4_config(), _fails_on_rank_2),))
    assert "planted failure on rank 2" in str(e.value.code)
    assert "rank 2 of 4 failed first" in str(e.value.code)
    assert time.perf_counter() - t0 < 60


def test_a_kind_without_its_cell_module_is_refused(monkeypatch):
    assert common.has_cell_module("train4") and not common.has_cell_module("train9")
    monkeypatch.setattr(common, "load_traffic", lambda name: {"kind": "train9"})
    with pytest.raises(SystemExit) as e:
        run.drive(TRAIN4_CELL, SEED, 0.5, False, device="cpu", config=train4_config())
    assert "unknown kind 'train9'" in str(e.value.code)


# -- the control: the reference in the program's place, float8 products --


def _control(c, seed, dev):
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    ref = tc.reference_readings(c, seed, data, 3, dev, model=gan_dp)
    ctl = tc.reference_readings(c, seed, data, 3, dev, cast=gan.to_fp8_scaled, model=gan_dp)
    return tc.compare(ctl, ref)


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits if k in numbers)


def test_control_fails_on_the_cpu():
    with threads():
        c = train4_config(compute_dtype="bfloat16")
        assert _fails(_control(c, SEEDS[0], torch.device("cpu")), c["limits"]["train4"])


@pytest.mark.cuda
def test_control_fails_on_a_card():
    """At the cell's own size on one card, as ``python3 -m
    benchmark.calibrate`` reads it on four."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    c = common.load_config("imagenet64_sn_smmd_multichip")
    for seed in SEEDS:
        assert _fails(_control(c, seed, torch.device("cuda")), c["limits"]["train4"]), seed
