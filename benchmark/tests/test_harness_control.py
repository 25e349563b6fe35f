"""The control of each cell has to come out as not correct: the
reference put in the program's place one precision below what the
configuration states (``benchmark.calibrate``).  On the CPU at tiny
shapes; on a card (marked ``cuda``) at the cell's own size on three
seeds, as ``python3 -m benchmark.calibrate`` reads it."""

import os

import pytest
import torch

from benchmark import calibrate, common, score_cell, score_check, train_check as tc
from benchmark.feed import images
from benchmark.reference import gan
from benchmark.tests._tiny import score_config, threads, train_config

SEEDS = (17, 2**33 + 5, 2**40 + 3)


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


def _train_control(c, seed, dev):
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    ref = tc.reference_readings(c, seed, data, 3, dev)
    ctl = tc.reference_readings(c, seed, data, 3, dev, cast=gan.to_fp8_scaled)
    return tc.compare(ctl, ref)


def _score_control(c, seed, dev):
    t = common.load_traffic("score")
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    path = score_cell.weights_path()
    score_cell.write_inception_weights(path, seed, dev)
    try:
        readings = calibrate.control_event(c, t, seed, data, path, dev)
        return score_check.compare(c, t, seed, data, readings, path, dev)
    finally:
        os.remove(path)


def test_train_control_fails_on_the_cpu():
    with threads():
        c = train_config(compute_dtype="bfloat16")
        assert _fails(_train_control(c, SEEDS[0], torch.device("cpu")), c["limits"]["train"])


def test_score_control_fails_on_the_cpu():
    with threads():
        c = score_config()
        assert _fails(_score_control(c, SEEDS[0], torch.device("cpu")), c["limits"]["score"])


CELLS = [(w["name"], w["config"], w["traffic"]) for w in common.benchmark_file()["workloads"]
         if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config,traffic", CELLS, ids=[c[0] for c in CELLS])
def test_control_fails_on_the_card(cell, config, traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card")
    c, t = common.load_config(config), common.load_traffic(traffic)
    run = _score_control if t["kind"] == "score" else _train_control
    for seed in SEEDS:
        assert _fails(run(c, seed, torch.device("cuda")), c["limits"][t["kind"]]), seed
