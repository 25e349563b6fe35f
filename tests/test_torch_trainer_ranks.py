"""The trainer, the device pool and the launcher over ranks, on 2 gloo
ranks of the CPU (``tests/_torch_dist.py``, one group for the trainer
cases):

* only rank 0 writes: each rank runs in a working directory of its own
  with relative log, sample and checkpoint directories, and rank 1's
  stays empty;
* a shard_map run (per-rank noise streams) resumed from its mid-way
  checkpoint equals the straight run bit for bit, on both ranks;
* scores over 2 ranks, chunked and split unevenly, equal the one-device
  trainer's, scheduler decisions included (the features are gathered in
  the one-device order);
* a SIGTERM to rank 1 alone stops both ranks at the same step, saved;
* the sharded device pool is cut to a multiple of the ranks, each rank
  holding its slice, and K = 3 equals K = 1 (tests/test_device_data.py:
  257, 308);
* a rank's block of a host macro-batch is byte-identical to the global
  batch's rows;
* ``python -m smmdax_torch.main --device cpu --num_data_shards 2`` takes
  two macro-steps, restarts the whole group after the RSS watchdog's
  trip, and reports a failing rank's traceback;
* more shards than cards, or a multi-shard trainer without its ranks, is
  refused.
"""

import json
import os

import numpy as np
import pytest
import torch

import _torch_dist
from smmdax_torch import main as tmain
from smmdax_torch.configs import Config, config_from_args
from smmdax_torch.data.pipeline import ArraySource, macro_batch_at, materialize_u8
from smmdax_torch.data.synthetic import GaussianMix, SyntheticImages
from smmdax_torch.train import check_devices
from smmdax_torch.trainer import Trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 2
BASE = dict(dataset="synthetic", architecture="resnet", model="mmd", kernel="gaussian",
            output_size=16, gf_dim=8, df_dim=8, dof_dim=4, z_dim=8, batch_size=8,
            real_batch_size=8, dsteps=1, gsteps=1, warmup_iterations=0, max_iteration=4,
            log_every=2, sample_every=0, checkpoint_every=0, MMD_lr_scheduler=False,
            num_data_shards=N)
WRITES = dict(max_iteration=3, log_every=1, sample_every=2, checkpoint_every=2,
              compute_scores=True, score_every=3, no_of_samples=48, score_subset_size=16,
              score_subsets=2, checkpoint_dir="ck", sample_dir="s", log_dir="l")
RING = dict(use_ring_mmd=True, max_iteration=4)
# 300 samples in chunks of 160 (the chunk-size ceiling below): units of
# lcm(8, 256) rows give rank 0 the first chunk whole and rank 1 nothing
# of it, then 0 and 140 rows of the second
SCORES = dict(compute_scores=True, no_of_samples=300, score_subset_size=64,
              score_subsets=4, MMD_lr_scheduler=True, scheduler_patience=1,
              three_sample_test="pvalue", scheduler_test_size=64, scheduler_test_subsets=4)
CHUNK_BYTES = 160 * 16 * 16 * 3 * 4
SIGTERM = dict(max_iteration=6)
POOL = dict(data_placement="device", device_data_sharding="sharded", device_data_pool=37,
            max_iteration=3, log_every=0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_ranks"))
    payload = dict(base=BASE, root=root, cwd=os.path.join(root, "cwd"), writes=WRITES,
                   ring=RING, scores=SCORES, chunk_bytes=CHUNK_BYTES, sigterm=SIGTERM,
                   pool=POOL)
    return dict(root=root, out=_torch_dist.run(N, "trainer_suite", payload, root))


def _same_run(a, b):
    assert (a["step"], a["sched_fails"], a["counts"], a["lrs"]) == \
        (b["step"], b["sched_fails"], b["counts"], b["lrs"])
    np.testing.assert_array_equal(a["generator"], b["generator"])
    for part, arrays in a["arrays"].items():
        assert set(arrays) == set(b["arrays"][part])
        for name, v in arrays.items():
            np.testing.assert_array_equal(v, b["arrays"][part][name], err_msg=f"{part}.{name}")


def _same_arrays(a, b):
    _same_run(dict(a, generator=0), dict(b, generator=0))


def test_only_rank_zero_writes(ranks):
    r0, r1 = (r["writes"] for r in ranks["out"])
    assert r1["files"] == []
    run = Config(**{**BASE, **WRITES}).run_name()
    assert f"l/{run}.jsonl" in r0["files"]
    assert {f"ck/{run}/2.pt", f"ck/{run}/3.pt", f"s/{run}/sample_0000002.png"} <= set(r0["files"])
    with open(os.path.join(ranks["root"], "cwd", "rank0", "l", f"{run}.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "d_loss_mmd2" in r] == [1, 2, 3]
    assert [r["step"] for r in rows if "kid" in r] == [3]
    # GSPMD: both ranks draw rank 0's stream and hold one state
    _same_run(r0["run"], r1["run"])


def test_shard_map_resume_over_ranks_is_exact(ranks):
    for r in ranks["out"]:
        assert r["resume"]["resumed_from"] == RING["max_iteration"] // 2
        _same_run(r["resume"]["full"], r["resume"]["resumed"])
    a, b = (r["resume"]["full"] for r in ranks["out"])
    _same_arrays(a, b)
    # each rank resumed its own stream: the two streams differ
    assert not np.array_equal(a["generator"], b["generator"])


def test_scores_over_ranks_equal_one_device(ranks, tmp_path):
    cfg = Config(**{**BASE, **SCORES, "num_data_shards": 1,
                    "checkpoint_dir": str(tmp_path / "ck"), "sample_dir": str(tmp_path / "s"),
                    "log_dir": str(tmp_path / "l")})
    one = Trainer(cfg, device="cpu")
    one.SCORE_CHUNK_IMAGE_BYTES = CHUNK_BYTES
    want = [one._score(s) for s in (1, 2)]
    assert "three_sample_p" in want[1]
    for r in ranks["out"]:
        assert r["scores"] == want


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(ranks):
    got = [r["sigterm"] for r in ranks["out"]]
    assert got == [dict(step=2, saved=2)] * N


def test_sharded_pool_is_cut_to_the_ranks_and_k_invariant(ranks):
    cfg = Config(**{**BASE, **POOL})
    whole = materialize_u8(SyntheticImages(cfg.output_size, cfg.c_dim, seed=cfg.random_seed),
                           cfg.device_data_pool)
    per = cfg.device_data_pool // N
    for i, r in enumerate(ranks["out"]):
        assert r["pool"]["rows"].tobytes() == whole[i * per:(i + 1) * per].tobytes()
        _same_run(r["pool"]["k1"], r["pool"]["k3"])
    _same_arrays(ranks["out"][0]["pool"]["k1"], ranks["out"][1]["pool"]["k1"])


@pytest.mark.parametrize("source", ["synthetic", "array", "gaussian_mix"])
def test_rank_block_of_a_host_batch_is_byte_identical(source):
    r = np.random.default_rng(4)
    src = {"synthetic": SyntheticImages(16, 3, seed=5),
           "array": ArraySource(r.integers(0, 256, (50, 8, 8, 3), dtype=np.uint8), seed=6,
                                flip=True),
           "gaussian_mix": GaussianMix(seed=7)}[source]
    for u8 in ([False, True] if hasattr(src, "batch_u8") else [False]):
        whole = macro_batch_at(src, 9, 3, 8, u8=u8)
        for ranks in (2, 4):
            b = 8 // ranks
            for i in range(ranks):
                block = macro_batch_at(src, 9, 3, 8, u8=u8, block=(i, ranks))
                assert block.dtype == whole.dtype
                assert block.tobytes() == whole[:, i * b:(i + 1) * b].tobytes()


def _cli(tmp, *extra):
    return ["--device", "cpu", "--num_data_shards", "2", "--is_train", "true",
            "--dataset", "synthetic", "--architecture", "resnet", "--output_size", "16",
            "--max_iteration", "2", "--batch_size", "8", "--real_batch_size", "8",
            "--gf_dim", "8", "--df_dim", "8", "--dof_dim", "4", "--z_dim", "8",
            "--dsteps", "1", "--warmup_iterations", "0", "--log_every", "1",
            "--checkpoint_dir", str(tmp / "ck"), "--sample_dir", str(tmp / "s"),
            "--log_dir", str(tmp / "l"), *extra]


def test_main_trains_two_macro_steps_on_two_ranks(tmp_path, capsys):
    tmain.main(_cli(tmp_path))
    run = config_from_args(_cli(tmp_path)[2:]).run_name()
    with open(tmp_path / "l" / f"{run}.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert os.listdir(tmp_path / "ck" / run) == ["2.pt"]
    state = torch.load(tmp_path / "ck" / run / "2.pt", weights_only=True)
    assert state["step"] == 2


def test_rss_watchdog_restarts_the_whole_group(tmp_path, capfd):
    """Every rank over the RSS limit: the group checkpoints and exits with
    the restart code at step 1, the launcher starts it again, it resumes,
    and so once more at step 2, the last; then the run ends."""
    tmain.main(_cli(tmp_path, "--rss_limit_gb", "1e-6", "--auto_restart", "true"))
    out = capfd.readouterr().out        # the ranks' lines too
    assert out.count("restarting the group of ranks") == 2
    assert out.count("resumed from step") == 2
    run = config_from_args(_cli(tmp_path)[2:]).run_name()
    with open(tmp_path / "l" / f"{run}.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    state = torch.load(tmp_path / "ck" / run / "2.pt", weights_only=True)
    assert state["step"] == 2


def test_main_reports_a_failing_rank(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        tmain.main(_cli(tmp_path, "--batch_size", "9"))
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "failed" in err and "Traceback" in err and "divisible" in err


def test_more_shards_than_cards_are_refused(tmp_path):
    cfg = Config(**{**BASE, "num_data_shards": max(2, torch.cuda.device_count() + 1)})
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        check_devices(cfg, "cuda")
    with pytest.raises(ValueError, match="CUDA devices are visible"):
        tmain.main(_cli(tmp_path, "--device", "cuda", "--num_data_shards",
                        str(cfg.num_data_shards)))
    check_devices(cfg, "cpu")       # gloo ranks are processes: no limit
    with pytest.raises(ValueError, match="start one process per rank"):
        Trainer(Config(**{**BASE, **WRITES}), device="cpu")
