"""The port's TensorBoard event files (``smmdax_torch/tfevents.py``,
``MetricWriter(tensorboard=True)``) against the JAX package's
``tf.summary`` files: the same rows; TensorFlow's ``summary_iterator``
reads both and every ``Event`` is equal apart from ``wall_time``;
TensorBoard's ``EventAccumulator`` gives the same scalars; ``read_events``
checks both CRCs; rank 1 writes nothing."""

import glob
import json
import os

import numpy as np
import pytest

from smmdax_torch import tfevents
from smmdax_torch import utils as tutils

ROWS = [(0, {"loss": 0.25, "n": 7}), (3, {"loss": -1.5e-3, "kid": 1e30}),
        (113000, {"loss": float("inf"), "g_lr": 5e-5, "step_time": 0.1234567})]


def _write(writer_cls, log_dir) -> str:
    w = writer_cls(str(log_dir), "run", also_stdout=False, tensorboard=True)
    for step, metrics in ROWS:
        w.write(step, metrics)
    w.close()
    (path,) = glob.glob(os.path.join(str(log_dir), "tb", "run", "events.out.tfevents.*"))
    return path


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    pytest.importorskip("tensorflow")
    from smmdax.utils import MetricWriter as JMetricWriter
    root = tmp_path_factory.mktemp("tb")
    return _write(JMetricWriter, root / "jax"), _write(tutils.MetricWriter, root / "port")


def test_file_names_and_rows(both):
    jpath, tpath = both
    for path in both:
        name = os.path.basename(path).split(".")
        assert name[:3] == ["events", "out", "tfevents"] and name[-1] == "v2"
        assert len(name[3]) == 10 and name[3].isdigit()
    assert os.path.basename(tpath).split(".")[5] == str(os.getpid())
    jrows = [json.loads(line) for line in open(os.path.join(os.path.dirname(jpath), "..", "..",
                                                            "run.jsonl"))]
    trows = [json.loads(line) for line in open(os.path.join(os.path.dirname(tpath), "..", "..",
                                                            "run.jsonl"))]
    assert [{k: v for k, v in r.items() if k != "time"} for r in trows] == \
        [{k: v for k, v in r.items() if k != "time"} for r in jrows]


def test_tensorflow_reads_equal_events(both):
    import tensorflow as tf
    events = []
    for path in both:
        evs = list(tf.compat.v1.train.summary_iterator(path))
        for e in evs:
            e.ClearField("wall_time")
        events.append([e.SerializeToString() for e in evs])
    assert len(events[0]) == 1 + sum(len(m) for _, m in ROWS)
    assert events[1] == events[0]


def test_tensorboard_gives_equal_scalars(both):
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    got = []
    for path in both:
        acc = ea_mod.EventAccumulator(path)
        acc.Reload()
        tags = sorted(acc.Tags()["tensors"])
        got.append({t: [(e.step, bytes(e.tensor_proto.tensor_content))
                        for e in acc.Tensors(t)] for t in tags})
    assert got[1] == got[0]
    assert sorted(got[0]) == ["g_lr", "kid", "loss", "n", "step_time"]


def test_read_events_matches_jsonl_and_checks_crcs(both, tmp_path):
    _, tpath = both
    evs = tfevents.read_events(tpath)
    assert evs[0]["file_version"] == "brain.Event:2"
    assert evs[0]["wall_time"] == int(evs[0]["wall_time"])
    flat = [(step, k, float(np.float32(v))) for step, m in ROWS for k, v in m.items()]
    assert [(e["step"],) + e["values"][0] for e in evs[1:]] == flat
    assert all(len(e["values"]) == 1 for e in evs[1:])
    data = bytearray(open(tpath, "rb").read())
    for pos, what in ((-1, "data CRC"), (9, "length CRC")):
        bad = bytearray(data)
        bad[pos] ^= 0x10
        p = tmp_path / f"bad{pos}"
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=what):
            tfevents.read_events(str(p))


def test_crc32c_known_values():
    assert tfevents.crc32c(b"") == 0
    assert tfevents.crc32c(b"123456789") == 0xE3069283
    assert tfevents.crc32c(bytes(32)) == 0x8A9136AA


def test_rank_one_writes_nothing(tmp_path):
    w = tutils.MetricWriter(str(tmp_path / "logs"), "run", tensorboard=True, rank=1)
    w.write(1, {"loss": 1.0})
    w.close()
    assert not (tmp_path / "logs").exists()
