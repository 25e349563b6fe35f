"""The whole macro-step's share of the cards' bf16 peak in the ``train4``
cell, as ``benchmark/metrics/train.mfu.py`` reads it.  There it moves
``setup_s``, whose set-up runs the same step: the cell's training rate
spreads too widely over the shared host to be an end-to-end metric, and
stands beside this one as ``train.images_per_s.train4``."""

from benchmark import common


def read(run):
    if run.get("kind") != "train4":
        return None
    return common.read_metric("train.mfu", run)
