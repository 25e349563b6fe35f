"""Bytes rank 0 handed to collectives per macro-step: the program's
counter ``dp.bytes`` (each collective's input, forward and backward) over
window A's macro-steps in the ``train4`` cell (``benchmark.program_trace``).
A program without that counter gives nothing to read."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "train4":
        return None
    w = program_trace.windows(run)
    if not w or "dp.bytes" not in w["counters_a"]:
        return None
    return w["counters_a"]["dp.bytes"] / w["units_a"]
