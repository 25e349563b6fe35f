"""Percent of window A's macro-steps that ran as a replay of a captured
CUDA graph: the program's counter ``train.graph.replays`` over window A's
macro-steps (``benchmark.program_trace``).  Window A follows a warm-up
dispatch of the same state, so a capture that a changing key makes anew
every dispatch shows here: that dispatch's first macro-step runs
eagerly (75% at 4 macro-steps a dispatch).  Window B runs under the
profiler with spans on, where the program runs its macro-steps eagerly
to credit each kernel to a phase.  A program without that counter gives
nothing to read."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "train":
        return None
    w = program_trace.windows(run)
    if not w or not w.get("units_a"):
        return None
    from smmdax_torch import tracing
    if "train.graph.replays" not in tracing.COUNTERS:
        return None
    return 100.0 * w["counters_a"].get("train.graph.replays", 0) / w["units_a"]
