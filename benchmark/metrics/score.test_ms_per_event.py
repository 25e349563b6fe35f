"""Host ms per scoring event in the scheduler's three-sample test: the
``eval.three_sample_test`` spans of window A of
``benchmark.program_trace``."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "score":
        return None
    w = program_trace.windows(run)
    if not w or "eval.three_sample_test" not in w["host"]:
        return None
    return program_trace.per_unit(w, ("eval.three_sample_test",), "host_ms", "a")
