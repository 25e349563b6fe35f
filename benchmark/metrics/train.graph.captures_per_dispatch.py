"""CUDA-graph captures per dispatch in the traced windows A and B
(``benchmark.program_trace``), the program's counter
``train.graph.captures``: 0 while the state's capture holds, 1 where a
key changes at every dispatch.  A program without that counter gives
nothing to read."""

from benchmark import program_trace


def read(run):
    if run.get("kind") not in ("train", "train4"):
        return None
    w = program_trace.windows(run)
    if not w or not w.get("units_a"):
        return None
    from smmdax_torch import tracing
    if "train.graph.captures" not in tracing.COUNTERS:
        return None
    k = run["config"]["steps_per_dispatch"]
    captures = sum(w[f"counters_{x}"].get("train.graph.captures", 0) for x in "ab")
    return captures * k / (w["units_a"] + w["units_b"])
