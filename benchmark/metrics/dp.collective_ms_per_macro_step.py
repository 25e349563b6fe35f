"""Device ms per macro-step of rank 0's collectives: the operations whose
innermost program span is ``dp.all_reduce``, ``dp.all_gather``,
``dp.reduce_scatter`` or ``dp.shift`` (NCCL's kernels and the copies
around them, the waits for the other ranks inside them included), in
window B of the ``train4`` cell (``benchmark.program_trace``)."""

from benchmark import program_trace

SPANS = ("dp.all_reduce", "dp.all_gather", "dp.reduce_scatter", "dp.shift")


def read(run):
    if run.get("kind") != "train4":
        return None
    w = program_trace.windows(run)
    if not w or not w.get("device"):
        return None
    return program_trace.per_unit(w, SPANS, "device_ms")
