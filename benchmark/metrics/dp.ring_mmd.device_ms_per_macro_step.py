"""Device ms per macro-step of rank 0's ring MMD^2 forward: the operations
whose innermost program span is ``losses.mmd`` (the ring's pair-sum
blocks and their sums; its shifts and its psum fall under the ``dp.*``
spans, its backward under ``train.d_grad`` / ``train.g_grad``), in window
B of the ``train4`` cell (``benchmark.program_trace``)."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "train4":
        return None
    w = program_trace.windows(run)
    if not w or not w.get("device"):
        return None
    return program_trace.per_unit(w, ("losses.mmd",), "device_ms")
