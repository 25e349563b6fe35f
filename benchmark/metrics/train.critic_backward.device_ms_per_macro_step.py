"""Device ms per macro-step of the operations launched under
``train.d_grad``, the critic's ``autograd.grad`` (sigma's double backward
and the backward through W / sigma), at any depth, in window B of
``benchmark.program_trace``."""

from benchmark import program_trace


def read(run):
    if run.get("kind") not in ("train", "train4"):
        return None
    w = program_trace.windows(run)
    if not w:
        return None
    return program_trace.per_unit(w, ("train.d_grad",), "device_ms_in")
