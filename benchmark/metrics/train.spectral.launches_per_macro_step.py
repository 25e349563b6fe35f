"""Kernel launches per macro-step under spectral norm's forward side: the
kernels whose innermost program span is ``nn.spectral`` (an SN layer's
power iteration and W / sigma) or ``train.sn_refresh`` (the critic
update's dummy forward), in window B of ``benchmark.program_trace``."""

from benchmark import program_trace


def read(run):
    if run.get("kind") not in ("train", "train4"):
        return None
    w = program_trace.windows(run)
    if not w:
        return None
    return program_trace.per_unit(w, ("nn.spectral", "train.sn_refresh"), "launches")
