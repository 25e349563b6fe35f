"""Device idle ms per macro-step credited to spectral norm's forward side:
the card's idle gaps whose launching thread had ``nn.spectral`` or
``train.sn_refresh`` as its innermost open program span at the gap's
middle, in window B of ``benchmark.program_trace``."""

from benchmark import program_trace


def read(run):
    if run.get("kind") != "train":
        return None
    w = program_trace.windows(run)
    if not w:
        return None
    return program_trace.per_unit(w, ("nn.spectral", "train.sn_refresh"), "idle_ms")
