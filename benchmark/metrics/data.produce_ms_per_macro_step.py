"""Host ms per macro-step the feed's thread spent building batches: the
mean ``data.macro_batch`` span (one macro-step's uint8 batch) off the
launching thread in window A of ``benchmark.program_trace``.  That thread
competes with the launching one for the interpreter lock."""

from benchmark import program_trace


def read(run):
    if run.get("kind") not in ("train", "train4"):
        return None
    w = program_trace.windows(run)
    row = (w or {}).get("host", {}).get("data.macro_batch")
    if not row or not row["off_main_count"]:
        return None
    return row["off_main_ms"] / row["off_main_count"]
