"""Host ms a dispatch waited on the feed's queue for its K macro-batches
(and stacked them), the mean over the untraced window's dispatches."""


def read(run):
    waits = run.get("spans", {}).get("data.wait")
    if run.get("kind") not in ("train", "train4") or not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
