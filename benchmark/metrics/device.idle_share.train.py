"""Share of the traced window in which no operation ran on the card
(rank 0), in percent: 1 - busy / window."""


def read(run):
    tr = run.get("trace")
    if run.get("kind") not in ("train", "train4") or not tr or not tr.get("window_s") \
            or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
