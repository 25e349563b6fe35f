"""Kernel launches per macro-step: CUDA kernels (copies and fills not
counted) in the traced window over the macro-steps it ran (over ranks,
on rank 0's card)."""


def read(run):
    tr = run.get("trace")
    if run.get("kind") not in ("train", "train4") or not tr or not tr.get("macro_steps"):
        return None
    return tr["launches"] / tr["macro_steps"]
