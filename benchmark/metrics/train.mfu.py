"""The whole macro-step's share of the cards' bf16 peak: the
configuration's frozen FLOPs per macro-step (over ranks, the global
macro-step's: every rank's work) at the untraced window's macro-steps per
second, over the peak of all the cards the cell uses, in percent."""


def read(run):
    peaks, rate = run.get("peaks"), run.get("rate")
    if run.get("kind") not in ("train", "train4") or not peaks or not rate or not rate["window_s"]:
        return None
    steps_per_s = rate["macro_steps"] / rate["window_s"]
    return 100.0 * run["config"]["flops_per_macro_step"] * steps_per_s / (
        run["chips"] * peaks["bf16"])
