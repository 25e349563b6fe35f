"""The whole macro-step's share of the cards' bf16 peak: the
configuration's frozen FLOPs per macro-step at the untraced window's
macro-steps per second, in percent."""


def read(run):
    peaks, rate = run.get("peaks"), run.get("rate")
    if run.get("kind") != "train" or not peaks or not rate or not rate["window_s"]:
        return None
    steps_per_s = rate["macro_steps"] / rate["window_s"]
    return 100.0 * run["config"]["flops_per_macro_step"] * steps_per_s / (
        run["chips"] * peaks["bf16"])
