"""The whole scoring event's share of the card's float32 peak, in
percent: the configuration's frozen FLOPs per image (the generator's
eval-mode forward and Inception-v3's) at the untraced window's
score_images_per_s.  The event's main work, Inception, runs in float32
with TF32 off, so the peak is the FP32 rate outside the tensor cores."""


def read(run):
    peaks, rate = run.get("peaks"), run.get("rate")
    if run.get("kind") != "score" or not peaks or not rate or not rate["window_s"]:
        return None
    c = run["config"]
    per_image = c["sample_flops_per_image"] + c["inception_flops_per_image"]
    return 100.0 * per_image * rate["images"] / rate["window_s"] / (run["chips"] * peaks["fp32"])
