"""A scoring cell: the scoring events a training run stops for, as
``Trainer._score`` composes them for the configuration's flags, without
its checkpoint I/O.

Set-up first moves the program's state by the traffic's ``train_steps``
macro-steps, so that the EMA shadow and the generator's BN running
averages differ from the live weights.  One event draws ``no_of_samples``
images from the EMA generator through
the port's ``train.sample``, takes Inception-v3 pool3 features and class
probabilities through ``eval.features.InceptionFeatures`` (float32, TF32
off), computes FID, KID and IS through ``eval.scores`` against the real
set, and runs the three-sample scheduler test against the previous
event's features (the first, in set-up, against the real set's).  Inception's weights are random, drawn from the seed on
the card and written to the run's temporary directory in torchvision's
layout; the real set's features are taken in set-up, as a training run
takes them once.  Set-up runs one event (its test against the real set),
which warms every shape and gives the program's readings; the window
runs events until ``--seconds`` have passed.  ``score_images_per_s`` is
the images of the completed events over the window's wall time.

The comparison (``score_check``) runs after the window, with the
program's generator and extractor freed.
"""

from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from typing import Dict

import numpy as np

from benchmark import common, trace
from benchmark.feed import Feed, images
from benchmark.reference import inception as ref_inception

REAL_KEY = 2**31 + 1          # the trainer's key of the real scoring set
CHECK_ROWS = 256


def write_inception_weights(path: str, seed: int, dev) -> None:
    """A torchvision-layout Inception-v3 state dict of random weights,
    drawn on the card from ``seed`` in one call per kind of leaf:
    kernels normal(0, sqrt(2 / fan_in)), BN scales and variances uniform
    in [0.5, 1.5], BN shifts and means normal(0, 0.1), the fc
    normal(0, 0.02) with a zero bias."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    specs = ref_inception.SPECS
    sizes = [co * ci * k[0] * k[1] for ci, co, k, _, _ in specs.values()]
    chans = [co for _, co, _, _, _ in specs.values()]
    normal = torch.randn(sum(sizes), generator=g, device=dev)
    uni = torch.rand(2 * sum(chans), generator=g, device=dev) + 0.5
    small = torch.randn(2 * sum(chans), generator=g, device=dev) * 0.1
    fc = torch.randn(ref_inception.CLASSES * 2048, generator=g, device=dev) * 0.02
    normal, uni, small, fc = (t.cpu().numpy() for t in (normal, uni, small, fc))
    state, a, b = {}, 0, 0
    for (name, (ci, co, k, _, _)), n in zip(specs.items(), sizes):
        std = np.float32(math.sqrt(2.0 / (ci * k[0] * k[1])))
        state[f"{name}.conv.weight"] = normal[a:a + n].reshape(co, ci, *k) * std
        state[f"{name}.bn.weight"] = uni[2 * b:2 * b + co]
        state[f"{name}.bn.running_var"] = uni[2 * b + co:2 * b + 2 * co]
        state[f"{name}.bn.bias"] = small[2 * b:2 * b + co]
        state[f"{name}.bn.running_mean"] = small[2 * b + co:2 * b + 2 * co]
        a += n
        b += co
    state["fc.weight"] = fc.reshape(ref_inception.CLASSES, 2048)
    state["fc.bias"] = np.zeros(ref_inception.CLASSES, np.float32)
    np.savez(path, **state)


def check_rows(seed: int, n: int) -> np.ndarray:
    """The rows of an event whose images and features are compared."""
    rng = np.random.default_rng([seed, 0x5C0E])
    return np.sort(rng.choice(n, min(CHECK_ROWS, n), replace=False))


def weights_path() -> str:
    return os.path.join(tempfile.gettempdir(), "smmdax_benchmark_inception_v3.npz")


class Event:
    """One scoring event of the port, with its spans."""

    def __init__(self, cfg, c: dict, state, extractor, real_feats, dev):
        from smmdax_torch.eval import gaussian_stats
        self.cfg, self.c, self.state, self.ext, self.dev = cfg, c, state, extractor, dev
        self.real_feats = real_feats
        self.real_stats = gaussian_stats(real_feats)
        self.spans: Dict[str, list] = {"sample": [], "inception": [], "stats": []}

    def __call__(self, seed: int, prev, keep_rows=None) -> dict:
        import torch
        from smmdax_torch.eval import (extract_with_probs, frechet_distance, gaussian_stats,
                                       inception_score, kid_from_features)
        from smmdax_torch.eval.scores import relative_mmd_test
        from smmdax_torch.train import sample
        c, n = self.c, self.c["no_of_samples"]
        t0 = time.perf_counter()
        imgs = sample(self.cfg, self.state, torch.Generator(device=self.dev).manual_seed(seed), n)
        common.sync(self.dev)
        t1 = time.perf_counter()
        feats, probs = extract_with_probs(self.ext, imgs, fetch=self.dev.type != "cuda")
        common.sync(self.dev)
        t2 = time.perf_counter()
        kept = None if keep_rows is None else imgs[torch.as_tensor(keep_rows)].float().cpu()
        del imgs
        out = {"fid": frechet_distance(*self.real_stats, *gaussian_stats(feats))}
        out["kid"] = kid_from_features(self.real_feats, feats,
                                       subset_size=min(c["score_subset_size"], n),
                                       n_subsets=c["score_subsets"])[0]
        out["is"] = inception_score(probs)[0]
        relative_mmd_test(self.real_feats, feats, prev,
                          subset_size=min(c["scheduler_test_size"], n),
                          n_subsets=c["scheduler_test_subsets"], seed=seed, combine="fisher")
        t3 = time.perf_counter()
        for k, s in (("sample", t1 - t0), ("inception", t2 - t1), ("stats", t3 - t2)):
            self.spans[k].append(s)
        return {"scores": out, "feats": feats, "probs": probs, "images": kept}


def moved_state(cfg, c: dict, t: dict, seed: int, data, dev):
    """The program's state after the traffic's ``train_steps`` macro-steps,
    each a dispatch of one fed as a training cell feeds it: the EMA shadow
    and the BN running averages now differ from the live generator's."""
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.train import create_state, dispatch_train_step
    state = create_state(cfg, seed=seed, device=dev)
    per_step = c["dsteps"] + c["gsteps"]
    single = dispatch_train_step(cfg, c["dsteps"], c["gsteps"], steps_per_dispatch=1)
    feed = Feed(ArraySource(data, seed=seed), per_step, c["real_batch_size"], 1)
    try:
        for _ in range(t["train_steps"]):
            state, _ = single(state, feed.dispatch_batch(record=False))
    finally:
        feed.close()
    return state


def start(c: dict, t: dict, seed: int, dev, extractor_hook=None):
    """Set-up up to the window: the program's state, extractor, real set
    and one event; returns what the window and the comparison need."""
    import torch
    from smmdax_torch.data.pipeline import ArraySource
    from smmdax_torch.eval import InceptionFeatures, extract_features

    cfg = common.port_config(c, seed)
    data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
    state = moved_state(cfg, c, t, seed, data, dev)
    path = weights_path()
    write_inception_weights(path, seed, dev)
    extractor = InceptionFeatures(path, device=dev)
    if extractor_hook is not None:
        extractor_hook(extractor)
    n = c["no_of_samples"]
    real = ArraySource(data, seed=seed).batch(n, key=REAL_KEY)
    real_feats = extract_features(extractor, real, fetch=dev.type != "cuda")
    del real
    event = Event(cfg, c, state, extractor, real_feats, dev)
    rows = check_rows(seed, n)
    first = event(seed, real_feats, keep_rows=rows)
    readings = {"rows": rows, "images": first["images"], "scores": first["scores"],
                "feats": torch.as_tensor(first["feats"]), "probs": torch.as_tensor(first["probs"]),
                "real_feats": torch.as_tensor(real_feats)}
    for k in event.spans:
        event.spans[k].clear()
    return cfg, data, state, event, first["feats"], readings, path


def run(ctx: dict) -> Dict:
    import torch
    from benchmark import score_check

    c, t, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], torch.device(ctx["device"])
    cfg, data, state, event, prev, readings, path = start(c, t, seed, dev)
    common.sync(dev)
    setup_s = time.perf_counter() - ctx["t0"]

    n, events = c["no_of_samples"], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx["seconds"]:
        prev = event(seed + 1 + events, prev)["feats"]
        events += 1
    window_s = time.perf_counter() - t0
    run_info = {"kind": "score", "config": c, "traffic": t, "chips": ctx["chips"],
                "rate": {"events": events, "window_s": window_s, "images": events * n},
                "spans": {k: list(v) for k, v in event.spans.items()}, "peaks": ctx["peaks"]}
    extra: Dict = {}
    if ctx["trace"] and dev.type == "cuda":
        def one_event():
            event(seed + 1 + events, prev)

        summary = trace.device_window(one_event)
        summary["events"] = 1
        gaps = trace.host_window(one_event)
        run_info["trace"] = summary
        extra = {"busy_s": summary["busy_s"], "window_s": summary["window_s"],
                 "breakdown": {"device_ops": summary["device_ops"], "idle_gaps": gaps}}
    device = common.device_info(ctx["chips"], dev)

    del state, event, prev
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = score_check.compare(c, t, seed, data, readings, path, dev)
    os.remove(path)
    checks = common.judge(numbers, c["limits"]["score"])
    return {"setup_s": setup_s, "run": run_info, "device": device, "extra": extra,
            "checks": checks, "attempted": events, "failed": 0,
            "e2e": {"score_images_per_s": events * n / window_s}}
