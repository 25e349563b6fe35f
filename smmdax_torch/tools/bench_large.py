"""Large-image macro-step measurement, the counterpart of the JAX
package's ``tools/bench_large.py``.

    python -m smmdax_torch.tools.bench_large [--quick] [--configs NAME ...] [--device cpu]

It times the ImageNet-64 (``resnet64_b64``) and CelebA-160
(``celeba160_b64``) flagship-family configs and their ``_remat`` twins
with batches drawn on the card (``on_device_train_step``: no host to
device copy), and each base config once more host-fed (uint8 batches
made by a producer thread and copied per macro-step, as the trainer
feeds them; the row keeps the JAX tool's key, ``tunneled_u8``).
``compile_s`` is the warm-up's seconds (the port compiles nothing).
FLOPs per macro-step come from ``smmdax_torch.train.macro_step_flops``,
the peak from ``smmdax_torch.bench.PEAK_FLOPS``.  The default device is
``cuda``; nothing falls back to the CPU.

Prints one JSON line per config with the median and spread over windows.
"""

from __future__ import annotations

import argparse
import json
import queue
import statistics
import sys
import threading
import time

import torch

from smmdax_torch.bench import barrier, peak_flops

def _configs():
    from smmdax_torch.configs import Config
    common = dict(model="sn-smmd", kernel="rq", dataset="synthetic",
                  random_seed=0, dsteps=5, gsteps=1,
                  compute_dtype="bfloat16",
                  scaling_grad_estimator="hutchinson")
    base = {
        # ImageNet-64 shapes
        "resnet64_b64": Config(architecture="resnet", output_size=64,
                               batch_size=64, real_batch_size=64,
                               dof_dim=16, remat=False, **common),
        # the paper's deepest config: CelebA 160x160 deep ResNet
        "celeba160_b64": Config(architecture="resnet", output_size=160,
                                batch_size=64, real_batch_size=64,
                                gf_dim=32, df_dim=32, dof_dim=16,
                                remat=False, **common),
    }
    # derive, never copy: a shape change to a base config must not
    # desynchronize its remat twin (the difference IS the measurement)
    return {**base, **{f"{name}_remat": cfg.replace(remat=True)
                       for name, cfg in base.items()}}


def _window_stats(times: list, per_step_imgs: int) -> dict:
    med = statistics.median(times)
    return {
        "macro_step_ms": round(med * 1e3, 1),
        "images_per_sec": round(per_step_imgs / med, 1),
        "window_ms": [round(t * 1e3, 1) for t in times],
        "spread_pct": round(100 * (max(times) - min(times)) / med, 1),
    }


def _measure_on_device(cfg, windows: int, steps_per_window: int, device="cuda") -> dict:
    from smmdax_torch.train import create_state, macro_step_flops, on_device_train_step
    state = create_state(cfg, cfg.random_seed, device=device)
    dev = state.device
    step = on_device_train_step(cfg, cfg.dsteps, cfg.gsteps)
    t0 = time.time()
    # warm-up: enough macro-steps that the first timed window is past
    # the allocator's and cuDNN's first calls
    for _ in range(6):
        state, metrics = step(state)
        barrier(dev, metrics)
    warm_s = time.time() - t0
    per_step = cfg.dsteps + cfg.gsteps
    times = []
    for _ in range(windows):
        t0 = time.time()
        for _ in range(steps_per_window):
            state, metrics = step(state)
        barrier(dev, metrics)
        times.append((time.time() - t0) / steps_per_window)
    out = _window_stats(times, per_step * cfg.batch_size)
    out["compile_s"] = round(warm_s, 1)
    med = statistics.median(times)
    flops = macro_step_flops(cfg, cfg.dsteps, cfg.gsteps, dev)
    out["tflops_per_step"] = round(flops / 1e12, 3)
    out["tflops_per_sec"] = round(flops / med / 1e12, 2)
    peak = peak_flops(dev)
    if peak:
        out["mfu"] = round(flops / med / peak, 4)
    return out


def _measure_tunneled(cfg, windows: int, steps_per_window: int, device="cuda") -> dict:
    """The host-fed path (uint8 batches copied per macro-step).  A
    producer thread assembles the batches, as the trainer's does, so the
    window measures the step and the copy, not numpy."""
    from smmdax_torch.data import make_dataset
    from smmdax_torch.train import create_state, dispatch_train_step
    source = make_dataset(cfg)
    per_step = cfg.dsteps + cfg.gsteps
    state = create_state(cfg, cfg.random_seed, device=device)
    dev = state.device
    step = dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps)

    def make(i):
        flat = source.batch_u8(per_step * cfg.batch_size, key=i)
        return flat.reshape((per_step, cfg.batch_size) + flat.shape[1:])

    warm = 4
    total = warm + windows * steps_per_window
    q: "queue.Queue" = queue.Queue(maxsize=4)
    threading.Thread(target=lambda: [q.put(make(i)) for i in range(total)],
                     daemon=True).start()

    for _ in range(warm):
        state, metrics = step(state, q.get(timeout=300))
        barrier(dev, metrics)
    times = []
    for _ in range(windows):
        t0 = time.time()
        for _ in range(steps_per_window):
            state, metrics = step(state, q.get(timeout=300))
        barrier(dev, metrics)
        times.append((time.time() - t0) / steps_per_window)
    return _window_stats(times, per_step * cfg.batch_size)


def main(argv=None) -> None:
    from smmdax_torch.train import resolve_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true", help="fewer, shorter windows")
    p.add_argument("--configs", nargs="*", default=None, help="subset of config names")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; nothing falls back to the CPU)")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    windows = 3 if a.quick else 5
    spw = 5 if a.quick else 10
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for name, cfg in _configs().items():
        if a.configs and name not in a.configs:
            continue
        row = {"config": name, "device": kind,
               "on_device_data": _measure_on_device(cfg, windows, spw, device)}
        # remat changes recompute on the card, not the uint8 copy: only
        # the base configs measure the host-fed row
        if not name.endswith("_remat"):
            row["tunneled_u8"] = _measure_tunneled(cfg, windows, spw, device)
        print(json.dumps(row))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
