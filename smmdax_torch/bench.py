"""Headline benchmark of the port: train images/s on one CUDA card,
CIFAR-10 32x32, the counterpart of the JAX package's ``bench.py``.

    python -m smmdax_torch.bench [--device cpu]

It runs the flagship configuration (sn-smmd: SN ResNet critic, rq-mixture
scaled MMD, bf16 convolutions, hutchinson sigma, 5 critic + 1 generator
updates at B 64) on synthetic CIFAR-10-shaped data, so no downloaded asset
is needed.  The flagship takes the fused CUDA pair-sum path
(``pallas_min_rows`` 0), so every training arm launches the pair-sum
kernels.  The default device is ``cuda``; nothing falls back to the CPU.

Metric: one macro-step is dsteps critic + gsteps generator updates;
images/s counts the real images a macro-step consumes (batch * (dsteps +
gsteps)) over wall time.  Each arm's number is the MEDIAN of its timed
windows, with min and max beside it.  A window ends on
``torch.cuda.synchronize`` and one metric's ``.item()``.  FLOPs per
macro-step come from ``smmdax_torch.train.macro_step_flops`` (the
registry's formulas over one eager macro-step; its docstring gives the
basis), giving ``tflops_per_sec`` and, on a card listed in
``PEAK_FLOPS``, ``mfu`` against its dense bf16 peak.

Output contract, as the JAX bench's:

* stdout is line-buffered;
* the REQUIRED arm runs first: device-resident flagship at K=16 (the
  dataset uploaded once, batches gathered on the card).  Its JSON line is
  complete, and its ``value`` never changes afterwards;
* every further arm (sampling, host-fed, batch sweep, dispatch sweep) is
  optional and gated on the remaining wall budget
  (``SMMDAX_BENCH_BUDGET`` seconds, default 22 min); each one adds fields
  and prints the whole JSON line again.  An optional arm that is skipped
  or fails is listed in ``skipped_arms``;
* after the headline, SIGTERM or the SIGALRM budget backstop writes one
  last complete JSON line through ``os.write`` and exits 0; before it,
  the process exits 3 with no JSON.

``vs_baseline`` and ``vs_prev_round`` are null: the JAX bench's baselines
are measurements of another device, not of this port.

Prints JSON lines: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import statistics
import sys
import threading
import time

import numpy as np
import torch

try:  # evidence must reach the pipe even if the process is killed
    sys.stdout.reconfigure(line_buffering=True)
except (AttributeError, ValueError):
    pass

HEADLINE_K = 16         # device-resident: no per-dispatch transfer, so K
                        # only groups macro-steps between host waits
HOST_K = 4              # host-fed and sweep arms
HEADLINE_BATCH = 64     # the CIFAR-10 point
POOL_SAMPLES = 50_000   # CIFAR-10-sized device-resident pool
SAMPLING_BATCH = 512
WARMUP_STEPS = 3
N_WINDOWS = 5
STEPS_PER_WINDOW = 64
HEADLINE_WINDOWS = 9    # more, shorter windows harden the headline median
HEADLINE_STEPS_PER_WINDOW = 32
DISPATCH_SWEEP = (1, 8)             # K=4 is the host-fed arm itself
BATCH_SWEEP = (128, 256, 512)       # B=64 is the headline arm itself

# Wall budget for the WHOLE bench: optional arms are skipped once the
# remaining budget cannot cover their estimate, and a SIGALRM backstop
# emits the current JSON and exits 0.
BUDGET_S = float(os.environ.get("SMMDAX_BENCH_BUDGET", 22 * 60))

# Dense bf16 tensor-core peak per card, keyed by torch.cuda.get_device_name.
# H100 SXM5: 989.4 TFLOP/s, NVIDIA H100 Tensor Core GPU datasheet (its
# 1,979 TFLOP/s is with sparsity).  The flagship's convolutions run in bf16.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def _flagship_cfg(batch_size: int = 64, k: int = 1):
    from smmdax_torch.configs import Config
    # every headline feature on (spectral norm, scaled MMD, rq mixture)
    # with the fast execution paths: bf16 convolutions (parameters and the
    # MMD math stay float32) and the unbiased one-probe hutchinson sigma
    return Config(model="sn-smmd", kernel="rq", architecture="resnet",
                  dataset="synthetic", output_size=32, batch_size=batch_size,
                  real_batch_size=batch_size,
                  dof_dim=16, dsteps=5, gsteps=1, random_seed=0,
                  compute_dtype="bfloat16",
                  scaling_grad_estimator="hutchinson",
                  steps_per_dispatch=k)


def peak_flops(device: torch.device):
    """The card's dense bf16 peak, None on the CPU or an unlisted card."""
    if device.type != "cuda":
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(device))


def barrier(device: torch.device, metrics) -> None:
    """Completion barrier: the device's queue drained, one metric read."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    metrics["d_loss_mmd2"].item()


def _rates(flops: float, images_per_sec: float, images_per_unit: int,
           device: torch.device) -> dict:
    """tflops_per_sec of ``flops`` per ``images_per_unit`` images at
    ``images_per_sec``, and mfu where the card has a listed peak."""
    tfs = flops * (images_per_sec / images_per_unit) / 1e12
    out = {"tflops_per_sec": round(tfs, 2)}
    peak = peak_flops(device)
    if peak is not None:
        out["mfu"] = round(tfs * 1e12 / peak, 4)
    return out


class _Harness:
    """One (batch_size, steps_per_dispatch) host-fed arm: the dispatching
    step and a deterministic uint8 macro-batch maker."""

    def __init__(self, batch_size: int, k: int, device="cuda"):
        from smmdax_torch.data import make_dataset
        from smmdax_torch.train import create_state, dispatch_train_step
        self.cfg = _flagship_cfg(batch_size, k)
        self.k = k
        self.per_step = self.cfg.dsteps + self.cfg.gsteps
        self.source = make_dataset(self.cfg)
        self.state = create_state(self.cfg, 0, device=device)
        self.device = self.state.device
        self.step = dispatch_train_step(self.cfg, self.cfg.dsteps, self.cfg.gsteps,
                                        steps_per_dispatch=k)
        self._flops = None

    def flops_per_macro_step(self) -> float:
        if self._flops is None:
            from smmdax_torch.train import macro_step_flops
            cfg1 = self.cfg.replace(steps_per_dispatch=1)
            self._flops = macro_step_flops(cfg1, cfg1.dsteps, cfg1.gsteps, self.device)
        return self._flops

    def make_u8(self, dispatch_idx: int) -> np.ndarray:
        """One dispatch worth of fresh batches, as the trainer makes them:
        uint8, normalized in the step, keyed by step."""
        cfg, k = self.cfg, self.k
        parts = []
        for i in range(k):
            flat = self.source.batch_u8(self.per_step * cfg.batch_size,
                                        key=dispatch_idx * k + i)
            parts.append(flat.reshape((self.per_step, cfg.batch_size)
                                      + flat.shape[1:]))
        return parts[0] if k == 1 else np.stack(parts)

    def warmup(self) -> float:
        t0 = time.time()
        for i in range(WARMUP_STEPS):
            self.state, metrics = self.step(self.state, self.make_u8(10_000 + i))
            barrier(self.device, metrics)
        self.last_metrics = metrics
        return time.time() - t0

    def timed_window(self, macro_steps: int, feed) -> float:
        """images/s over one window; ``feed`` yields ready host arrays
        (prefetched by the caller)."""
        n_disp = macro_steps // self.k
        t0 = time.time()
        for _ in range(n_disp):
            self.state, metrics = self.step(self.state, feed())
        barrier(self.device, metrics)
        self.last_metrics = metrics
        elapsed = time.time() - t0
        return n_disp * self.k * self.per_step * self.cfg.batch_size / elapsed


def _prefetching_feed(harness: _Harness, n_dispatches: int, start: int = 0):
    """Producer-thread prefetch, as the trainer's: host batch assembly
    overlaps the device, so the window measures the step and the copy,
    not numpy."""
    q: "queue.Queue" = queue.Queue(maxsize=4)

    def _producer():
        for i in range(start, start + n_dispatches):
            q.put(harness.make_u8(i))

    threading.Thread(target=_producer, daemon=True).start()
    # bounded get: a dead producer must fail loudly, not hang the bench
    return lambda: q.get(timeout=180)


def _measure(harness: _Harness, windows: int, steps_per_window: int,
             tag: str) -> dict:
    total_disp = windows * steps_per_window // harness.k
    feed = _prefetching_feed(harness, total_disp)
    ips = []
    for _ in range(windows):
        ips.append(harness.timed_window(steps_per_window, feed))
    med = statistics.median(ips)
    out = {"images_per_sec": round(med, 2),
           "windows": [round(w, 1) for w in ips],
           "min": round(min(ips), 2), "max": round(max(ips), 2)}
    flops = harness.flops_per_macro_step()
    out.update(_rates(flops, med, harness.per_step * harness.cfg.batch_size,
                      harness.device))
    out["flops_per_macro_step"] = flops
    print(f"# {tag}: {med:.0f} img/s "
          f"(windows={['%.0f' % w for w in ips]}, "
          f"mfu={out.get('mfu', 'n/a')})", flush=True)
    return out


def _measure_on_device_sweep(batch_size: int, k: int, device="cuda") -> dict:
    """One batch-size point of the MFU sweep: the flagship with its real
    batches drawn on the card (``on_device_train_step``)."""
    from smmdax_torch.train import create_state, macro_step_flops, on_device_train_step
    cfg = _flagship_cfg(batch_size, k)
    state = create_state(cfg, 0, device=device)
    dev = state.device
    step = on_device_train_step(cfg, cfg.dsteps, cfg.gsteps, steps_per_dispatch=k)
    t0 = time.time()
    for _ in range(2):
        state, metrics = step(state)
        barrier(dev, metrics)
    wu = time.time() - t0
    per_step = cfg.dsteps + cfg.gsteps
    # constant IMAGE budget per window across B
    n_disp = max(2, STEPS_PER_WINDOW * 64 // batch_size // k)
    ips = []
    for _ in range(2):
        t0 = time.time()
        for _ in range(n_disp):
            state, metrics = step(state)
        barrier(dev, metrics)
        elapsed = time.time() - t0
        ips.append(n_disp * k * per_step * cfg.batch_size / elapsed)
    med = statistics.median(ips)
    out = {"images_per_sec": round(med, 2),
           "windows": [round(w, 1) for w in ips]}
    if peak_flops(dev) is not None:
        flops = macro_step_flops(cfg.replace(steps_per_dispatch=1), cfg.dsteps, cfg.gsteps, dev)
        out.update(_rates(flops, med, per_step * cfg.batch_size, dev))
    print(f"# B={batch_size} K={k} on-device (warmup {wu:.0f}s): "
          f"{med:.0f} img/s (windows={['%.0f' % w for w in ips]}, "
          f"mfu={out.get('mfu', 'n/a')})", flush=True)
    return out


def _measure_device_resident(batch_size: int, k: int, pool: int = 50_000,
                             device="cuda") -> dict:
    """The production data path (``data_placement="device"``): a
    CIFAR-10-sized uint8 pool put on the card once, every batch gathered
    there (``device_data_train_step``).  No per-step host transfer."""
    from smmdax_torch.data import make_dataset
    from smmdax_torch.data.pipeline import materialize_u8
    from smmdax_torch.train import create_state, device_data_train_step, macro_step_flops
    cfg = _flagship_cfg(batch_size, k)
    state = create_state(cfg, 0, device=device)
    dev = state.device
    data = torch.from_numpy(materialize_u8(make_dataset(cfg), pool)).to(dev)
    step = device_data_train_step(cfg, cfg.dsteps, cfg.gsteps, steps_per_dispatch=k)
    t0 = time.time()
    for _ in range(2):
        state, metrics = step(state, data)
        barrier(dev, metrics)
    wu = time.time() - t0
    per_step = cfg.dsteps + cfg.gsteps
    n_disp = max(1, HEADLINE_STEPS_PER_WINDOW // k)
    # one untimed settle window after the warm-up
    for _ in range(2 * n_disp):
        state, metrics = step(state, data)
    barrier(dev, metrics)
    ips = []
    for _ in range(HEADLINE_WINDOWS):
        t0 = time.time()
        for _ in range(n_disp):
            state, metrics = step(state, data)
        barrier(dev, metrics)
        elapsed = time.time() - t0
        ips.append(n_disp * k * per_step * cfg.batch_size / elapsed)
    med = statistics.median(ips)
    out = {"images_per_sec": round(med, 2),
           "windows": [round(w, 1) for w in ips],
           "min": round(min(ips), 2), "max": round(max(ips), 2),
           "pool_samples": pool,
           "final_mmd2": round(float(metrics["d_loss_mmd2"]), 5)}
    flops = macro_step_flops(cfg.replace(steps_per_dispatch=1), cfg.dsteps, cfg.gsteps, dev)
    out["flops_per_macro_step"] = flops
    out.update(_rates(flops, med, per_step * cfg.batch_size, dev))
    print(f"# device-resident B={batch_size} K={k} "
          f"(warmup {wu:.0f}s): {med:.0f} img/s "
          f"(windows={['%.0f' % w for w in ips]}, "
          f"mfu={out.get('mfu', 'n/a')})", flush=True)
    return out


def _measure_sampling(batch: int = 512, windows: int = 3, device="cuda") -> dict:
    """Generator-serving throughput: eval-mode ``sample`` from the EMA
    weights (when tracked), latents from a ``torch.Generator`` of its own.
    A window ends on ``torch.cuda.synchronize``."""
    from smmdax_torch.train import create_state, sample, sample_flops
    cfg = _flagship_cfg(batch)
    state = create_state(cfg, 0, device=device)
    dev = state.device
    n = batch * 4

    def draw(seed: int) -> None:
        sample(cfg, state, torch.Generator(device=dev).manual_seed(seed), n)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    draw(1)
    wu = time.time() - t0
    ips = []
    for i in range(windows):
        t0 = time.time()
        draw(2 + i)
        ips.append(n / (time.time() - t0))
    med = statistics.median(ips)
    out = {"images_per_sec": round(med, 2), "batch": batch,
           "windows": [round(w, 1) for w in ips]}
    if peak_flops(dev) is not None:
        out.update(_rates(sample_flops(cfg, n, dev), med, n, dev))
    print(f"# sampling B={batch} (warmup {wu:.0f}s): "
          f"{med:.0f} img/s (windows={['%.0f' % w for w in ips]}, "
          f"mfu={out.get('mfu', 'n/a')})", flush=True)
    return out


def _device_line(device: torch.device) -> str:
    """The device's name and platform, and why there is no mfu where
    there is none."""
    if device.type != "cuda":
        return "device=cpu platform=cpu (no mfu: the CPU has no peak in PEAK_FLOPS)"
    name = torch.cuda.get_device_name(device)
    why = "" if name in PEAK_FLOPS else " (no mfu: this card has no peak in PEAK_FLOPS)"
    return f"device={name} platform=gpu{why}"


def main(argv=None) -> None:
    from smmdax_torch.train import resolve_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; nothing falls back to the CPU)")
    device = resolve_device(p.parse_args(argv).device)

    t_all = time.time()
    skipped: list[str] = []
    result: dict = {
        "metric": "images/sec/chip (CIFAR-10 32x32 sn-smmd resnet train)",
        "value": None,
        "unit": "images/sec",
    }

    def budget_left() -> float:
        return BUDGET_S - (time.time() - t_all)

    def _bail(signum, frame):  # SIGALRM at budget / SIGTERM from outside
        if result.get("value"):
            result["skipped_arms"] = skipped + [
                f"<signal {signum} mid-arm at {time.time() - t_all:.0f}s>"]
            # a buffered print() inside a handler can raise "reentrant
            # call" and lose the line: async-signal-safe os.write, with a
            # leading newline so the JSON owns its line
            os.write(1, b"\n" + json.dumps(result).encode() + b"\n")
            os._exit(0)
        os._exit(3)

    def arm_alarm() -> None:
        """SIGALRM backstop for the OPTIONAL arms, armed only once the
        headline is on the pipe, so it can never leave nothing emitted."""
        try:
            if BUDGET_S >= 60:
                signal.alarm(max(1, int(budget_left())))
        except ValueError:
            pass

    prev_handlers = {}
    try:  # main thread only; harmless to skip elsewhere
        for s in (signal.SIGALRM, signal.SIGTERM):
            prev_handlers[s] = signal.signal(s, _bail)
    except ValueError:
        pass
    # synchronization marker for subprocess tests: signals delivered
    # after this line reach _bail, not the default disposition
    print("# bench: signal handlers installed", flush=True)

    try:
        _run_arms(result, skipped, budget_left, arm_alarm, device)
    finally:
        try:
            signal.alarm(0)
            for s, h in prev_handlers.items():
                signal.signal(s, h)
        except ValueError:
            pass
    result["skipped_arms"] = skipped
    result["total_bench_time_s"] = round(time.time() - t_all, 1)
    _emit(result)
    print(f"# {_device_line(device)} "
          f"K={HEADLINE_K} total_bench_time={time.time() - t_all:.0f}s "
          f"final_mmd2={result.get('final_mmd2')} skipped={skipped}",
          flush=True)


def _emit(result: dict) -> None:
    """Print the whole result as ONE JSON line, after every completed arm:
    the first and the last JSON line both hold the complete headline."""
    print(json.dumps(result), flush=True)


def _run_arms(result: dict, skipped: list, budget_left,
              arm_alarm=lambda: None, device="cuda") -> None:
    def emit() -> None:
        _emit(result)

    # --- REQUIRED arm: device-resident flagship, B=64, K=16 -----------
    dev_res = _measure_device_resident(HEADLINE_BATCH, HEADLINE_K,
                                       pool=POOL_SAMPLES, device=device)
    ips = dev_res["images_per_sec"]
    result.update({
        "value": ips,
        "vs_baseline": None,
        "vs_prev_round": None,
        "steps_per_dispatch": HEADLINE_K,
        "data_placement": "device",
        **{k: v for k, v in dev_res.items() if k != "images_per_sec"},
        "device_resident": {k: v for k, v in dev_res.items()
                            if k in ("images_per_sec", "min", "max", "mfu")},
    })
    emit()  # the headline lands NOW; everything past here is optional
    arm_alarm()

    # --- optional arms, budget-gated, cheapest / most valuable first ---
    def run_arm(name: str, est_s: float, fn) -> None:
        if budget_left() < est_s:
            skipped.append(name)
            print(f"# skipping {name}: {budget_left():.0f}s left "
                  f"< {est_s:.0f}s estimate", flush=True)
            return
        try:
            fn()
            emit()
        except Exception as e:  # an optional arm must not lose the headline
            skipped.append(f"{name} (failed: {type(e).__name__})")
            print(f"# arm {name} FAILED: {e!r:.200}", flush=True)

    def _sampling():
        result["sampling"] = _measure_sampling(SAMPLING_BATCH, device=device)

    def _host_fed():
        h = _Harness(HEADLINE_BATCH, HOST_K, device)
        h.warmup()
        host_fed = _measure(h, windows=N_WINDOWS,
                            steps_per_window=STEPS_PER_WINDOW,
                            tag=f"host-fed K={HOST_K} B={HEADLINE_BATCH}")
        result["host_fed"] = {k: v for k, v in host_fed.items()
                              if k in ("images_per_sec", "min", "max", "mfu")}

    def _batch_point(b: int):
        def _f():
            result.setdefault("batch_sweep", {})
            v = _measure_on_device_sweep(b, HOST_K, device)
            result["batch_sweep"][str(b)] = {
                "images_per_sec": v["images_per_sec"], "mfu": v.get("mfu")}
        return _f

    def _dispatch_point(k: int):
        def _f():
            # every sweep entry is host-fed: the HOST_K point is the
            # host_fed arm's, never the device-resident headline's
            result.setdefault("dispatch_sweep", {})
            hf = result.get("host_fed")
            if hf and str(HOST_K) not in result["dispatch_sweep"]:
                result["dispatch_sweep"][str(HOST_K)] = hf["images_per_sec"]
            h = _Harness(HEADLINE_BATCH, k, device)
            wu = h.warmup()
            v = _measure(h, windows=2, steps_per_window=STEPS_PER_WINDOW,
                         tag=f"K={k} B={HEADLINE_BATCH} (warmup {wu:.0f}s)")
            result["dispatch_sweep"][str(k)] = v["images_per_sec"]
        return _f

    # estimates in seconds: generous against the arms' time on the card
    run_arm("sampling", 60, _sampling)
    run_arm("host_fed", 180, _host_fed)
    for b in BATCH_SWEEP:
        run_arm(f"batch_sweep_B{b}", 180, _batch_point(b))
    for k in DISPATCH_SWEEP:
        run_arm(f"dispatch_sweep_K{k}", 180, _dispatch_point(k))


if __name__ == "__main__":
    main()
