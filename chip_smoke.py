#!/usr/bin/env python3
"""Drive the PyTorch port (``smmdax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure:

1. build the hand-written CUDA kernels from ``smmdax_torch/csrc`` (nvcc,
   sm_90a) and print the build time;
2. hold both pair-sum kernels to their plain PyTorch versions on the card
   (gaussian, rq, rq + add_dot, distance, dot; self blocks without the
   diagonal and cross blocks; at 64x16, ragged 100x60x16, 4096x16 and
   8192x128), and the ``fused_mmd2`` gradients to the dense oracle's; time
   kernels and plain versions with CUDA events;
3. the flagship training macro-step at full width (sn-smmd, rq mixture,
   ResNet G/D at gf=df=64, z 128, dof 16, B 64, 5 critic + 1 generator
   updates, hutchinson sigma, EMA 0.9999, bf16, fused MMD on): timed
   macro-steps with the kernels' launch counters read around them, a
   torch.profiler trace of two more, two float32 macro-steps with TF32
   off, and 256 samples from the EMA generator.

The last lines are a ``{"kernels": [...]}`` line, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, without a CUDA device or without the
package beside this script.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores, the pipes these kernels use
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

VALUE_RTOL, VALUE_ATOL = 2e-4, 1e-5          # tests/test_pallas.py:40
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6            # tests/test_pallas.py:69-72
# raw pair_sum_grad_a rows are sums of n terms that cancel (rowsum*a - G@b):
# held to the plain version at GRAD_RTOL of their largest entry
RAW_GRAD_SCALE_TOL = 2e-4

KINDS = [("gaussian", (1.0, 2.0, 4.0, 8.0, 16.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.0),
         ("rq+add_dot", (0.2, 0.5, 1.0, 2.0, 5.0), 0.5),
         ("distance", (), 0.0),
         ("dot", (), 0.0)]
SHAPES = [(64, 64, 16), (100, 60, 16), (4096, 4096, 16), (8192, 8192, 128)]
SLICE_SHAPE = (64, 64, 16)
TIMED_STEPS = 10          # bf16 macro-steps timed after one warm-up


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mixture_ops(kernel: str, params, add_dot: float) -> tuple:
    """float32 operations per pair of the mixture value and its g, each
    exp/log1p/sqrt counted as one."""
    if kernel == "gaussian":
        return 3 * len(params), 4 * len(params)
    if kernel == "rq":
        return 5 * len(params) + (2 if add_dot else 0), 6 * len(params)
    return 3, 3                                          # distance


def bound_ms(kind: str, m: int, n: int, d: int, exclude_diag: bool,
             kernel: str, params, add_dot: float) -> tuple:
    """Least time on the card, max(bytes / HBM rate, ops / FP32 rate), and
    which of the two sets it.  Bytes: inputs read once, output written
    once.  Ops: the pairs this call computes (the diagonal excluded where
    masked)."""
    pairs = m * n - (min(m, n) if exclude_diag else 0)
    k_ops, g_ops = mixture_ops(kernel, params, add_dot)
    if kind == "fwd":
        ops = pairs * (2 * d + 4 + k_ops)                # dot, d2, mixture, sum
        out_bytes = 4
    else:
        ops = pairs * (2 * d + 4 + g_ops + 2 * d + 2) + 3 * m * d   # + G@b, rowsum
        out_bytes = 4 * m * d
    nbytes = 4 * (m + n) * d + out_bytes
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes > by_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_kernels(results: dict) -> dict:
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.kernels import kernel_matrices, mmd2

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    slice_err = {"fwd": 0.0, "bwd": 0.0}
    slice_times = {}
    for (m, n, d) in SHAPES:
        a = torch.randn(m, d, device="cuda", generator=gen) * 0.7
        b = torch.randn(n, d, device="cuda", generator=gen) * 0.7 + 0.3
        iters = 200 if m * n <= 10**4 else 20
        fused_err = fused_scale = 0.0
        for label, params, add_dot in KINDS:
            kernel, params, add_dot = mk.canon_kernel(label.split("+")[0], params, add_dot)
            for other, excl in ((a, True), (b, False)):
                k = float(mk.pair_sum(a, other, kernel, params, excl, add_dot))
                p = float(mk.pair_sum_plain(a, other, kernel, params, excl, add_dot))
                if not abs(k - p) <= VALUE_ATOL + VALUE_RTOL * abs(p):
                    fail(f"pair_sum {label} {(m, n, d)} excl={excl}: {k} vs plain {p}")
                gk = mk.pair_sum_grad_a(a, other, kernel, params, excl, add_dot)
                gp = mk.pair_sum_grad_a_plain(a, other, kernel, params, excl, add_dot)
                gerr = float((gk - gp).abs().max())
                gscale = float(gp.abs().max())
                if not gerr <= RAW_GRAD_SCALE_TOL * gscale + 1e-6:
                    fail(f"pair_sum_grad_a {label} {(m, n, d)} excl={excl}: "
                         f"max err {gerr} at scale {gscale}")
                row = dict(kernel=label, m=m, n=n if not excl else m, d=d, self_block=excl,
                           fwd_abs_err=abs(k - p), bwd_max_abs_err=gerr, bwd_scale=gscale)
                if excl and label == "rq":
                    # time the flagship's kernel kind on every shape
                    for kind, fn, plain in (
                            ("fwd", lambda: mk.pair_sum(a, other, kernel, params, excl, add_dot),
                             lambda: mk.pair_sum_plain(a, other, kernel, params, excl, add_dot)),
                            ("bwd", lambda: mk.pair_sum_grad_a(a, other, kernel, params, excl, add_dot),
                             lambda: mk.pair_sum_grad_a_plain(a, other, kernel, params, excl, add_dot))):
                        row[f"{kind}_ms"] = time_ms(fn, iters)
                        row[f"{kind}_plain_ms"] = time_ms(plain, max(iters // 4, 5))
                        row[f"{kind}_bound_ms"], row[f"{kind}_bound_by"] = bound_ms(
                            kind, m, m, d, True, kernel, params, add_dot)
                    if (m, n, d) == SLICE_SHAPE:
                        slice_times = row
                if (m, n, d) == SLICE_SHAPE and label == "rq" and excl:
                    slice_err["fwd"] = abs(k - p)
                    slice_err["bwd"] = gerr
                rows.append(row)
            # fused_mmd2 gradients through the autograd.Function vs the dense oracle
            xs = a.clone().requires_grad_()
            ys = b.clone().requires_grad_()
            mk.fused_mmd2(xs, ys, label.split("+")[0], params if label != "dot" else (),
                          add_dot=add_dot).backward()
            xo = a.clone().requires_grad_()
            yo = b.clone().requires_grad_()
            name = label.split("+")[0]
            mmd2(kernel_matrices(name, xo, yo, rbf_sigmas=params, rq_alphas=params,
                                 add_dot=add_dot)).backward()
            for got, want, which in ((xs.grad, xo.grad, "x"), (ys.grad, yo.grad, "y")):
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
                    fail(f"fused_mmd2 d/d{which} {label} {(m, n, d)}: max err {err}")
                fused_err = max(fused_err, err)
                fused_scale = max(fused_scale, float(want.abs().max()))
            del xs, ys, xo, yo
        log(f"kernels vs plain at {(m, n, d)}: ok; fused_mmd2 gradients within "
            f"{fused_err:.3g} abs of the dense oracle (largest entry {fused_scale:.3g})")
        results.setdefault("fused_grad", []).append(
            dict(m=m, n=n, d=d, max_abs_err=fused_err, scale=fused_scale))
    torch.cuda.synchronize()
    results["kernel_rows"] = rows
    for r in rows:
        if "fwd_ms" in r:
            log("  rq self-block m={m} d={d}: fwd {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}, "
                "bound {fwd_bound_ms:.6f}); bwd {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}, "
                "bound {bwd_bound_ms:.6f})".format(**r))
    return dict(times=slice_times, err=slice_err)


# ---------------------------------------------------------------------------
# phase 3: the slice at full width


def flagship_config(dtype: str):
    from smmdax_torch.configs import Config
    return Config(model="sn-smmd", kernel="rq", architecture="resnet",
                  dataset="synthetic", output_size=32, batch_size=64,
                  real_batch_size=64, gf_dim=64, df_dim=64, z_dim=128,
                  dof_dim=16, dsteps=5, gsteps=1, learning_rate=1e-4,
                  beta1=0.5, beta2=0.9, scaling_coeff=10.0,
                  scaling_grad_estimator="hutchinson", ema_decay=0.9999,
                  compute_dtype=dtype, use_pallas="on")


def profile_steps(step, state, batches, results: dict) -> None:
    """torch.profiler over two macro-steps: device busy share of the step
    time and the kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for real in batches[:2]:
            state, _ = step(state, real)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    rows = [dict(name=e.key[:90], calls=e.count, device_ms=e.self_device_time_total / 1e3 / 2)
            for e in top]
    # the profiler's own cost swells the profiled wall time, so the busy
    # share is taken against the unprofiled step time measured before
    share = busy / 2e3 / results["ms_per_macro_step"]
    results["profile"] = dict(wall_ms_per_macro_step=wall_us / 1e3 / 2,
                              device_busy_ms_per_macro_step=busy / 1e3 / 2,
                              device_busy_share_of_step=share,
                              kernels_per_macro_step=sum(e.count for e in events) / 2,
                              top=rows)
    log(f"profile (2 macro-steps): device busy {busy / 2e3:.2f} ms per macro-step, "
        f"{100 * share:.1f}% of the unprofiled {results['ms_per_macro_step']:.2f} ms step "
        f"(profiled wall {wall_us / 2e3:.2f} ms); "
        f"{sum(e.count for e in events) / 2:.0f} kernels per macro-step")
    for r in rows:
        log(f"  {r['device_ms']:8.3f} ms {r['calls'] / 2:6.0f}x  {r['name']}")


def run_slice(cfg, steps: int, label: str, results: dict,
              profile: bool = False) -> tuple:
    """create_state + build_train_step over ``steps`` timed macro-steps
    after one warm-up; returns (state, launches per macro-step)."""
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.data import SyntheticImages, macro_batch_at
    from smmdax_torch.train import build_train_step, create_state

    state = create_state(cfg, seed=0, device="cuda")
    step = build_train_step(cfg, cfg.dsteps, cfg.gsteps)
    src = SyntheticImages(size=cfg.output_size, channels=cfg.c_dim, seed=cfg.random_seed)
    per_step = cfg.dsteps + cfg.gsteps
    batches = [macro_batch_at(src, s, per_step, cfg.real_batch_size,
                              u8=cfg.uint8_transfer)
               for s in range(steps + 1)]
    mk.pair_sum.launches = 0
    mk.pair_sum_grad_a.launches = 0
    state, metrics = step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        state, metrics = step(state, batches[s])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    fwd, bwd = mk.pair_sum.launches, mk.pair_sum_grad_a.launches
    values = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"{label}: non-finite metrics {values}")
    if fwd == 0 or bwd == 0:
        fail(f"{label}: the main path did not launch both kernels ({fwd}, {bwd})")
    n_steps = steps + 1
    per = (fwd / n_steps, bwd / n_steps)
    imgs = per_step * cfg.batch_size / dt
    log(f"{label}: {dt * 1e3:.2f} ms per macro-step, {imgs:.1f} images/s "
        f"({steps} timed after 1 warm-up); launches per macro-step: "
        f"pair_sum {per[0]:g}, pair_sum_grad_a {per[1]:g}; metrics "
        + " ".join(f"{k}={v:.5g}" for k, v in values.items()))
    results[label] = dict(ms_per_macro_step=dt * 1e3, images_per_s=imgs,
                          launches=dict(pair_sum=fwd, pair_sum_grad_a=bwd,
                                        macro_steps=n_steps), metrics=values)
    if profile:
        profile_steps(step, state, batches, results[label])
    return state, (fwd, bwd)


def check_fused_loss(cfg, state) -> None:
    """The MMD^2 objective through the kernels equals the dense oracle on
    the trained state's features."""
    import torch
    from smmdax_torch.data import SyntheticImages, normalize_uint8
    from smmdax_torch.losses import mmd2_objective
    src = SyntheticImages(size=cfg.output_size, channels=cfg.c_dim, seed=cfg.random_seed)
    real = normalize_uint8(torch.from_numpy(src.batch_u8(cfg.batch_size, key=10**6)).cuda())
    with torch.no_grad():
        z = torch.rand((cfg.batch_size, cfg.z_dim), device="cuda") * 2 - 1
        f_fake = state.disc(state.gen(z, train=True))
        f_real = state.disc(real)
        fused = float(mmd2_objective(cfg, f_fake, f_real))
        dense = float(mmd2_objective(cfg.replace(use_pallas="off"), f_fake, f_real))
    if not abs(fused - dense) <= VALUE_ATOL + VALUE_RTOL * abs(dense):
        fail(f"flagship MMD^2 fused {fused} vs dense {dense}")
    log(f"flagship MMD^2 on trained features: fused {fused:.6g}, dense {dense:.6g}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write all results as JSON here")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "smmdax_torch")):
        print("chip_smoke: the smmdax_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from smmdax_torch.cuda import build
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.train import sample

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    results = {}

    # phase 1
    _, nvcc_log, secs = build.build()
    log(f"build: {secs:.1f} s for {build.SOURCE}")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
    results["build_s"] = secs

    # phase 2
    t0 = time.perf_counter()
    slice_k = check_kernels(results)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    # phase 3
    cfg = flagship_config("bfloat16")
    state, (fwd, bwd) = run_slice(cfg, TIMED_STEPS, "flagship bf16", results,
                                  profile=True)
    check_fused_loss(cfg, state)
    imgs = sample(cfg, state, torch.Generator(device="cuda").manual_seed(1), n=256)
    torch.cuda.synchronize()
    if imgs.shape != (256,) + cfg.image_shape or not bool(torch.isfinite(imgs).all()) \
            or float(imgs.abs().max()) > 1.0:
        fail(f"sample: shape {tuple(imgs.shape)}, range/finiteness off")
    log(f"sample: 256 EMA images {tuple(imgs.shape)} in [{float(imgs.min()):.3f}, "
        f"{float(imgs.max()):.3f}]")
    del state
    run_slice(flagship_config("float32"), 1, "flagship f32", results)

    t = slice_k["times"]
    kernels = [
        dict(name="pair_sum_fwd", route="cuda", source="smmdax_torch/csrc/pair_sum.cu",
             replaces="smmdax/pallas/mmd_kernel.py:141", launches=fwd,
             max_abs_err=slice_k["err"]["fwd"], ms=t["fwd_ms"], plain_ms=t["fwd_plain_ms"],
             bound_ms=t["fwd_bound_ms"], bound_by=t["fwd_bound_by"], library_ms=None),
        dict(name="pair_sum_grad_a", route="cuda", source="smmdax_torch/csrc/pair_sum.cu",
             replaces="smmdax/pallas/mmd_kernel.py:186", launches=bwd,
             max_abs_err=slice_k["err"]["bwd"], ms=t["bwd_ms"], plain_ms=t["bwd_plain_ms"],
             bound_ms=t["bwd_bound_ms"], bound_by=t["bwd_bound_by"], library_ms=None),
    ]
    card = card_line()
    results.update(kernels=kernels, card=card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
