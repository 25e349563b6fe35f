#!/usr/bin/env python3
"""Drive the PyTorch port (``smmdax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --tree DIR --only profile
    python3 chip_smoke.py --only ranks
    python3 chip_smoke.py --only inception

(The second form profiles the bf16 steps of phases 3 and 4 of the
``smmdax_torch`` in DIR, e.g. an earlier commit unpacked by ``git
archive``, to compare its kernels' device time with this tree's.  The
third runs phase 9 alone, the fourth phase 10.)

Phases, each fatal on failure:

1. build the hand-written CUDA kernels from ``smmdax_torch/csrc`` (one
   nvcc per source, side by side, sm_90a) and print the build time;
2. hold both pair-sum kernels to their plain PyTorch versions on the card
   (gaussian, rq, rq + add_dot, distance, dot; self blocks without the
   diagonal and cross blocks; at 64x16, ragged 100x60x16, 4096x16 and
   8192x128, and at shapes ragged against the 16/32/64 tiles and
   64-feature chunks): the forward, the da-only gradient and the one-sweep
   gradient (da only, db only, both; c = 0.7); a second launch on the same
   inputs must repeat the first bit for bit; the ``fused_mmd2`` gradients
   to the dense oracle's; time kernels (the gradient da only and da + db)
   and plain versions with CUDA events, and ``fused_mmd2`` forward +
   backward against the dense ``mmd2(kernel_matrices(...))`` at 64 to 4096
   rows per side (rq, d 16);
2b. the same for both pair-stats kernels (non-zero u, v and c): rows,
   columns and sum of squares of the one-sweep forward, da and db of the
   one-sweep gradient, and the single-side ``pair_stats`` /
   ``pair_stats_grad_a`` calls, also at shapes ragged against their tiles;
   a second launch on the same inputs must repeat the first bit for bit;
   and the ``make_pair_stats`` gradients to the dense oracle's;
3. the flagship training macro-step at full width (sn-smmd, rq mixture,
   ResNet G/D at gf=df=64, z 128, dof 16, B 64, 5 critic + 1 generator
   updates, hutchinson sigma, EMA 0.9999, bf16, fused MMD on): timed
   macro-steps with the kernels' launch counters read around them, a
   torch.profiler trace of two more (device time by kernel, and each csrc
   kernel's device us per launch), one float32 macro-step with TF32
   off, and 256 samples from the EMA generator;
4. the data-parallel tmmd step at full width, as the per-rank program of
   a one-rank NCCL group on cuda:0 (the flagship networks without SN,
   model tmmd, ``use_ring_mmd``, B 64 per rank): timed macro-steps with
   all four kernels' launch counters read around them and a profile, one
   float32 macro-step, the ring (MMD^2, t-ratio) against the dense
   estimator on the trained features, and the critic's gradients under
   the ring against the single-device dense tmmd loss's.  With two or more
   cards, also the ring loss and gradient on two ranks, one per card,
   against the one-rank result;
5. the training run: ``exp/cifar10_sn_smmd_resnet.sh``'s flags at full
   width cut to 24 macro-steps with every event inside (samples,
   checkpoints, scoring and the scheduler), deterministic, and a second
   run resumed from step 12 in a fresh process, equal bit for bit;
6. the three DCGAN families at their ``exp/`` flags (gf/df 64, z 128, B
   64, 5 + 1 updates, float32): ``cifar10_smmd_dcgan.sh`` (smmd, exact
   sigma), ``cifar10_mmd_gp.sh`` (mmd, witness penalty 1) and
   ``cifar10_wgan_gp.sh`` (dof 1, penalty 10 two-sided): timed and
   profiled macro-steps with the launch counters read around them, finite
   metrics, and the fused MMD^2 held to the dense one on trained features;
7. a training run of ``exp/toy_gaussian_mix.sh``'s flags cut to
   ``TOY_STEPS`` macro-steps with samples inside: every dispatch gets
   float32 batches, ``witness_fn`` is finite on the card, ``plot_toy_frame``
   draws nothing without matplotlib, and the MMD^2 between 2048 generated
   and 2048 real samples is printed at the start and the end;
8. device-resident data and remat: the flagship's training run with
   ``data_placement="device"`` at K=16 against host-fed at K=4, in turns
   (host, device, device, host), images/s as the median of the log
   windows after the first; K=1 and K=4 under device placement bit for
   bit; a device-placed run resumed in a fresh process equal bit for bit
   to the straight one; and one macro-step at
   ``exp/celeba160_sn_smmd_resnet.sh``'s model flags on synthetic 160 px
   data with remat off and on: the critic's and the generator's gradients
   equal to rel 1e-6, peak device memory and ms per macro-step of each;
9. two ranks, one per card over NCCL with two or more cards, else both on
   cuda:0 over gloo through a ``DataAxis`` of this script that stages
   every collective through the host (which collectives gloo carries on
   CUDA tensors itself is printed): (a) two GSPMD macro-steps of the
   flagship at B 64 per rank against one device at B 128 on the same
   batches and draws, at float32 and bf16, the ranks' states equal bit
   for bit; at float32 the metrics (rtol 2e-3 / atol 2e-5) and every
   tensor of the critic and the generator, BN running statistics
   included (rtol 5e-3 / atol 1e-4 in L2 form), each widened by 3x the
   farthest of three row-permuted one-device runs, and the same gate must
   refuse two known-wrong steps (per-rank BatchNorm statistics, and that
   with a per-rank MMD); (b) ``exp/imagenet64_sn_smmd_
   multichip.sh``'s flags at 2 ranks (ring, K 4) on synthetic 64 px data
   through the trainer, cut to 16 macro-steps with a checkpoint, scoring
   and the scheduler inside, only rank 0 writing, and a run resumed from
   8 in fresh processes equal bit for bit; (c) the sharded device pool,
   K=1 and K=4 bit for bit; (d) ms per macro-step and images/s of the
   GSPMD and ring steps at 2 ranks against one rank at B 128, with the
   launches per macro-step, and rank 0's device busy and collective time;
10. Inception-v3 at full width from random torchvision-schema weights (the
   repo holds no real ones): (a) the 1000-way torchvision form and the
   1008-way FID form on the card against the port's own float64
   evaluation on the CPU, 8 images of 32 px, pool3 and logits within rel
   1e-4 of their largest entry, under deterministic algorithms, a repeat
   sweep bit-equal; (b) images/s of ``pool3_and_probs`` at batch 64 and
   256 over 4,096 32 px images with TF32 off (the scoring path) and on
   (reported only, with its feature and FID gap), FLOPs per image from
   ``FlopCounterMode`` and the share of the card's FP32 peak, and the
   profiler's device busy share; (c) the flags of
   ``exp/cifar10_sn_smmd_resnet.sh`` through the trainer with only a
   random-weights ``inception_v3.npz`` in ``--data_dir``, cut to 8
   macro-steps with one scoring event at the configured 25,000 samples
   (features left on the card, FID, KID and IS finite), then one at phase
   5's 2,048; (d) ``python -m smmdax_torch.compute_scores`` in a fresh
   process on two uint8 sets of 5,000 32 px images with ``--compare``;
   (e) the trained EMA generator exported at batch 512 and loaded in a
   fresh process with torch alone, equal to ``sample`` on the same z to
   1e-6, and images/s of the loaded program against eager ``sample``.

The last lines are a ``{"kernels": [...]}`` line, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, without a CUDA device or without the
package beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
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
# make_pair_stats gradients against the dense oracle: rtol 5e-4 / atol 1e-5
# as tests/test_ring.py:199-200 (48x8), plus 2e-5 of the largest entry: an
# entry sums m*n terms of up to that size, and the kernels lie up to
# 5.0e-6 of it from the oracle at 8192x128 (3.4e-7 at 64x16)
STATS_GRAD_RTOL, STATS_GRAD_ATOL, STATS_GRAD_SCALE_TOL = 5e-4, 1e-5, 2e-5
RATIO_RTOL = 5e-4                              # tests/test_ring.py:129-130
# critic gradients of the ring against the dense tmmd loss: rtol 1e-3 as
# tests/test_shardmap_mode.py:191, whose atol 2e-5 is 1.1e-5 of that test's
# largest entry (1.77).  A deep critic's gradients are larger, and the
# dense float32 loss's own error is 2.2e-5 of the largest entry (the ring's
# 8.8e-6; both against float64, tiny tmmd state on the CPU), so the atol is
# 1e-4 of the largest entry.  The float64 dense loss is printed beside it:
# at full width it differs from both float32 losses by the critic's own
# float32 error, far more than they differ from each other.
DP_GRAD_RTOL, DP_GRAD_SCALE_TOL = 1e-3, 1e-4
STATS_C = 0.7                                  # c_sq of the stats-gradient checks

KINDS = [("gaussian", (1.0, 2.0, 4.0, 8.0, 16.0), 0.0),
         ("rq", (0.2, 0.5, 1.0, 2.0, 5.0), 0.0),
         ("rq+add_dot", (0.2, 0.5, 1.0, 2.0, 5.0), 0.5),
         ("distance", (), 0.0),
         ("dot", (), 0.0)]
SHAPES = [(64, 64, 16), (100, 60, 16), (4096, 4096, 16), (8192, 8192, 128)]
# shapes ragged against the stats kernels' 16/32/64 tiles and 64-feature chunks
RAGGED_STATS_SHAPES = [(1, 7, 3), (33, 17, 5), (130, 70, 130)]
SLICE_SHAPE = (64, 64, 16)
DENSE_VS_FUSED_ROWS = (64, 256, 1024, 4096)    # rows per side, rq, d 16
TIMED_STEPS = 10          # bf16 macro-steps timed after one warm-up

# phase 5: the flags of exp/cifar10_sn_smmd_resnet.sh, then the cut to 24
# macro-steps with every event of the training run inside them
FLAGSHIP_TRAIN_FLAGS = [
    "--is_train", "true", "--dataset", "cifar10", "--architecture", "resnet",
    "--model", "sn-smmd", "--kernel", "rq", "--batch_size", "64", "--output_size", "32",
    "--dof_dim", "16", "--learning_rate", "1e-4", "--beta1", "0.5", "--beta2", "0.9",
    "--dsteps", "5", "--start_dsteps", "10", "--scaling_coeff", "10.0",
    "--max_iteration", "150000", "--MMD_lr_scheduler", "true", "--decay_rate", "0.8",
    "--compute_scores", "true", "--score_every", "2000", "--compute_dtype", "bfloat16",
    "--scaling_grad_estimator", "hutchinson", "--steps_per_dispatch", "4",
    "--ema_decay", "0.9999"]
TRAINER_CUT_FLAGS = [
    "--dataset", "synthetic", "--max_iteration", "24", "--warmup_iterations", "8",
    "--log_every", "4", "--sample_every", "12", "--checkpoint_every", "12",
    "--score_every", "12", "--no_of_samples", "2048", "--score_subsets", "10",
    "--scheduler_test_size", "1000", "--scheduler_patience", "1"]


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
    masked).  ``kind``: fwd / bwd / bwd2 (pair_sum, pair_sum_grad_a: da
    only, pair_sum_grad: da and db from one sweep), stats_fwd / stats_bwd
    (pair_stats, pair_stats_grad_a: rows / da only), stats2_fwd /
    stats2_bwd (pair_block_stats, pair_block_stats_grad: rows and columns,
    da and db from one sweep)."""
    pairs = m * n - (min(m, n) if exclude_diag else 0)
    k_ops, g_ops = mixture_ops(kernel, params, add_dot)
    in_bytes = 4 * (m + n) * d
    if kind == "fwd":
        ops = pairs * (2 * d + 4 + k_ops)                # dot, d2, mixture, sum
        out_bytes = 4
    elif kind == "bwd":
        ops = pairs * (2 * d + 4 + g_ops + 2 * d + 2) + 3 * m * d   # + G@b, rowsum
        out_bytes = 4 * m * d
    elif kind == "bwd2":
        # as bwd, plus the column sum and G'^T a; both outputs, and c
        ops = pairs * (2 * d + 4 + g_ops + 4 * d + 3) + 3 * (m + n) * d
        in_bytes += 4
        out_bytes = 4 * (m + n) * d
    elif kind == "stats_fwd":
        ops = pairs * (2 * d + 4 + k_ops + 2)            # + k^2 and the row sum
        out_bytes = 4 * m + 4
    elif kind == "stats2_fwd":
        ops = pairs * (2 * d + 4 + k_ops + 3)            # + k^2, row and column sums
        out_bytes = 4 * (m + n) + 4
    elif kind == "stats2_bwd":
        # as stats_bwd, plus the column sum and T'^T a; both outputs
        ops = pairs * (2 * d + 4 + k_ops + g_ops + 5 + 2 + 4 * d) + 3 * (m + n) * d
        in_bytes += 4 * (m + n) + 4
        out_bytes = 4 * (m + n) * d
    else:
        # k and g both; coeff = u + v + 2ck, coeff*g, coeff*(g - add_dot/2);
        # the row sum and T'@b
        ops = pairs * (2 * d + 4 + k_ops + g_ops + 5 + 1 + 2 * d) + 3 * m * d
        in_bytes += 4 * (m + n) + 4                      # u, v, c
        out_bytes = 4 * m * d
    nbytes = in_bytes + out_bytes
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes > by_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _sum_errs(mk, a, other, c, kernel, kp, excl, ad) -> dict:
    """Errors of the pair-sum wrappers against their plain versions: the
    forward, the da-only gradient (c = 1) and the one-sweep gradient (da
    only, db only, both; scale 2, cotangent c), and whether a second launch
    on the same inputs repeats the first bit for bit."""
    import torch
    s = mk.pair_sum(a, other, kernel, kp, excl, ad)
    p = float(mk.pair_sum_plain(a, other, kernel, kp, excl, ad))
    ga = mk.pair_sum_grad_a(a, other, kernel, kp, excl, ad)
    p_ga = mk.pair_sum_grad_a_plain(a, other, kernel, kp, excl, ad)
    p_da, p_db = mk.pair_sum_grad_plain(a, other, c, kernel, kp, excl, ad, scale=2.0)
    out = dict(fwd_abs_err=abs(float(s) - p), sum=p,
               repeat_identical=torch.equal(s, mk.pair_sum(a, other, kernel, kp, excl, ad))
               and torch.equal(ga, mk.pair_sum_grad_a(a, other, kernel, kp, excl, ad)))
    checks = [("da_unit", ga, p_ga)]
    for need_a, need_b, tag in ((True, True, "both"), (True, False, "a"), (False, True, "b")):
        got = mk.pair_sum_grad(a, other, c, kernel, kp, excl, ad, need_a=need_a,
                               need_b=need_b, scale=2.0)
        again = mk.pair_sum_grad(a, other, c, kernel, kp, excl, ad, need_a=need_a,
                                 need_b=need_b, scale=2.0)
        out["repeat_identical"] &= all(
            (g is None and g2 is None) or torch.equal(g, g2) for g, g2 in zip(got, again))
        if need_a:
            checks.append((f"da_{tag}", got[0], p_da))
        if need_b:
            checks.append((f"db_{tag}", got[1], p_db))
    for name, got, want in checks:
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        out[f"{name}_scale"] = float(want.abs().max())
    return out


def _sum_failures(e: dict, where: str) -> list:
    """The checks of one ``_sum_errs`` result: S at VALUE_RTOL /
    VALUE_ATOL, every gradient at RAW_GRAD_SCALE_TOL of its largest
    entry, repeated launches identical."""
    bad = []
    if not e["fwd_abs_err"] <= VALUE_ATOL + VALUE_RTOL * abs(e["sum"]):
        bad.append(f"pair_sum {where}: err {e['fwd_abs_err']} at {e['sum']}")
    for key in [k for k in e if k.endswith("_max_abs_err")]:
        name = key[:-len("_max_abs_err")]
        err, scale = e[key], e[f"{name}_scale"]
        if not err <= RAW_GRAD_SCALE_TOL * scale + 1e-6:
            bad.append(f"pair-sum gradient {name} {where}: max err {err} at scale {scale}")
    if not e["repeat_identical"]:
        bad.append(f"pair-sum kernels {where}: a second launch on the same inputs differs")
    return bad


def _sum_timings(mk, a, c, kernel, kp, ad, iters: int) -> dict:
    """CUDA-event ms of the forward, the da-only gradient and the one-sweep
    da + db gradient, and their plain versions, on the self block of ``a``
    (no diagonal), with their bounds."""
    m, d = a.shape
    out = {}
    for kind, fn, plain in (
            ("fwd", lambda: mk.pair_sum(a, a, kernel, kp, True, ad),
             lambda: mk.pair_sum_plain(a, a, kernel, kp, True, ad)),
            ("bwd", lambda: mk.pair_sum_grad_a(a, a, kernel, kp, True, ad),
             lambda: mk.pair_sum_grad_a_plain(a, a, kernel, kp, True, ad)),
            ("bwd2", lambda: mk.pair_sum_grad(a, a, c, kernel, kp, True, ad, scale=2.0),
             lambda: mk.pair_sum_grad_plain(a, a, c, kernel, kp, True, ad, scale=2.0))):
        out[f"{kind}_ms"] = time_ms(fn, iters)
        out[f"{kind}_plain_ms"] = time_ms(plain, max(iters // 4, 5))
        out[f"{kind}_bound_ms"], out[f"{kind}_bound_by"] = bound_ms(
            kind, m, m, d, True, kernel, kp, ad)
    return out


def check_kernels(results: dict) -> dict:
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.kernels import kernel_matrices, mmd2

    gen = torch.Generator(device="cuda").manual_seed(0)
    failures, rows = [], []
    slice_err = {"fwd": 0.0, "bwd": 0.0}
    slice_times = {}
    c = torch.tensor(STATS_C, device="cuda")
    for (m, n, d) in SHAPES + RAGGED_STATS_SHAPES:
        a = torch.randn(m, d, device="cuda", generator=gen) * 0.7
        b = torch.randn(n, d, device="cuda", generator=gen) * 0.7 + 0.3
        iters = 200 if m * n <= 10**4 else 20
        fused_err = fused_scale = 0.0
        for label, params, add_dot in KINDS:
            kernel, kp, ad = mk.canon_kernel(label.split("+")[0], params, add_dot)
            for other, excl in ((a, True), (b, False)):
                nb = other.shape[0]
                errs = _sum_errs(mk, a, other, c, kernel, kp, excl, ad)
                failures += _sum_failures(errs, f"{label} {(m, nb, d)} excl={excl}")
                row = dict(kernel=label, m=m, n=nb, d=d, self_block=excl, **errs)
                if excl and label == "rq" and (m, n, d) in SHAPES:
                    # time the flagship's kernel kind on every shape
                    row.update(_sum_timings(mk, a, c, kernel, kp, ad, iters))
                    if (m, n, d) == SLICE_SHAPE:
                        slice_times = row
                        slice_err = dict(fwd=errs["fwd_abs_err"],
                                         bwd=max(v for k, v in errs.items()
                                                 if k.endswith("_max_abs_err")))
                rows.append(row)
            if (m, n, d) not in SHAPES:
                continue
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
                    failures.append(f"fused_mmd2 d/d{which} {label} {(m, n, d)}: max err {err}")
                fused_err = max(fused_err, err)
                fused_scale = max(fused_scale, float(want.abs().max()))
            del xs, ys, xo, yo
        if (m, n, d) in SHAPES:
            log(f"pair-sum kernels vs plain at {(m, n, d)}: checked; fused_mmd2 gradients "
                f"within {fused_err:.3g} abs of the dense oracle (largest entry "
                f"{fused_scale:.3g})")
            results.setdefault("fused_grad", []).append(
                dict(m=m, n=n, d=d, max_abs_err=fused_err, scale=fused_scale))
        else:
            log(f"pair-sum kernels vs plain at {(m, n, d)}: checked")
    torch.cuda.synchronize()
    results["kernel_rows"] = rows
    for r in rows:
        if "fwd_ms" in r:
            log("  rq self-block m={m} d={d}: fwd {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}, "
                "bound {fwd_bound_ms:.6f}); da-only bwd {bwd_ms:.4f} ms (plain "
                "{bwd_plain_ms:.4f}, bound {bwd_bound_ms:.6f}); one-sweep da+db "
                "{bwd2_ms:.4f} ms (plain {bwd2_plain_ms:.4f}, bound {bwd2_bound_ms:.6f})"
                .format(**r))
    if failures:
        fail(f"{len(failures)} pair-sum checks failed: " + "; ".join(failures[:20]))
    return dict(times=slice_times, err=slice_err)


def time_dense_vs_fused(results: dict) -> None:
    """CUDA-event ms of one ``fused_mmd2`` forward + backward (the kernels)
    and one dense ``mmd2(kernel_matrices(...))`` forward + backward, rq, d
    16, at 64 to 4096 rows per side: the yardstick for the ``auto``
    dispatch threshold (``cuda/dispatch.py``), not a switch."""
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.kernels import kernel_matrices, mmd2
    params = (0.2, 0.5, 1.0, 2.0, 5.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = []
    for rows in DENSE_VS_FUSED_ROWS:
        x = (torch.randn(rows, 16, device="cuda", generator=gen) * 0.7).requires_grad_()
        y = (torch.randn(rows, 16, device="cuda", generator=gen) * 0.7 + 0.3).requires_grad_()
        iters = 50 if rows <= 1024 else 10

        def fused():
            torch.autograd.grad(mk.fused_mmd2(x, y, "rq", params), (x, y))

        def dense():
            torch.autograd.grad(mmd2(kernel_matrices("rq", x, y, rq_alphas=params)), (x, y))

        row = dict(rows=rows, d=16, fused_ms=time_ms(fused, iters),
                   dense_ms=time_ms(dense, iters))
        out.append(row)
        log(f"fused_mmd2 vs dense mmd2, fwd+bwd, rq, {rows}x16: fused {row['fused_ms']:.4f} ms, "
            f"dense {row['dense_ms']:.4f} ms")
    results["dense_vs_fused"] = out


# ---------------------------------------------------------------------------
# phase 2b: the pair-stats kernels against their plain versions


def _stats_errs(mk, a, other, u, v, c, kernel, kp, excl, ad) -> dict:
    """Errors of the stats wrappers against their plain versions, and
    whether a second launch on the same inputs repeats the first bit for
    bit."""
    import torch
    rows, cols, sq = mk.pair_block_stats(a, other, kernel, kp, excl, ad)
    p_rows, p_cols, p_sq = mk.pair_block_stats_plain(a, other, kernel, kp, excl, ad)
    da, db = mk.pair_block_stats_grad(a, other, u, v, c, kernel, kp, excl, ad)
    p_da, p_db = mk.pair_block_stats_grad_plain(a, other, u, v, c, kernel, kp, excl, ad)
    rows1, sq1 = mk.pair_stats(a, other, kernel, kp, excl, ad)
    da1 = mk.pair_stats_grad_a(a, other, u, v, c, kernel, kp, excl, ad)
    again = mk.pair_block_stats(a, other, kernel, kp, excl, ad) + \
        mk.pair_block_stats_grad(a, other, u, v, c, kernel, kp, excl, ad)
    out = {}
    for name, got, want in (("rows", rows, p_rows), ("cols", cols, p_cols),
                            ("rows_only", rows1, p_rows), ("da", da, p_da),
                            ("db", db, p_db), ("da_only", da1, p_da)):
        out[f"{name}_max_abs_err"] = float((got - want).abs().max())
        out[f"{name}_scale"] = float(want.abs().max())
    for name, got in (("sum_sq", sq), ("sum_sq_only", sq1)):
        out[f"{name}_abs_err"] = abs(float(got) - float(p_sq))
    out["sum_sq"] = float(p_sq)
    out["repeat_identical"] = all(torch.equal(x, y) for x, y in
                                  zip((rows, cols, sq, da, db), again))
    return out


def _stats_failures(e: dict, where: str) -> list:
    """The checks of one ``_stats_errs`` result.  A row or column sum adds
    terms that may cancel (the dot kernel's row i is <a_i, sum_j b_j>), so
    vectors of sums are held at VALUE_RTOL of their largest entry; da and
    db at RAW_GRAD_SCALE_TOL of theirs; sum_sq at VALUE_RTOL / VALUE_ATOL."""
    bad = []
    for name in ("rows", "cols", "rows_only"):
        err, scale = e[f"{name}_max_abs_err"], e[f"{name}_scale"]
        if not err <= VALUE_ATOL + VALUE_RTOL * scale:
            bad.append(f"{name} {where}: max err {err} at scale {scale}")
    for name in ("sum_sq", "sum_sq_only"):
        if not e[f"{name}_abs_err"] <= VALUE_ATOL + VALUE_RTOL * abs(e["sum_sq"]):
            bad.append(f"{name} {where}: err {e[f'{name}_abs_err']} at {e['sum_sq']}")
    for name in ("da", "db", "da_only"):
        err, scale = e[f"{name}_max_abs_err"], e[f"{name}_scale"]
        if not err <= RAW_GRAD_SCALE_TOL * scale + 1e-6:
            bad.append(f"{name} {where}: max err {err} at scale {scale}")
    if not e["repeat_identical"]:
        bad.append(f"{where}: a second launch on the same inputs differs")
    return bad


def _stats_timings(mk, a, u, v, c, kernel, kp, ad, iters: int) -> dict:
    """CUDA-event ms of the four stats wrappers and their plain versions on
    the self block of ``a`` (no diagonal), with their bounds."""
    m, d = a.shape
    out = {}
    for kind, fn, plain in (
            ("stats_fwd", lambda: mk.pair_stats(a, a, kernel, kp, True, ad),
             lambda: mk.pair_stats_plain(a, a, kernel, kp, True, ad)),
            ("stats_bwd", lambda: mk.pair_stats_grad_a(a, a, u, v, c, kernel, kp, True, ad),
             lambda: mk.pair_stats_grad_a_plain(a, a, u, v, c, kernel, kp, True, ad)),
            ("stats2_fwd", lambda: mk.pair_block_stats(a, a, kernel, kp, True, ad),
             lambda: mk.pair_block_stats_plain(a, a, kernel, kp, True, ad)),
            ("stats2_bwd",
             lambda: mk.pair_block_stats_grad(a, a, u, v, c, kernel, kp, True, ad),
             lambda: mk.pair_block_stats_grad_plain(a, a, u, v, c, kernel, kp, True, ad))):
        out[f"{kind}_ms"] = time_ms(fn, iters)
        out[f"{kind}_plain_ms"] = time_ms(plain, max(iters // 4, 5))
        out[f"{kind}_bound_ms"], out[f"{kind}_bound_by"] = bound_ms(
            kind, m, m, d, True, kernel, kp, ad)
    return out


def check_stats_kernels(results: dict) -> dict:
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.kernels import kernel_matrices

    gen = torch.Generator(device="cuda").manual_seed(1)
    failures, rows, oracle = [], [], []
    slice_err, slice_times = {}, {}
    c = torch.tensor(STATS_C, device="cuda")
    for (m, n, d) in SHAPES + RAGGED_STATS_SHAPES:
        a = torch.randn(m, d, device="cuda", generator=gen) * 0.7
        b = torch.randn(n, d, device="cuda", generator=gen) * 0.7 + 0.3
        iters = 200 if m * n <= 10**4 else 20
        for label, params, add_dot in KINDS:
            name = label.split("+")[0]
            kernel, kp, ad = mk.canon_kernel(name, params, add_dot)
            for other, excl in ((a, True), (b, False)):
                nb = other.shape[0]
                u = torch.randn(m, device="cuda", generator=gen)
                v = torch.randn(nb, device="cuda", generator=gen)
                errs = _stats_errs(mk, a, other, u, v, c, kernel, kp, excl, ad)
                failures += _stats_failures(errs, f"{label} {(m, nb, d)} excl={excl}")
                row = dict(kernel=label, m=m, n=nb, d=d, self_block=excl, **errs)
                if excl and label == "rq" and (m, n, d) in SHAPES:
                    row.update(_stats_timings(mk, a, u, v, c, kernel, kp, ad, iters))
                    if (m, n, d) == SLICE_SHAPE:
                        slice_times = row
                        slice_err = dict(
                            fwd=max(errs["rows_max_abs_err"], errs["cols_max_abs_err"],
                                    errs["sum_sq_abs_err"]),
                            bwd=max(errs["da_max_abs_err"], errs["db_max_abs_err"]))
                rows.append(row)
            # make_pair_stats gradients against the dense oracle
            for excl in (False, True):
                bb = a if excl else b
                u = torch.randn(m, device="cuda", generator=gen)
                v = torch.randn(bb.shape[0], device="cuda", generator=gen)
                stats = mk.make_pair_stats(name, params, excl, add_dot=add_dot)

                def fused(aa, cc):
                    r_, c_, s_ = stats(aa, cc)
                    return u @ r_ + v @ c_ + 0.3 * s_

                def dense(aa, cc):
                    km = kernel_matrices(name, aa, cc, rbf_sigmas=params, rq_alphas=params,
                                         add_dot=add_dot).k_xy
                    if excl:
                        km = km - torch.diag(torch.diagonal(km))
                    return u @ km.sum(1) + v @ km.sum(0) + 0.3 * (km * km).sum()

                got, want = (_grads(f, a, bb) for f in (fused, dense))
                for which, g_, w_ in zip("ab", got, want):
                    err, scale = float((g_ - w_).abs().max()), float(w_.abs().max())
                    oracle.append(dict(kernel=label, m=m, n=bb.shape[0], d=d, self_block=excl,
                                       arg=which, max_abs_err=err, scale=scale))
                    if not torch.allclose(g_, w_, rtol=STATS_GRAD_RTOL,
                                          atol=STATS_GRAD_ATOL + STATS_GRAD_SCALE_TOL * scale):
                        bad = float(((g_ - w_).abs() - STATS_GRAD_RTOL * w_.abs()).max())
                        failures.append(f"make_pair_stats d/d{which} {label} {(m, bb.shape[0], d)} "
                                        f"excl={excl}: max err {err} at scale {scale} "
                                        f"(worst excess over rtol {bad})")
        worst = max((o["max_abs_err"] / max(o["scale"], 1e-30) for o in oracle
                     if o["m"] == m), default=0.0)
        log(f"stats kernels vs plain at {(m, n, d)}: checked; make_pair_stats gradients "
            f"within {worst:.3g} of their largest entry of the dense oracle")
    torch.cuda.synchronize()
    results["stats_kernel_rows"] = rows
    results["stats_oracle_grads"] = oracle
    for r in rows:
        if "stats_fwd_ms" in r:
            log("  rq self-block m={m} d={d}: rows-only fwd {stats_fwd_ms:.4f} ms (plain "
                "{stats_fwd_plain_ms:.4f}, bound {stats_fwd_bound_ms:.6f}); da-only bwd "
                "{stats_bwd_ms:.4f} ms (plain {stats_bwd_plain_ms:.4f}, bound "
                "{stats_bwd_bound_ms:.6f}); one-sweep fwd {stats2_fwd_ms:.4f} ms (plain "
                "{stats2_fwd_plain_ms:.4f}, bound {stats2_fwd_bound_ms:.6f}); one-sweep "
                "da+db {stats2_bwd_ms:.4f} ms (plain {stats2_bwd_plain_ms:.4f}, bound "
                "{stats2_bwd_bound_ms:.6f})".format(**r))
    if failures:
        fail(f"{len(failures)} pair-stats checks failed: " + "; ".join(failures[:20]))
    return dict(times=slice_times, err=slice_err)


def _grads(f, a, b):
    """d f / d(a, b), with a and b as separate leaves (a self block too)."""
    import torch
    aa = a.clone().requires_grad_()
    bb = b.clone().requires_grad_()
    return torch.autograd.grad(f(aa, bb), (aa, bb))


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


# The CUDA kernels (csrc/*.cu) behind each of the four launch counters:
# every counted launch runs each of its parts once.  Names of this tree's
# kernels and of the earlier ones (pair_sum_tiles + sum_partials,
# pair_sum_grad_rows, pair_stats_rows + sum_partials,
# pair_stats_grad_rows), so that a profile of an earlier tree reads alike.
KERNEL_PARTS = {
    "pair_sum": ("pair_sum_tiles", "pair_sum_sum", "sum_partials"),
    "pair_sum_grad_a": ("pair_sum_grad_tiles", "pair_sum_grad_sum", "pair_sum_grad_rows"),
    "pair_stats": ("pair_stats_tiles", "pair_stats_sum", "pair_stats_rows", "sum_partials"),
    "pair_stats_grad_a": ("pair_stats_grad_tiles", "pair_stats_grad_sum",
                          "pair_stats_grad_rows"),
}


def csrc_device_us(events, launches: dict) -> dict:
    """{counter: device us per counted launch}: the profiler's mean device
    time per call of each part, summed over the parts present.  A part
    shared by two counters (sum_partials) counts at its mean."""
    import re
    per_part = {}
    for part in {p for parts in KERNEL_PARTS.values() for p in parts}:
        hits = [e for e in events if re.search(rf"\b{part}\b", e.key)]
        calls = sum(e.count for e in hits)
        if calls:
            per_part[part] = (calls, sum(e.self_device_time_total for e in hits) / calls)
    out = {}
    for name, parts in KERNEL_PARTS.items():
        present = [p for p in parts if p in per_part]
        if launches.get(name) and present:
            # the earlier pair_stats forward ran sum_partials too; the new
            # one runs pair_stats_sum instead
            if name == "pair_stats" and "pair_stats_rows" not in per_part:
                present = [p for p in present if p != "sum_partials"]
            out[name] = sum(per_part[p][1] for p in present)
    out["parts"] = {p: dict(calls=c, us_per_call=t) for p, (c, t) in per_part.items()}
    return out


def profile_steps(step, state, batches, results: dict) -> None:
    """torch.profiler over two macro-steps: device busy share of the step
    time, the kernels that take the device time, and each csrc kernel's
    device us per launch."""
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
    # collectives: NCCL's kernels, and the host copies of a staged group
    coll = sum(e.self_device_time_total for e in events
               if "nccl" in e.key.lower() or "memcpy" in e.key.lower())
    results["profile"] = dict(wall_ms_per_macro_step=wall_us / 1e3 / 2,
                              device_busy_ms_per_macro_step=busy / 1e3 / 2,
                              device_busy_share_of_step=share,
                              collective_ms_per_macro_step=coll / 1e3 / 2,
                              kernels_per_macro_step=sum(e.count for e in events) / 2,
                              top=rows)
    log(f"profile (2 macro-steps): device busy {busy / 2e3:.2f} ms per macro-step, "
        f"{100 * share:.1f}% of the unprofiled {results['ms_per_macro_step']:.2f} ms step "
        f"(profiled wall {wall_us / 2e3:.2f} ms); "
        f"{sum(e.count for e in events) / 2:.0f} kernels per macro-step")
    for r in rows:
        log(f"  {r['device_ms']:8.3f} ms {r['calls'] / 2:6.0f}x  {r['name']}")
    launches = {k: v for k, v in results["launches"].items() if k != "macro_steps"}
    dev = csrc_device_us(events, launches)
    results["profile"]["csrc_device_us_per_launch"] = dev
    log("  csrc kernels, device us per launch: "
        + ", ".join(f"{k} {v:.2f}" for k, v in dev.items() if k != "parts")
        + "; by part: " + ", ".join(f"{p} {d['calls'] / 2:g}x {d['us_per_call']:.2f} us"
                                   for p, d in sorted(dev["parts"].items())))


def run_slice(cfg, steps: int, label: str, results: dict, required,
              profile: bool = False, axis=None) -> tuple:
    """create_state + build_train_step (the per-rank program when ``axis``
    is given) over ``steps`` timed macro-steps after one warm-up, with
    every kernel's launch count set to 0 just before and read just after;
    fails unless each kernel named in ``required`` was launched.  Returns
    (state, {kernel: launches})."""
    import torch
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.data import SyntheticImages, macro_batch_at
    from smmdax_torch.train import build_train_step, create_state

    device = "cuda" if axis is None else axis.device
    state = create_state(cfg, seed=0, device=device, rank=0 if axis is None else axis.index)
    step = build_train_step(cfg, cfg.dsteps, cfg.gsteps, axis=axis)
    src = SyntheticImages(size=cfg.output_size, channels=cfg.c_dim, seed=cfg.random_seed)
    per_step = cfg.dsteps + cfg.gsteps
    batches = [macro_batch_at(src, s, per_step, cfg.real_batch_size,
                              u8=cfg.uint8_transfer)
               for s in range(steps + 1)]
    counters = mk.kernel_launch_counters()
    for k in counters:
        k.launches = 0
    state, metrics = step(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        state, metrics = step(state, batches[s])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = {k.__name__: k.launches for k in counters}
    values = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in values.values()):
        fail(f"{label}: non-finite metrics {values}")
    missing = [k for k in required if launches[k] == 0]
    if missing:
        fail(f"{label}: the main path did not launch {missing} ({launches})")
    n_steps = steps + 1
    imgs = per_step * cfg.batch_size / dt
    log(f"{label}: {dt * 1e3:.2f} ms per macro-step, {imgs:.1f} images/s "
        f"({steps} timed after 1 warm-up); launches per macro-step: "
        + ", ".join(f"{k} {v / n_steps:g}" for k, v in launches.items())
        + "; metrics " + " ".join(f"{k}={v:.5g}" for k, v in values.items()))
    results[label] = dict(ms_per_macro_step=dt * 1e3, images_per_s=imgs,
                          launches=dict(launches, macro_steps=n_steps), metrics=values)
    if profile:
        profile_steps(step, state, batches, results[label])
    return state, launches


def check_fused_loss(cfg, state, label: str = "flagship") -> None:
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
        fail(f"{label} MMD^2 fused {fused} vs dense {dense}")
    log(f"{label} MMD^2 on trained features: fused {fused:.6g}, dense {dense:.6g}")


# ---------------------------------------------------------------------------
# phase 4: the data-parallel tmmd ring step at full width


def tmmd_ring_config(dtype: str):
    """The flagship's networks, widths and optimiser with model tmmd (no
    SN, no sigma) and the ring estimators; B 64 per rank."""
    from smmdax_torch.configs import Config
    return Config(model="tmmd", kernel="rq", architecture="resnet",
                  dataset="synthetic", output_size=32, batch_size=64,
                  real_batch_size=64, gf_dim=64, df_dim=64, z_dim=128,
                  dof_dim=16, dsteps=5, gsteps=1, learning_rate=1e-4,
                  beta1=0.5, beta2=0.9, ema_decay=0.9999, compute_dtype=dtype,
                  use_pallas="on", use_ring_mmd=True)


def _eval_batches(cfg, state, device):
    """A real batch and a fake batch (no gradient) for the loss checks."""
    import torch
    from smmdax_torch.data import SyntheticImages, normalize_uint8
    src = SyntheticImages(size=cfg.output_size, channels=cfg.c_dim, seed=cfg.random_seed)
    real = normalize_uint8(torch.from_numpy(src.batch_u8(cfg.batch_size, key=10**6)).to(device))
    gen = torch.Generator(device=device).manual_seed(7)
    with torch.no_grad():
        z = torch.rand((cfg.batch_size, cfg.z_dim), device=device, generator=gen) * 2 - 1
        fake = state.gen(z, train=True)
    return real, fake


def check_ring_loss(cfg, state, axis, results: dict) -> None:
    """The ring (MMD^2, t-ratio) through the stats kernels equals the dense
    estimator on the trained state's features."""
    import torch
    from smmdax_torch.kernels import kernel_matrices, mmd2_and_ratio
    from smmdax_torch.parallel import ring_mmd2_and_ratio
    real, fake = _eval_batches(cfg, state, axis.device)
    with torch.no_grad():
        f_fake, f_real = state.disc(fake), state.disc(real)
        val, ratio = ring_mmd2_and_ratio(f_fake, f_real, axis, cfg.kernel,
                                         rq_alphas=cfg.rq_alphas, use_pallas=True)
        dval, dratio = mmd2_and_ratio(kernel_matrices(cfg.kernel, f_fake, f_real,
                                                      rq_alphas=cfg.rq_alphas))
    val, ratio, dval, dratio = (float(t) for t in (val, ratio, dval, dratio))
    if not abs(val - dval) <= VALUE_ATOL + VALUE_RTOL * abs(dval):
        fail(f"ring tmmd MMD^2 {val} vs dense {dval}")
    if not abs(ratio - dratio) <= 1e-6 + RATIO_RTOL * abs(dratio):
        fail(f"ring tmmd ratio {ratio} vs dense {dratio}")
    results["ring_vs_dense"] = dict(mmd2=val, dense_mmd2=dval, ratio=ratio, dense_ratio=dratio)
    log(f"ring tmmd on trained features: MMD^2 {val:.7g} (dense {dval:.7g}), "
        f"ratio {ratio:.7g} (dense {dratio:.7g})")


def ring_critic_grads(cfg, disc, real, fake, axis):
    """(loss, ratio, pmean'd critic gradients) of the ring tmmd critic loss
    on this rank's block of ``real``/``fake`` (``axis``), or of the
    single-device dense tmmd loss (``axis`` None)."""
    import torch
    from smmdax_torch.losses import critic_loss
    if axis is not None:
        b = real.shape[0] // axis.size
        real = real[axis.index * b:(axis.index + 1) * b]
        fake = fake[axis.index * b:(axis.index + 1) * b]
    else:
        cfg = cfg.replace(use_ring_mmd=False)
    params = list(disc.parameters())
    loss, aux = critic_loss(cfg, disc, real, fake, axis=axis)
    grads = torch.autograd.grad(loss, params)
    if axis is not None:
        grads = [axis.pmean(g) for g in grads]
    return float(loss.detach()), float(aux.ratio.detach()), [g.detach() for g in grads]


def compare_grads(got, want, what: str) -> tuple:
    """Fails unless every gradient is within DP_GRAD_RTOL plus
    DP_GRAD_SCALE_TOL of the largest entry of ``want``; returns (max abs
    error, largest entry)."""
    import torch
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.allclose(g, w, rtol=DP_GRAD_RTOL, atol=DP_GRAD_SCALE_TOL * scale):
            fail(f"{what}: gradient {i} off by {float((g - w).abs().max())} "
                 f"(largest entry {scale}; max abs error {err})")
    return err, scale


def check_ring_critic_grads(cfg, state, axis, results: dict) -> tuple:
    """The critic's gradients under the ring equal those of the
    single-device dense tmmd loss.  Returns the inputs and the ring's
    result for the two-rank check."""
    import copy
    real, fake = _eval_batches(cfg, state, axis.device)
    loss, ratio, g_ring = ring_critic_grads(cfg, state.disc, real, fake, axis)
    dloss, dratio, g_dense = ring_critic_grads(cfg, state.disc, real, fake, None)
    _, _, g_64 = ring_critic_grads(cfg, copy.deepcopy(state.disc).double(),
                                   real.double(), fake.double(), None)
    if not abs(loss - dloss) <= 1e-5 + RATIO_RTOL * abs(dloss):
        fail(f"ring tmmd critic loss {loss} vs dense {dloss}")
    err, scale = compare_grads(g_ring, g_dense, "ring vs dense critic gradients")
    err64, dense64 = (max(float((g.double() - w).abs().max()) for g, w in zip(gs, g_64))
                      for gs in (g_ring, g_dense))
    results["ring_critic_grads"] = dict(loss=loss, dense_loss=dloss, max_abs_err=err,
                                        scale=scale, ring_vs_f64=err64,
                                        dense_vs_f64=dense64)
    log(f"ring tmmd critic gradients (float32): loss {loss:.7g} (dense {dloss:.7g}); "
        f"{len(g_ring)} tensors within {err:.3g} abs of the dense loss's "
        f"(largest entry {scale:.3g}); the float64 dense loss's lie {err64:.3g} "
        f"(ring) and {dense64:.3g} (dense) from them")
    return real, fake, (loss, ratio, g_ring)


def _two_rank_worker(rank: int, world: int, device_type: str, store: str,
                     payload_path: str, out_path: str) -> None:
    """One rank of the two-rank check: the ring tmmd critic loss and its
    pmean'd gradients on this rank's half of the batch."""
    import torch
    sys.path.insert(0, HERE)
    from smmdax_torch.configs import Config
    from smmdax_torch.nn import build_models
    from smmdax_torch.parallel import init_data_axis
    # a spawned process starts with PyTorch's defaults: cuDNN would run the
    # float32 critic's convolutions in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = f"cuda:{rank}" if device_type == "cuda" else "cpu"
    payload = torch.load(payload_path, weights_only=False)
    cfg = Config(**payload["cfg"])
    axis = init_data_axis(device, rank, world, store)
    try:
        _, disc = build_models(cfg, torch.Generator().manual_seed(0))
        disc.load_state_dict(payload["disc"])
        disc.to(device)
        loss, ratio, grads = ring_critic_grads(cfg, disc, payload["real"].to(device),
                                               payload["fake"].to(device), axis)
        if rank == 0:
            torch.save(dict(loss=loss, ratio=ratio, grads=[g.cpu() for g in grads]),
                       out_path)
    finally:
        axis.close()


def check_two_ranks(cfg, state, real, fake, one_rank, results: dict,
                    device_type: str = "cuda") -> None:
    """The ring tmmd loss and gradient on two ranks, one process per card,
    against the one-rank result."""
    import dataclasses
    import torch
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        payload = os.path.join(tmp, "payload.pt")
        out = os.path.join(tmp, "rank0.pt")
        torch.save(dict(cfg=dataclasses.asdict(cfg), disc=state.disc.state_dict(),
                        real=real.cpu(), fake=fake.cpu()), payload)
        procs = [ctx.Process(target=_two_rank_worker,
                             args=(r, 2, device_type, os.path.join(tmp, "store"), payload, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs) or not os.path.exists(out):
            fail(f"2-rank ring: exit codes {[p.exitcode for p in procs]}")
        got = torch.load(out, weights_only=False)
    loss, ratio, grads = one_rank
    if not abs(got["loss"] - loss) <= 1e-5 + RATIO_RTOL * abs(loss):
        fail(f"2-rank ring loss {got['loss']} vs one rank {loss}")
    err, scale = compare_grads(got["grads"], [g.cpu() for g in grads],
                               "2-rank vs one-rank ring critic gradients")
    results["two_rank_ring"] = dict(loss=got["loss"], one_rank_loss=loss,
                                    max_abs_err=err, scale=scale)
    log(f"2-rank ring (one card each): loss {got['loss']:.7g} (one rank {loss:.7g}); "
        f"gradients within {err:.3g} abs (largest entry {scale:.3g})")


# ---------------------------------------------------------------------------
# phase 5: the training run


@contextlib.contextmanager
def deterministic_torch():
    """Deterministic algorithms and cuDNN for the block, restored after
    (cuBLAS reads CUBLAS_WORKSPACE_CONFIG, set before CUDA starts)."""
    import torch
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


def _timed(obj, name: str, sink: list) -> None:
    """Wrap ``obj.name`` so each call's seconds, synchronised, go to ``sink``."""
    import torch
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapper)


def _log_rows(trainer) -> list:
    with open(trainer.writer.path) as f:
        return [json.loads(line) for line in f]


def _check_png(path: str) -> tuple:
    """(width, height) from the signature and IHDR of a PNG file."""
    import struct
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path}: no PNG signature / IHDR")
    return struct.unpack(">II", head[16:24])


def _state_diffs(a: dict, b: dict, where: str = "") -> list:
    """Paths at which two checkpoint dicts differ (tensors bit for bit)."""
    import torch
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [where or "/"]
        return [d for k in a for d in _state_diffs(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, torch.Tensor):
        return [] if isinstance(b, torch.Tensor) and torch.equal(a, b) else [where]
    return [] if a == b else [where]


def _resume_worker(tree: str, cfg_fields: dict, device: str, out_path: str) -> None:
    """Run B's second half in a fresh process, as a user resumes: a new
    ``Trainer`` from run B's step-12 checkpoint to 24; its final state goes
    to ``out_path``."""
    import torch
    sys.path.insert(0, tree)
    from smmdax_torch import checkpoint
    from smmdax_torch.configs import Config
    from smmdax_torch.trainer import Trainer
    # a spawned process starts with PyTorch's defaults (cuDNN in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with deterministic_torch():
        trainer = Trainer(Config(**cfg_fields), device=device)
        resumed_at = trainer.state.step
        state = trainer.train()
    torch.save(dict(resumed_at=resumed_at, state=checkpoint.state_dict(state)), out_path)


def run_trainer(tmp: str, results: dict, tree: str = HERE, device: str = "cuda") -> dict:
    """Phase 5 (see the module docstring).  Returns the kernels' launches
    in run A."""
    import dataclasses
    import torch
    from smmdax_torch import checkpoint
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.trainer import Trainer

    def cfg_for(run: str, max_iteration: int):
        dirs = [f"--{k}_dir" for k in ("checkpoint", "log", "sample")]
        return config_from_args(
            FLAGSHIP_TRAIN_FLAGS + TRAINER_CUT_FLAGS
            + [x for d in dirs for x in (d, os.path.join(tmp, run, d[2:]))]
            + ["--max_iteration", str(max_iteration)])

    t_phase = time.perf_counter()
    with deterministic_torch():
        cfg_a = cfg_for("A", 24)
        trainer_a = Trainer(cfg_a, device=device)
        score_s, save_s = [], []
        _timed(trainer_a, "_score", score_s)
        _timed(trainer_a.ckpt, "save", save_s)
        counters = mk.kernel_launch_counters()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        state_a = trainer_a.train()
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counters}
        rows_a = _log_rows(trainer_a)

        cfg_b = cfg_for("B", 12)
        Trainer(cfg_b, device=device).train()
    # the resume runs in a fresh process: nothing of this one's history
    # (allocator, autograd engine, cuDNN plans) may change the trajectory
    out = os.path.join(tmp, "resumed.pt")
    proc = multiprocessing.get_context("spawn").Process(
        target=_resume_worker, args=(tree, dataclasses.asdict(cfg_b.replace(max_iteration=24)),
                                     device, out))
    proc.start()
    proc.join(600)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0 or not os.path.exists(out):
        fail(f"trainer: the resuming process exited with {proc.exitcode}")
    resumed = torch.load(out, weights_only=True)
    if resumed["resumed_at"] != 12:
        fail(f"trainer: run B resumed at step {resumed['resumed_at']}, not 12")
    with open(os.path.join(cfg_b.log_dir, cfg_b.run_name() + ".jsonl")) as f:
        rows_b = [json.loads(line) for line in f]
    cfg = cfg_a

    missing = [k for k in ("pair_sum", "pair_sum_grad_a") if launches[k] == 0]
    if missing:
        fail(f"trainer: run A did not launch {missing} ({launches})")
    bad = [(r["step"], k) for r in rows_a + rows_b for k, v in r.items()
           if not math.isfinite(v)]
    if bad:
        fail(f"trainer: non-finite logged metrics {bad}")
    scores = {r["step"]: r for r in rows_a if "fid" in r}
    if sorted(scores) != [12, 24] or not all(
            {"fid", "kid", "kid_std", "lr_decayed"} <= set(r) for r in scores.values()):
        fail(f"trainer: score rows {scores}")
    meta = trainer_a.ckpt.best_meta()
    if "three_sample_p" in scores[24]:
        if "three_sample_t" not in scores[24]:
            fail(f"trainer: step-24 row {scores[24]}")
        decision = ("p-value test: p {three_sample_p:.4g}, t {three_sample_t:.4g}, "
                    "LR decayed {lr_decayed:g}".format(**scores[24]))
    elif meta["best_step"] == 24 and scores[24]["kid"] < scores[12]["kid"]:
        decision = "KID improved: the step-24 model became the best snapshot"
    else:
        fail(f"trainer: no scheduler decision at step 24 ({scores[24]}, meta {meta})")
    ckpt_dir = trainer_a.ckpt.directory
    if trainer_a.ckpt.latest_step() != 24 or not os.path.exists(
            os.path.join(ckpt_dir, "best", "state", "state.pt")):
        fail(f"trainer: checkpoints {os.listdir(ckpt_dir)}")
    pngs = [os.path.join(cfg.sample_dir, cfg.run_name(), f"sample_{s:07d}.png")
            for s in (12, 24)]
    sizes = [_check_png(p) for p in pngs]

    diffs = _state_diffs(checkpoint.state_dict(state_a), resumed["state"])
    if diffs:
        fail(f"trainer: resumed state differs from the uninterrupted one at {diffs[:20]}")
    score_b = next(r for r in rows_b if "fid" in r and r["step"] == 24)
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}
    if drop(score_b) != drop(scores[24]):
        fail(f"trainer: resumed step-24 scores {score_b} vs uninterrupted {scores[24]}")

    # images/s per log interval after the warm-up; an interval that
    # starts at a sample / checkpoint / scoring step also carries them
    rates = {r["step"]: r["images_per_sec"] for r in rows_a
             if "images_per_sec" in r and r["step"] > cfg.warmup_iterations}
    quiet = [v for s, v in rates.items() if (s - cfg.log_every) % 12 != 0]
    out = dict(launches=launches, wall_s_run_a=wall_a, images_per_s_by_log_row=rates,
               images_per_s=sorted(quiet)[len(quiet) // 2],
               macro_step_images_per_s=results["flagship bf16"]["images_per_s"],
               ms_per_score=[1e3 * t for t in score_s],
               ms_per_checkpoint_save=[1e3 * t for t in save_s],
               checkpoint_mb=os.path.getsize(os.path.join(ckpt_dir, "24.pt")) / 2**20,
               scores={s: drop(r) for s, r in scores.items()}, decision=decision,
               png_sizes=sizes, phase_s=time.perf_counter() - t_phase)
    results["trainer"] = out
    log(f"trainer: run A 24 macro-steps in {wall_a:.2f} s; launches {launches}")
    log("trainer: images/s per log row after warm-up "
        + ", ".join(f"step {s}: {v:.1f}" for s, v in rates.items())
        + f"; median of the rows without events {out['images_per_s']:.1f}, against "
          f"{out['macro_step_images_per_s']:.1f} for phase 3's bare macro-step")
    log("trainer: ms per scoring event " + ", ".join(f"{t:.1f}" for t in out["ms_per_score"])
        + "; ms per checkpoint save " + ", ".join(f"{t:.1f}" for t in out["ms_per_checkpoint_save"])
        + f" ({out['checkpoint_mb']:.1f} MB each)")
    log(f"trainer: scores at 12 {scores[12]['kid']:.5g} KID / {scores[12]['fid']:.5g} FID, "
        f"at 24 {scores[24]['kid']:.5g} / {scores[24]['fid']:.5g}; {decision}; PNGs {sizes}")
    log("trainer: run B (to 12, then resumed to 24 in a fresh process) equals run A bit "
        "for bit in every parameter, buffer, Adam moment, EMA shadow, lr, sched_fails and "
        "the generator state, and in its step-24 scores (deterministic algorithms on)")
    log(f"trainer phase: {out['phase_s']:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the DCGAN families


# the model flags of the three DCGAN exp/ scripts
DCGAN_FLAGS = {
    "dcgan smmd": ["--model", "smmd", "--kernel", "rq", "--batch_size", "64",
                   "--real_batch_size", "64", "--z_dim", "128", "--gf_dim", "64",
                   "--df_dim", "64", "--dof_dim", "16", "--learning_rate", "1e-4",
                   "--beta1", "0.5", "--beta2", "0.9", "--dsteps", "5",
                   "--with_scaling", "true", "--scaling_coeff", "10.0"],
    "dcgan mmd-gp": ["--model", "mmd", "--kernel", "rq", "--batch_size", "64",
                     "--dof_dim", "16", "--gradient_penalty", "1.0",
                     "--learning_rate", "1e-4", "--dsteps", "5"],
    "dcgan wgan-gp": ["--model", "wgan-gp", "--kernel", "rq", "--dof_dim", "1",
                      "--batch_size", "64", "--gradient_penalty", "10.0",
                      "--gp_variant", "two_sided", "--learning_rate", "1e-4",
                      "--dsteps", "5"],
}


def dcgan_config(label: str):
    from smmdax_torch.configs import config_from_args
    return config_from_args(["--dataset", "synthetic", "--architecture", "dcgan",
                             "--output_size", "32"] + DCGAN_FLAGS[label])


def run_dcgan(results: dict) -> dict:
    """Phase 6; returns {label: launches over the timed run}."""
    launches = {}
    for label in DCGAN_FLAGS:
        cfg = dcgan_config(label)
        required = () if cfg.model == "wgan-gp" else ("pair_sum", "pair_sum_grad_a")
        state, launches[label] = run_slice(cfg, TIMED_STEPS, label, results, required,
                                           profile=True)
        check_fused_loss(cfg, state, label)
        del state
    return launches


# ---------------------------------------------------------------------------
# phase 7: the toy


TOY_FLAGS = [
    "--is_train", "true", "--dataset", "gaussian_mix", "--architecture", "mlp",
    "--model", "mmd", "--kernel", "gaussian", "--rbf_sigmas", "0.1", "0.25", "0.5", "1.0",
    "--batch_size", "256", "--z_dim", "8", "--dof_dim", "8", "--learning_rate", "3e-3",
    "--dsteps", "3", "--start_dsteps", "3", "--max_iteration", "3000",
    "--MMD_lr_scheduler", "false", "--log_every", "200", "--sample_every", "500"]
TOY_STEPS = 300
TOY_CUT_FLAGS = ["--max_iteration", str(TOY_STEPS), "--log_every", "50",
                 "--sample_every", "100", "--checkpoint_every", "0"]


def _toy_mmd2(cfg, trainer) -> float:
    """MMD^2 (the config's kernel, dense) between 2048 generated samples and
    2048 real ones (the frames' key)."""
    import torch
    from smmdax_torch.kernels import kernel_matrices, mmd2
    from smmdax_torch.train import sample
    fake = sample(cfg, trainer.state, torch.Generator(device="cuda").manual_seed(0), 2048)
    real = torch.from_numpy(trainer.source.batch(2048, key=2**31)).cuda()
    return float(mmd2(kernel_matrices(cfg.kernel, fake, real, rbf_sigmas=cfg.rbf_sigmas)))


def run_toy(tmp: str, results: dict) -> dict:
    """Phase 7; returns the kernels' launches over the run."""
    import importlib.util

    import numpy as np
    import torch
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.trainer import Trainer
    from smmdax_torch.viz import plot_toy_frame, witness_fn

    dirs = [x for d in ("checkpoint", "log", "sample") for x in (f"--{d}_dir",
                                                                  os.path.join(tmp, d))]
    cfg = config_from_args(TOY_FLAGS + TOY_CUT_FLAGS + dirs)
    trainer = Trainer(cfg, device="cuda")
    mmd_start = _toy_mmd2(cfg, trainer)
    dtypes = set()
    get_step = trainer._get_step

    def recording(dsteps, k):
        fn = get_step(dsteps, k)

        def step(state, batch):
            dtypes.add(str(batch.dtype))
            return fn(state, batch)
        return step

    trainer._get_step = recording
    counters = mk.kernel_launch_counters()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    if dtypes != {"float32"}:
        fail(f"toy: the step received {dtypes} batches, not float32")
    missing = [k for k in ("pair_sum", "pair_sum_grad_a") if launches[k] == 0]
    if missing:
        fail(f"toy: the run did not launch {missing} ({launches})")
    rows = _log_rows(trainer)
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not math.isfinite(v)]
    if bad:
        fail(f"toy: non-finite logged metrics {bad}")
    mmd_end = _toy_mmd2(cfg, trainer)

    critic = trainer.toy_critic()
    real = trainer.source.batch(2048, key=2**31)
    grid = np.linspace(-1.3, 1.3, 301, dtype=np.float32)[:, None]
    with torch.no_grad():
        fake = trainer.state.gen(torch.rand((2048, cfg.z_dim), device="cuda") * 2 - 1)
        w = witness_fn(cfg, critic, grid, critic(real), critic(fake))
    if w.shape != (301,) or not np.isfinite(w).all():
        fail(f"toy: witness_fn gave shape {w.shape}, finite {np.isfinite(w).all()}")
    frames_dir = os.path.join(cfg.sample_dir, cfg.run_name())
    frames = sorted(os.listdir(frames_dir)) if os.path.isdir(frames_dir) else []
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if has_mpl:
        every = cfg.sample_every
        want = [f"toy_{s:07d}.png" for s in range(every, TOY_STEPS + 1, every)]
        if frames != want:
            fail(f"toy: frames {frames}, expected {want}")
    else:
        probe_dir = os.path.join(tmp, "frame_probe")
        if frames or plot_toy_frame(cfg, critic, real, fake.cpu().numpy(), 0,
                                    probe_dir) is not None or os.path.exists(probe_dir):
            fail(f"toy: without matplotlib something was drawn ({frames})")
    per_step = cfg.dsteps + cfg.gsteps
    rates = [r["images_per_sec"] for r in rows if "images_per_sec" in r]
    out = dict(launches=launches, launches_per_macro_step={k: v / TOY_STEPS for k, v in
                                                           launches.items()},
               wall_s=wall, ms_per_macro_step=1e3 * wall / TOY_STEPS,
               images_per_s_by_log_row=rates, mmd2_start=mmd_start, mmd2_end=mmd_end,
               witness_range=[float(w.min()), float(w.max())], matplotlib=has_mpl,
               frames=frames, batch_dtypes=sorted(dtypes))
    results["toy"] = out
    log(f"toy: {TOY_STEPS} macro-steps ({cfg.dsteps} + {cfg.gsteps} updates, B "
        f"{cfg.batch_size} fake / {cfg.real_batch_size} real) in {wall:.2f} s "
        f"({out['ms_per_macro_step']:.2f} ms per macro-step, {per_step} updates); "
        "images/s per log row " + ", ".join(f"{v:.1f}" for v in rates))
    log("toy: launches per macro-step " + ", ".join(
        f"{k} {v:g}" for k, v in out["launches_per_macro_step"].items()))
    log(f"toy: batches reached the step as {sorted(dtypes)}; witness on 301 points in "
        f"[{w.min():.4g}, {w.max():.4g}]; matplotlib {'present' if has_mpl else 'absent'}, "
        f"frames {frames}")
    log(f"toy: MMD^2 (2048 generated vs 2048 real, {cfg.kernel} {cfg.rbf_sigmas}) "
        f"{mmd_start:.6g} at step 0, {mmd_end:.6g} at step {TOY_STEPS}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: device-resident data and remat


DATA_ARM_STEPS = 64       # per arm run: 4 log windows of 16 macro-steps
DATA_ARM_CUT_FLAGS = [
    "--dataset", "synthetic", "--warmup_iterations", "0", "--log_every", "16",
    "--sample_every", "0", "--checkpoint_every", "0", "--compute_scores", "false",
    "--MMD_lr_scheduler", "false", "--max_iteration", str(DATA_ARM_STEPS)]
CELEBA160_MODEL_FLAGS = [
    "--dataset", "synthetic", "--architecture", "resnet", "--model", "sn-smmd",
    "--kernel", "rq", "--batch_size", "64", "--output_size", "160", "--dof_dim", "16",
    "--gf_dim", "32", "--df_dim", "32", "--learning_rate", "1e-4", "--dsteps", "5",
    "--scaling_coeff", "10.0", "--compute_dtype", "bfloat16",
    "--scaling_grad_estimator", "hutchinson", "--ema_decay", "0.9999"]
REMAT_REL_TOL = 1e-6


def _dirs(tmp: str, run: str) -> list:
    return [x for d in ("checkpoint", "log", "sample")
            for x in (f"--{d}_dir", os.path.join(tmp, run, d))]


def time_data_arms(tmp: str, results: dict) -> None:
    """The flagship's training run host-fed at K=4 and device-placed at
    K=16, in turns (host, device, device, host); images/s of each run is
    the median of its log windows after the first."""
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.trainer import Trainer
    arms = {"host K=4": ["--steps_per_dispatch", "4"],
            "device K=16": ["--steps_per_dispatch", "16", "--data_placement", "device"]}
    runs = {name: [] for name in arms}
    for i, name in enumerate(["host K=4", "device K=16", "device K=16", "host K=4"]):
        cfg = config_from_args(FLAGSHIP_TRAIN_FLAGS + DATA_ARM_CUT_FLAGS + arms[name]
                               + _dirs(tmp, f"arm{i}"))
        trainer = Trainer(cfg, device="cuda")
        t0 = time.perf_counter()
        trainer.train()
        wall = time.perf_counter() - t0
        rates = [r["images_per_sec"] for r in _log_rows(trainer) if "images_per_sec" in r]
        if len(rates) != DATA_ARM_STEPS // 16 or not all(math.isfinite(v) for v in rates):
            fail(f"{name}: log windows {rates}")
        after = sorted(rates[1:])
        runs[name].append(dict(windows=rates, median=after[len(after) // 2], wall_s=wall))
        log(f"{name} run {len(runs[name])}: images/s per 16-step window "
            + ", ".join(f"{v:.1f}" for v in rates)
            + f"; median after the first {runs[name][-1]['median']:.1f}; {wall:.2f} s")
        del trainer
    results["data_arms"] = runs
    med = {n: sorted(r["median"] for r in v) for n, v in runs.items()}
    log("data arms: device K=16 " + " / ".join(f"{v:.1f}" for v in med["device K=16"])
        + " images/s against host K=4 " + " / ".join(f"{v:.1f}" for v in med["host K=4"]))


def check_device_data_k_invariance(results: dict) -> None:
    """K=1 and K=4 under device placement give bit-identical states
    (deterministic algorithms on)."""
    import torch
    from smmdax_torch import checkpoint
    from smmdax_torch.data import SyntheticImages, materialize_u8
    from smmdax_torch.train import create_state, device_data_train_step
    cfg = flagship_config("bfloat16").replace(data_placement="device")
    src = SyntheticImages(size=32, channels=3, seed=cfg.random_seed)
    pool = torch.from_numpy(materialize_u8(src, 4096)).cuda()
    states = []
    with deterministic_torch():
        for k in (1, 4):
            step = device_data_train_step(cfg, cfg.dsteps, cfg.gsteps, steps_per_dispatch=k)
            state = create_state(cfg, seed=0, device="cuda")
            for _ in range(4 // k):
                state, metrics = step(state, pool)
            torch.cuda.synchronize()
            states.append(checkpoint.state_dict(state))
    diffs = _state_diffs(*states)
    if diffs:
        fail(f"device data: K=1 and K=4 differ at {diffs[:20]}")
    results["device_data_k_invariance"] = dict(macro_steps=4, identical=True)
    log("device data: 4 flagship macro-steps as 4 x K=1 and 1 x K=4 give bit-identical "
        "states (deterministic algorithms on)")


def check_device_data_resume(tmp: str, results: dict, tree: str) -> None:
    """A device-placed flagship run stopped at 8 and resumed to 16 in a
    fresh process equals the straight run to 16, bit for bit."""
    import dataclasses
    import torch
    from smmdax_torch import checkpoint
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.trainer import Trainer
    cut = ["--dataset", "synthetic", "--warmup_iterations", "4", "--log_every", "4",
           "--sample_every", "0", "--compute_scores", "false", "--MMD_lr_scheduler", "false",
           "--data_placement", "device", "--device_data_pool", "4096"]
    cfg = lambda run, n, ck: config_from_args(
        FLAGSHIP_TRAIN_FLAGS + cut + _dirs(tmp, run)
        + ["--max_iteration", str(n), "--checkpoint_every", str(ck)])
    with deterministic_torch():
        state_a = Trainer(cfg("dA", 16, 0), device="cuda").train()
        torch.cuda.synchronize()
        cfg_b = cfg("dB", 8, 8)
        Trainer(cfg_b, device="cuda").train()
    out = os.path.join(tmp, "device_resumed.pt")
    proc = multiprocessing.get_context("spawn").Process(
        target=_resume_worker, args=(tree, dataclasses.asdict(cfg_b.replace(max_iteration=16)),
                                     "cuda", out))
    proc.start()
    proc.join(600)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0 or not os.path.exists(out):
        fail(f"device data resume: the resuming process exited with {proc.exitcode}")
    resumed = torch.load(out, weights_only=True)
    if resumed["resumed_at"] != 8:
        fail(f"device data resume: resumed at step {resumed['resumed_at']}, not 8")
    diffs = _state_diffs(checkpoint.state_dict(state_a), resumed["state"])
    if diffs:
        fail(f"device data resume: differs from the straight run at {diffs[:20]}")
    results["device_data_resume"] = dict(resumed_at=8, steps=16, identical=True)
    log("device data: a device-placed run (K=4, warm-up to 4) stopped at 8 and resumed to "
        "16 in a fresh process equals the straight run bit for bit")


def _remat_grads(cfg, state, real, noise):
    """(critic loss, critic gradients, generator loss, generator gradients)
    of the first critic and generator updates' losses on ``state``."""
    import torch
    from smmdax_torch.losses import critic_loss, generator_loss
    from smmdax_torch.train import _refresh_spectral, critic_fn
    critic = critic_fn(cfg, state.disc)
    with torch.no_grad():
        fake = state.gen(noise["d_z"][0], train=True)
    _refresh_spectral(cfg, state.disc, "cuda")
    d_loss, _ = critic_loss(cfg, critic, real[0], fake, probe=noise["d_probe"][0])
    d_grads = torch.autograd.grad(d_loss, list(state.disc.parameters()))
    state.disc.requires_grad_(False)
    try:
        g_loss, _ = generator_loss(cfg, critic, real[-1], state.gen(noise["g_z"][0], train=True),
                                   probe=noise["g_probe"][0])
        g_grads = torch.autograd.grad(g_loss, list(state.gen.parameters()))
    finally:
        state.disc.requires_grad_(True)
    return [d_loss.detach(), *d_grads, g_loss.detach(), *g_grads]


def check_remat(results: dict) -> None:
    """Remat off and on at 160 px: gradients equal, then the peak memory and
    ms of macro-steps of each."""
    import torch
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.data import SyntheticImages, macro_batch_at
    from smmdax_torch.data.transforms import normalize_uint8
    from smmdax_torch.train import build_train_step, create_state, draw_noise
    base = config_from_args(CELEBA160_MODEL_FLAGS)
    per_step = base.dsteps + base.gsteps
    src = SyntheticImages(size=160, channels=3, seed=base.random_seed)
    batches = [macro_batch_at(src, s, per_step, base.real_batch_size, u8=True)
               for s in range(3)]
    real = normalize_uint8(torch.from_numpy(batches[0]).cuda())
    grads = {}
    with deterministic_torch():
        for remat in (False, True):
            cfg = base.replace(remat=remat)
            state = create_state(cfg, seed=0, device="cuda")
            noise = draw_noise(cfg, state, base.dsteps, base.gsteps)
            grads[remat] = _remat_grads(cfg, state, real, noise)
            del state
    worst = 0.0
    for i, (a, b) in enumerate(zip(grads[True], grads[False])):
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        worst = max(worst, err / max(scale, 1e-30))
        if not err <= REMAT_REL_TOL * scale:
            fail(f"remat: tensor {i} of the losses and gradients off by {err} at scale {scale}")
    del grads
    arms = {}
    for remat in (False, True):
        cfg = base.replace(remat=remat)
        state = create_state(cfg, seed=0, device="cuda")
        step = build_train_step(cfg, cfg.dsteps, cfg.gsteps)
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, metrics = step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            fail(f"remat={remat}: non-finite metrics")
        arms["on" if remat else "off"] = dict(ms_per_macro_step=ms, peak_gib=peak)
        del state, step
        torch.cuda.empty_cache()
    results["remat_160px"] = dict(worst_rel_err=worst, **arms)
    log(f"remat at 160 px (celeba160 model flags, B 64, bf16): losses and gradients of the "
        f"first critic and generator updates equal to {worst:.3g} of each tensor's largest "
        f"entry (bound {REMAT_REL_TOL}); remat off {arms['off']['ms_per_macro_step']:.1f} ms "
        f"per macro-step, peak {arms['off']['peak_gib']:.2f} GiB; remat on "
        f"{arms['on']['ms_per_macro_step']:.1f} ms, peak {arms['on']['peak_gib']:.2f} GiB")


# ---------------------------------------------------------------------------
# phase 9: several ranks at full width


RANKS = 2
RANK_TIMED_STEPS = 5
RANK_GROUP_TIMEOUT_S = 600
# exp/imagenet64_sn_smmd_multichip.sh at NCHIPS=2 (B 64 per rank).  The
# repo holds no ImageNet-64 npz, so the dataset falls back to the
# procedural source of the same shape (64 px)
MULTICHIP_FLAGS = [
    "--is_train", "true", "--dataset", "imagenet64", "--architecture", "resnet",
    "--model", "sn-smmd", "--kernel", "rq", "--batch_size", "128",
    "--real_batch_size", "128", "--output_size", "64", "--dof_dim", "16",
    "--num_data_shards", "2", "--use_ring_mmd", "true", "--learning_rate", "1e-4",
    "--dsteps", "5", "--scaling_coeff", "10.0", "--max_iteration", "150000",
    "--MMD_lr_scheduler", "true", "--compute_scores", "true", "--score_every", "5000",
    "--compute_dtype", "bfloat16", "--scaling_grad_estimator", "hutchinson",
    "--steps_per_dispatch", "4", "--ema_decay", "0.9999"]
MULTICHIP_CUT_FLAGS = [
    "--max_iteration", "16", "--warmup_iterations", "4", "--log_every", "4",
    "--sample_every", "8", "--checkpoint_every", "8", "--score_every", "8",
    "--no_of_samples", "2048", "--score_subsets", "10", "--scheduler_test_size", "1000",
    "--scheduler_patience", "1"]
# (a): 8 shards against one device in tests/test_train.py:87-92
GSPMD_METRIC_RTOL, GSPMD_METRIC_ATOL = 2e-3, 2e-5
GSPMD_PARAM_RTOL, GSPMD_PARAM_ATOL = 5e-3, 1e-4
# the float32 floor of (a): one device's own runs with the batch rows in
# FLOOR_RUNS other orders; 2 ranks may lie FLOOR_FACTOR times as far from
# one device as the farthest of them (after 10 critic updates the critic's
# outputs of such runs lie ~1% apart: Adam turns float32 summation-order
# noise in near-zero gradients into +-lr steps)
FLOOR_RUNS, FLOOR_FACTOR = 3, 3
# steps that the gate of (a) must refuse, each run like the GSPMD step on
# the ranks' rows of the same draws: shard_map mode, where BatchNorm takes
# each rank's own statistics; and that with each rank's own MMD estimator
WRONG_ARMS = {"per-rank BN": dict(dp_mode="shard_map"),
              "per-rank BN and MMD": dict(dp_mode="shard_map", global_batch_mmd=False)}


def gspmd_config(dtype: str):
    """The flagship at B 64 per rank over RANKS ranks, GSPMD mode."""
    return flagship_config(dtype).replace(batch_size=64 * RANKS,
                                          real_batch_size=64 * RANKS,
                                          num_data_shards=RANKS)


def multichip_config(run_dir=None, max_iteration: int = 16):
    """The multichip script's flags, cut to ``max_iteration`` macro-steps
    with a checkpoint, scoring and the scheduler inside; relative
    directories without ``run_dir``."""
    from smmdax_torch.configs import config_from_args
    dirs = [x for d in ("checkpoint", "log", "sample")
            for x in (f"--{d}_dir", d if run_dir is None else os.path.join(run_dir, d))]
    return config_from_args(MULTICHIP_FLAGS + MULTICHIP_CUT_FLAGS + dirs
                            + ["--max_iteration", str(max_iteration)])


def _digest(state) -> str:
    """sha256 of every tensor and number of a train state."""
    import hashlib
    import torch
    from smmdax_torch import checkpoint
    h = hashlib.sha256()

    def walk(x, where):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{where}/{k}")
        elif isinstance(x, torch.Tensor):
            h.update(where.encode() + x.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        else:
            h.update(f"{where}={x!r}".encode())

    walk(checkpoint.state_dict(state), "")
    return h.hexdigest()


def _zero_launches():
    from smmdax_torch.cuda import mmd_kernel as mk
    counters = mk.kernel_launch_counters()
    for k in counters:
        k.launches = 0
    return counters


def _rank_probe(axis, job, rank) -> dict:
    """Which collectives gloo carries on CUDA tensors itself (the
    ``DataAxis`` stages them all through the host either way, the ring's
    point-to-point shift included, which is not probed: a one-sided
    failure there would leave the other rank waiting)."""
    import torch
    import torch.distributed as dist
    x = torch.full((4,), float(rank + 1), device=axis.device)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(axis.size)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize(axis.device)
            out[name] = "native"
        except Exception as e:          # noqa: BLE001 - recorded, not fatal
            out[name] = f"not carried: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    axis.barrier()
    return out


def _rank_timing(cfg, axis, rank, label) -> dict:
    """The per-rank step (``dispatch_train_step``, this rank's block of
    each batch, as the trainer feeds it) over RANK_TIMED_STEPS macro-steps
    after one warm-up, with the launch counters set to 0 before and read
    after; then a profile of two more on rank 0."""
    import torch
    from smmdax_torch.data import SyntheticImages, macro_batch_at
    from smmdax_torch.train import create_state, dispatch_train_step
    state = create_state(cfg, seed=0, device=axis.device,
                         rank=rank if cfg.dp_mode == "shard_map" else 0)
    step = dispatch_train_step(cfg, cfg.dsteps, cfg.gsteps, 1, axis)
    src = SyntheticImages(size=cfg.output_size, channels=cfg.c_dim, seed=cfg.random_seed)
    per_step = cfg.dsteps + cfg.gsteps
    batches = [macro_batch_at(src, s, per_step, cfg.real_batch_size, u8=True,
                              block=(rank, axis.size))
               for s in range(RANK_TIMED_STEPS + 3)]
    counters = _zero_launches()
    for s in range(RANK_TIMED_STEPS + 1):
        if s == 1:
            torch.cuda.synchronize(axis.device)
            axis.barrier()
            t0 = time.perf_counter()
        state, metrics = step(state, batches[s])
    torch.cuda.synchronize(axis.device)
    dt = (time.perf_counter() - t0) / RANK_TIMED_STEPS
    launches = {k.__name__: k.launches for k in counters}
    values = {k: float(v) for k, v in metrics.items()}
    # images/s of the group: the global batch (batch_size is global)
    out = dict(ms_per_macro_step=dt * 1e3,
               images_per_s=per_step * cfg.batch_size / dt,
               launches=dict(launches, macro_steps=RANK_TIMED_STEPS + 1), metrics=values)
    if rank == 0:
        profile_steps(step, state, batches[RANK_TIMED_STEPS + 1:], out)
    else:
        for real in batches[RANK_TIMED_STEPS + 1:]:
            state, _ = step(state, real)
        torch.cuda.synchronize(axis.device)
    return out


def _rank_rows(noise: dict, axis) -> dict:
    """This rank's rows of the global latents (the probe whole): the draws
    a shard_map rank takes in the known-wrong arms, so that they differ
    from the GSPMD step in their statistics alone."""
    b = noise["d_z"].shape[1] // axis.size
    return {k: v[:, axis.index * b:(axis.index + 1) * b] if k in ("d_z", "g_z") else v
            for k, v in noise.items()}


def _rank_gspmd(axis, job, rank) -> dict:
    """(a) two GSPMD macro-steps on the global batches and draws of the
    one-device reference, at float32 and bf16, and the known-wrong arms
    of ``WRONG_ARMS`` at float32; then (d) the bf16 step timed."""
    import torch
    from smmdax_torch import checkpoint
    from smmdax_torch.train import create_state, data_parallel_train_step
    out = {}
    arms = [("float32", None), ("bfloat16", None)] + [("float32", w) for w in WRONG_ARMS]
    for dtype, wrong in arms:
        cfg = gspmd_config(dtype).replace(**WRONG_ARMS.get(wrong, {}))
        state = create_state(cfg, seed=0, device=axis.device)
        step = data_parallel_train_step(cfg, cfg.dsteps, cfg.gsteps, axis)
        counters = _zero_launches()
        metrics = []
        for real, noise in zip(job["gspmd_reals"], job["gspmd_noise"][dtype]):
            noise = {k: v.to(axis.device) for k, v in noise.items()}
            state, m = step(state, real, noise=_rank_rows(noise, axis) if wrong else noise)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize(axis.device)
        arm = dict(metrics=metrics, digest=_digest(state),
                   launches={k.__name__: k.launches for k in counters})
        if dtype == "float32" and rank == 0:
            arm["state_path"] = os.path.join(job["out"], f"gspmd_f32_{wrong or 'gspmd'}.pt")
            torch.save(checkpoint.state_dict(state), arm["state_path"])
        out[wrong or dtype] = arm
        del state
    out["timing"] = _rank_timing(gspmd_config("bfloat16"), axis, rank, "gspmd")
    return out


def _rank_ring(axis, job, rank) -> dict:
    """(d) the multichip config's per-rank ring step timed."""
    return _rank_timing(multichip_config(), axis, rank, "ring")


def _rank_pool(axis, job, rank) -> dict:
    """(c) the sharded device pool: K=1 and K=4 over 4 macro-steps."""
    import torch
    from smmdax_torch.data import SyntheticImages, materialize_u8
    from smmdax_torch.train import create_state, device_data_train_step
    cfg = flagship_config("bfloat16").replace(
        batch_size=64 * RANKS, real_batch_size=64 * RANKS, num_data_shards=RANKS,
        data_placement="device", device_data_sharding="sharded")
    src = SyntheticImages(size=32, channels=3, seed=cfg.random_seed)
    pool = torch.from_numpy(materialize_u8(src, 4097, block=(rank, axis.size))).to(axis.device)
    digests = []
    counters = _zero_launches()
    with deterministic_torch():
        for k in (1, 4):
            step = device_data_train_step(cfg, cfg.dsteps, cfg.gsteps, k, axis)
            state = create_state(cfg, seed=0, device=axis.device)
            for _ in range(4 // k):
                state, _ = step(state, pool)
            torch.cuda.synchronize(axis.device)
            digests.append(_digest(state))
    return dict(pool_rows=int(pool.shape[0]), digests=digests,
                launches={k.__name__: k.launches for k in counters})


def _rank_trainer(cfg, axis, rank) -> tuple:
    from smmdax_torch.trainer import Trainer
    with deterministic_torch():
        trainer = Trainer(cfg, device=axis.device, axis=axis)
        resumed_at = trainer.state.step
        state = trainer.train()
    return trainer, state, resumed_at


def _files_under(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rank_trainer_a(axis, job, rank) -> dict:
    """(b) the straight run, in a working directory of this rank's own
    with relative directories: only rank 0's may fill."""
    import torch
    from smmdax_torch import checkpoint
    cwd = os.path.join(job["out"], "cwd", f"rank{rank}")
    os.makedirs(cwd)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        counters = _zero_launches()
        t0 = time.perf_counter()
        trainer, state, _ = _rank_trainer(multichip_config(), axis, rank)
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counters}
        rows = _log_rows(trainer) if rank == 0 else None
    finally:
        os.chdir(here)
    torch.save(checkpoint.state_dict(state), os.path.join(job["out"], f"A_rank{rank}.pt"))
    return dict(wall_s=wall, launches=launches, rows=rows, files=_files_under(cwd))


def _rank_trainer_b(axis, job, rank) -> dict:
    _rank_trainer(multichip_config(os.path.join(job["out"], "B"), 8), axis, rank)
    return {}


def _rank_resume(axis, job, rank) -> dict:
    """(b) run B resumed from its step-8 checkpoint in fresh processes."""
    import torch
    from smmdax_torch import checkpoint
    cfg = multichip_config(os.path.join(job["out"], "B"), 16)
    trainer, state, resumed_at = _rank_trainer(cfg, axis, rank)
    torch.save(checkpoint.state_dict(state), os.path.join(job["out"], f"B_rank{rank}.pt"))
    return dict(resumed_at=resumed_at, rows=_log_rows(trainer) if rank == 0 else None)


RANK_PARTS = {"probe": _rank_probe, "gspmd": _rank_gspmd, "ring": _rank_ring,
              "pool": _rank_pool, "trainer_a": _rank_trainer_a,
              "trainer_b": _rank_trainer_b, "resume": _rank_resume}


def _staged_axis(rank: int, world: int, store: str):
    """Rank ``rank`` on cuda:0 over a gloo group (NCCL refuses two ranks on
    one device): a ``DataAxis`` whose collectives carry each tensor
    through the host.  Only this script puts two ranks on one card; the
    port's own groups are NCCL on the card and gloo on the CPU."""
    import torch
    import torch.distributed as dist
    from smmdax_torch.parallel import DataAxis

    class StagedAxis(DataAxis):
        def _all_reduce(self, x):
            return super()._all_reduce(x.detach().cpu()).to(x.device)

        def _all_gather(self, x):
            return super()._all_gather(x.detach().cpu()).to(x.device)

        def _shift(self, x, step):
            return super()._shift(x.detach().cpu(), step).to(x.device)

    torch.cuda.set_device("cuda:0")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    return StagedAxis("cuda:0")


def _rank_worker(rank: int, world: int, transport: str, store: str, job_path: str) -> None:
    """One rank of phase 9: join the group (NCCL on cuda:<rank>, or gloo
    with both ranks on cuda:0) and run the job's parts in order."""
    import traceback
    import torch
    job = torch.load(job_path, weights_only=False)
    sys.path.insert(0, job["tree"])
    from smmdax_torch.parallel import init_data_axis
    # a spawned process starts with PyTorch's defaults (cuDNN in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        axis = (init_data_axis(f"cuda:{rank}", rank, world, store) if transport == "nccl"
                else _staged_axis(rank, world, store))
        try:
            for part in job["parts"]:
                t0 = time.perf_counter()
                out[part] = RANK_PARTS[part](axis, job, rank)
                out[part + "_s"] = time.perf_counter() - t0
        finally:
            axis.close()
    except BaseException:
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(job["out"], f"{job['name']}_rank{rank}.pt"))
    if "error" in out:
        raise SystemExit(1)


def _run_ranks(job: dict, transport: str) -> list:
    """Run ``job`` on RANKS spawned ranks; their results in rank order."""
    import torch
    ctx = multiprocessing.get_context("spawn")
    job_path = os.path.join(job["out"], f"{job['name']}.job.pt")
    torch.save(job, job_path)
    store = os.path.join(job["out"], f"{job['name']}.store")
    procs = [ctx.Process(target=_rank_worker, args=(r, RANKS, transport, store, job_path))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.time() + RANK_GROUP_TIMEOUT_S
    while any(p.exitcode is None for p in procs) and time.time() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.exitcode is None:
            p.kill()
        p.join()
    outs = []
    for r in range(RANKS):
        path = os.path.join(job["out"], f"{job['name']}_rank{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) else None
        if res is None or "error" in res:
            fail(f"ranks ({job['name']}): rank {r} exited {procs[r].exitcode}:\n"
                 + (res["error"] if res else "no result"))
        outs.append(res)
    return outs


def _one_device_gspmd_reference(results: dict):
    """The one-device step at the global batch (B 128): two macro-steps,
    with the draws it makes, at float32 and bf16; then its bf16 step
    timed."""
    import torch
    from smmdax_torch import checkpoint
    from smmdax_torch.data import SyntheticImages, macro_batch_at
    from smmdax_torch.train import build_train_step, create_state, draw_noise
    cfg32 = gspmd_config("float32").replace(num_data_shards=1)
    src = SyntheticImages(size=32, channels=3, seed=cfg32.random_seed)
    reals = [torch.from_numpy(macro_batch_at(src, 100 + s, 6, cfg32.real_batch_size, u8=True))
             for s in range(2)]
    noise, ref = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = gspmd_config(dtype).replace(num_data_shards=1)
        state = create_state(cfg, seed=0, device="cuda")
        step = build_train_step(cfg, cfg.dsteps, cfg.gsteps)
        noise[dtype], metrics = [], []
        for real in reals:
            n = draw_noise(cfg, state, cfg.dsteps, cfg.gsteps)
            noise[dtype].append({k: v.cpu() for k, v in n.items()})
            state, m = step(state, real, noise=n)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        ref[dtype] = dict(metrics=metrics, state=checkpoint.state_dict(state)
                          if dtype == "float32" else None)
    # the float32 floor: the same steps with the rows of every batch and of
    # the latents in other orders, which changes the float32 summation
    # order and nothing else (every statistic is symmetric in the rows)
    cfg = gspmd_config("float32").replace(num_data_shards=1)
    step = build_train_step(cfg, cfg.dsteps, cfg.gsteps)
    ref["permuted"] = []
    for i in range(FLOOR_RUNS):
        perm = torch.randperm(cfg.batch_size, generator=torch.Generator().manual_seed(5 + i))
        state = create_state(cfg, seed=0, device="cuda")
        metrics = []
        for real, n in zip(reals, noise["float32"]):
            n = {k: (v[:, perm] if k in ("d_z", "g_z") else v).cuda() for k, v in n.items()}
            state, m = step(state, real[:, perm], noise=n)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        ref["permuted"].append(dict(metrics=metrics, state=checkpoint.state_dict(state)))
        del state
    run_slice(gspmd_config("bfloat16").replace(num_data_shards=1), RANK_TIMED_STEPS,
              "1 rank gspmd bf16 B128", results, ("pair_sum", "pair_sum_grad_a"))
    mc = multichip_config().replace(num_data_shards=1, use_ring_mmd=False)
    run_slice(mc, RANK_TIMED_STEPS, "1 rank multichip bf16 B128", results,
              ("pair_sum", "pair_sum_grad_a"))
    return reals, noise, ref


def _zero_grad_entry(module: str, name: str) -> bool:
    """Entries whose gradient is 0 in exact arithmetic, where Adam turns
    float32 rounding into +-lr steps whose signs two summation orders do
    not share: the critic head's bias (the losses see the features through
    differences) and the bias of every generator block's convolution (a
    per-channel constant that the BatchNorm after it removes)."""
    if module == "gen":
        return name.startswith("block") and name.endswith(".bias")
    return name == "head.bias"


def _gspmd_gate(metrics: list, got: dict, ref: dict) -> tuple:
    """Hold a 2-rank float32 run (each macro-step's metrics, the final
    state dict) to one device's.  Every metric within rtol 2e-3 / atol
    2e-5, and every tensor of the critic and the generator, parameters and
    buffers (BN running statistics, SN vectors), in L2 form within rtol
    5e-3 / atol 1e-4 (atol sqrt(n), rtol of the norm), each widened by
    FLOOR_FACTOR times the farthest of one device's row-permuted runs.
    ``critic_real`` and ``critic_fake`` are held as their difference, and
    the entries of ``_zero_grad_entry`` are not held: each mean carries
    the sum of the head's bias.  Returns (failures, {name: (distance,
    tolerance, floor)})."""
    import torch
    bad, seen = [], {}
    gap = lambda m: dict(m, critic_gap=m["critic_real"] - m["critic_fake"])  # noqa: E731
    for s, (got_m, want_m) in enumerate(zip(metrics, ref["float32"]["metrics"])):
        got_m, want_m = gap(got_m), gap(want_m)
        floors = [gap(p["metrics"][s]) for p in ref["permuted"]]
        for k, w in want_m.items():
            if k in ("critic_real", "critic_fake"):
                continue
            g, floor = got_m[k], max(abs(f[k] - w) for f in floors)
            tol = GSPMD_METRIC_ATOL + GSPMD_METRIC_RTOL * abs(w)
            seen[f"step {s + 1} {k}"] = (abs(g - w), tol, floor)
            if not abs(g - w) <= tol + FLOOR_FACTOR * floor:
                bad.append(f"step {s + 1} {k}: {g} vs one device {w} (tolerance {tol}, its "
                           f"row-permuted runs lie up to {floor} from it)")
    want = ref["float32"]["state"]
    for module in ("disc", "gen"):
        for name, w in want[module].items():
            if _zero_grad_entry(module, name) or not w.numel():
                continue
            g, w = got[module][name].float(), w.float()
            dist = float(torch.linalg.vector_norm(g - w))
            floor = max(float(torch.linalg.vector_norm(p["state"][module][name].float() - w))
                        for p in ref["permuted"])
            tol = (GSPMD_PARAM_ATOL * math.sqrt(w.numel())
                   + GSPMD_PARAM_RTOL * float(torch.linalg.vector_norm(w)))
            seen[f"{module}.{name}"] = (dist, tol, floor)
            if not dist <= tol + FLOOR_FACTOR * floor:
                bad.append(f"{module}.{name}: L2 distance {dist} from one device (tolerance "
                           f"{tol}, its row-permuted runs lie up to {floor} from it)")
    return bad, seen


def _check_gspmd(ranks: list, ref: dict, results: dict) -> None:
    import torch
    out = {}
    for arm in ("float32", "bfloat16") + tuple(WRONG_ARMS):
        a, b = (r["gspmd"][arm] for r in ranks)
        if a["digest"] != b["digest"]:
            fail(f"gspmd {arm}: the two ranks' states differ")
        if a["metrics"] != b["metrics"]:
            fail(f"gspmd {arm}: the two ranks' metrics differ")
        bad = [f"step {s + 1} {k} = {v}" for s, m in enumerate(a["metrics"])
               for k, v in m.items() if not math.isfinite(v)]
        if bad and arm in ("float32", "bfloat16"):
            fail(f"gspmd {arm}: " + "; ".join(bad))
        out[arm] = dict(metrics=a["metrics"], launches=a["launches"])
    # bf16: printed against one device, not gated
    rel = [(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30), k, g[k], w[k])
           for g, w in zip(out["bfloat16"]["metrics"], ref["bfloat16"]["metrics"]) for k in w]
    worst = max(rel)
    out["bfloat16"].update(one_device=ref["bfloat16"]["metrics"], worst_metric_rel_err=worst[0],
                           worst_metric=worst[1])
    log(f"gspmd bfloat16: 2 ranks equal bit for bit; metrics of 2 macro-steps against one "
        f"device at B 128 (not gated): worst rel err {worst[0]:.3g} ({worst[1]}: "
        f"{worst[2]:.7g} vs {worst[3]:.7g}); launches {out['bfloat16']['launches']}")
    # float32: the gate, then the same gate on each known-wrong arm
    for arm in ("float32",) + tuple(WRONG_ARMS):
        got = torch.load(ranks[0]["gspmd"][arm]["state_path"], weights_only=True)
        bad, seen = _gspmd_gate(out[arm]["metrics"], got, ref)
        far = max(seen.items(), key=lambda kv: kv[1][0] / (kv[1][1] + FLOOR_FACTOR * kv[1][2]))
        out[arm].update(failures=bad, farthest=dict(name=far[0], distance=far[1][0],
                                                    tolerance=far[1][1], floor=far[1][2]))
        share = far[1][0] / (far[1][1] + FLOOR_FACTOR * far[1][2])
        if arm == "float32":
            if bad:
                fail("gspmd f32 against one device: " + "; ".join(bad))
            out[arm].update(one_device=ref["float32"]["metrics"],
                            one_device_permuted=[p["metrics"] for p in ref["permuted"]],
                            gated=dict(seen))
            log(f"gspmd float32: 2 ranks equal bit for bit; {len(seen)} metrics and tensors "
                f"(critic and generator, parameters and buffers) within the tolerance plus "
                f"{FLOOR_FACTOR}x one device's {FLOOR_RUNS} row-permuted runs; the closest to "
                f"its bound {far[0]} at {100 * share:.1f}% of it (distance {far[1][0]:.3g}, "
                f"tolerance {far[1][1]:.3g}, floor {far[1][2]:.3g}); launches "
                f"{out[arm]['launches']}")
        else:
            if not bad:
                fail(f"gspmd f32 gate: the known-wrong arm '{arm}' passes it (farthest "
                     f"{far[0]} at {100 * share:.1f}% of its bound)")
            log(f"gspmd known-wrong arm '{arm}': fails the gate at {len(bad)} of "
                f"{len(seen)} metrics and tensors, the farthest {far[0]} at "
                f"{100 * share:.1f}% of its bound; first: {bad[0]}")
    results["ranks_gspmd"] = out


def run_ranks(tmp: str, results: dict, tree: str) -> dict:
    """Phase 9 (see the module docstring).  Returns the launches per
    macro-step of the timed 2-rank steps."""
    import torch
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    transport = "nccl" if cards >= RANKS else "gloo"
    where = ("one rank per card (NCCL)" if transport == "nccl" else
             "both ranks on cuda:0 over gloo, every collective staged through the host "
             "(NCCL refuses two ranks on one device)")
    log(f"ranks: {RANKS} ranks, {where}")
    reals, noise, ref = _one_device_gspmd_reference(results)
    parts = (["probe"] if transport == "gloo" else []) + [
        "gspmd", "ring", "pool", "trainer_a", "trainer_b"]
    job = dict(name="g1", tree=tree, out=tmp, parts=parts, gspmd_reals=reals,
               gspmd_noise=noise)
    ranks = _run_ranks(job, transport)
    if transport == "gloo":
        log("ranks: gloo on CUDA tensors, natively: " + ", ".join(
            f"{k} {v}" for k, v in ranks[0]["probe"].items()))
    _check_gspmd(ranks, ref, results)

    # (c)
    pools = [r["pool"] for r in ranks]
    for i, p in enumerate(pools):
        if p["digests"][0] != p["digests"][1]:
            fail(f"sharded pool: rank {i}'s K=1 and K=4 states differ")
        if p["pool_rows"] != 4097 // RANKS:
            fail(f"sharded pool: rank {i} holds {p['pool_rows']} rows")
    if pools[0]["digests"][0] != pools[1]["digests"][0]:
        fail("sharded pool: the two ranks' states differ")
    log(f"sharded pool: 4097 samples cut to {RANKS} x {pools[0]['pool_rows']}; 4 flagship "
        "macro-steps at K=1 and K=4 equal bit for bit on each rank, and across ranks")

    # (b)
    a = [r["trainer_a"] for r in ranks]
    if a[1]["files"]:
        fail(f"trainer over ranks: rank 1 wrote {a[1]['files'][:10]}")
    cfg = multichip_config()
    run = cfg.run_name()
    want = {f"log/{run}.jsonl", f"checkpoint/{run}/16.pt", f"sample/{run}/sample_0000008.png"}
    if not want <= set(a[0]["files"]):
        fail(f"trainer over ranks: rank 0 wrote {a[0]['files']}")
    rows = a[0]["rows"]
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not math.isfinite(v)]
    if bad:
        fail(f"trainer over ranks: non-finite logged metrics {bad}")
    scores = {r["step"]: r for r in rows if "kid" in r}
    if sorted(scores) != [8, 16]:
        fail(f"trainer over ranks: score rows at {sorted(scores)}")
    missing = [k for k in ("pair_sum", "pair_sum_grad_a") if a[0]["launches"][k] == 0]
    if missing:
        fail(f"trainer over ranks: the run did not launch {missing}")
    resumed = _run_ranks(dict(name="g2", tree=tree, out=tmp, parts=["resume"]), transport)
    for i in range(RANKS):
        if resumed[i]["resume"]["resumed_at"] != 8:
            fail(f"trainer over ranks: rank {i} resumed at {resumed[i]['resume']['resumed_at']}")
        diffs = _state_diffs(torch.load(os.path.join(tmp, f"A_rank{i}.pt"), weights_only=True),
                             torch.load(os.path.join(tmp, f"B_rank{i}.pt"), weights_only=True))
        if diffs:
            fail(f"trainer over ranks: rank {i}'s resumed state differs at {diffs[:20]}")
    score_b = next(r for r in resumed[0]["resume"]["rows"] if "kid" in r and r["step"] == 16)
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}
    if drop(score_b) != drop(scores[16]):
        fail(f"trainer over ranks: resumed step-16 scores {score_b} vs {scores[16]}")
    log(f"trainer over ranks ({run}, {RANKS} ranks, ring, K 4): 16 macro-steps in "
        f"{a[0]['wall_s']:.2f} s; scores at 8 KID {scores[8]['kid']:.5g} / FID "
        f"{scores[8]['fid']:.5g}, at 16 {scores[16]['kid']:.5g} / {scores[16]['fid']:.5g}; "
        f"launches {a[0]['launches']}; only rank 0 wrote files ({len(a[0]['files'])}); a run "
        "stopped at 8 and resumed to 16 in fresh processes equals it bit for bit on both "
        "ranks, scores included")

    # (d)
    card = card_line()
    timing = {}
    for label, one in (("gspmd", "1 rank gspmd bf16 B128"),
                       ("ring", "1 rank multichip bf16 B128")):
        t0, t1 = (r["gspmd"]["timing"] if label == "gspmd" else r["ring"] for r in ranks)
        per = {k: v / t0["launches"]["macro_steps"] for k, v in t0["launches"].items()
               if k != "macro_steps"}
        if not (per["pair_sum"] and per["pair_sum_grad_a"]):
            fail(f"2-rank {label}: the step did not launch the pair-sum kernels ({per})")
        prof = t0["profile"]
        # the group's step is its slower rank's
        timing[label] = dict(
            ms_per_macro_step=max(t0["ms_per_macro_step"], t1["ms_per_macro_step"]),
            images_per_s=min(t0["images_per_s"], t1["images_per_s"]),
            one_rank_ms_per_macro_step=results[one]["ms_per_macro_step"],
            one_rank_images_per_s=results[one]["images_per_s"],
            launches_per_macro_step=per, profile=prof, transport=transport, card=card)
        log(f"2-rank {label} bf16 (B 64 per rank, {transport}): "
            f"{timing[label]['ms_per_macro_step']:.2f} ms per macro-step, "
            f"{timing[label]['images_per_s']:.1f} images/s, against one rank at B 128 "
            f"{timing[label]['one_rank_ms_per_macro_step']:.2f} ms / "
            f"{timing[label]['one_rank_images_per_s']:.1f} images/s; launches per macro-step "
            + ", ".join(f"{k} {v:g}" for k, v in per.items())
            + f"; rank 0 device busy {prof['device_busy_ms_per_macro_step']:.2f} ms "
              f"({100 * prof['device_busy_share_of_step']:.1f}%), collectives "
              f"{prof['collective_ms_per_macro_step']:.2f} ms; {card}")
    results["ranks"] = dict(transport=transport, timing=timing, trainer_wall_s=a[0]["wall_s"],
                            phase_s=time.perf_counter() - t_phase)
    log(f"ranks phase: {time.perf_counter() - t_phase:.1f} s")
    return timing


# ---------------------------------------------------------------------------
# phase 10: Inception-v3 scoring and the generator export


INCEPTION_CPU_IMAGES = 8          # (a): card against the CPU's float64, 32 px
INCEPTION_SWEEP_IMAGES = 4096     # (b): images/s over this many 32 px images
INCEPTION_BATCHES = (64, 256)
INCEPTION_RTOL = 1e-4             # of each output's largest entry
# (c): the flagship's flags with one scoring event at the configured
# no_of_samples (25,000), then one at phase 5's 2,048
INCEPTION_TRAIN_CUT_FLAGS = [
    "--max_iteration", "8", "--warmup_iterations", "4", "--log_every", "4",
    "--sample_every", "0", "--checkpoint_every", "0", "--score_every", "8"]
COMPUTE_SCORES_IMAGES = 5000      # (d): per set, uint8, 32 px
EXPORT_BATCH = 512                # (e)
EXPORT_ATOL = 1e-6
EXPORT_TIMED = 20
# published dense peaks of one H100 SXM (NVIDIA data sheet): float32
# outside the tensor cores, TF32 on them
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12


def _inception_asset(directory: str, seed: int = 0) -> str:
    """A random-weights torchvision-schema ``inception_v3.npz`` in
    ``directory`` (the repo holds no real weights)."""
    import numpy as np
    from smmdax_torch.eval.inception import random_state_dict
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "inception_v3.npz")
    np.savez(path, **random_state_dict(seed))
    return path


def _rel_err(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_inception_card_vs_cpu(results: dict) -> None:
    """(a) Full-width Inception on the card against the port's own float64
    evaluation on the CPU, torchvision (1000-way) and FID (1008-way)
    forms, under deterministic algorithms; a repeat sweep bit-equal."""
    import numpy as np
    import torch
    from smmdax_torch.eval.inception import (InceptionV3, convert_torchvision_state_dict,
                                             random_state_dict)
    imgs = np.random.default_rng(10).uniform(
        -1, 1, (INCEPTION_CPU_IMAGES, 32, 32, 3)).astype(np.float32)
    out = {}
    for label, classes in (("torchvision", 1000), ("fid", 1008)):
        params = convert_torchvision_state_dict(random_state_dict(0, num_classes=classes))
        net = InceptionV3(params, device="cuda")
        if net.fid_semantics != (classes == 1008):
            fail(f"inception {label}: fid_semantics {net.fid_semantics} from a {classes}-way fc")
        with deterministic_torch():
            pool, logits = net.pool3_and_logits(imgs)
            pool2, logits2 = net.pool3_and_logits(imgs)
        t0 = time.perf_counter()
        ref = InceptionV3(params, device="cpu", dtype=torch.float64)
        with torch.no_grad():
            ref_pool, ref_logits = ref(torch.from_numpy(imgs))
        cpu_s = time.perf_counter() - t0
        errs = dict(pool3=_rel_err(pool, ref_pool), logits=_rel_err(logits, ref_logits))
        repeat = bool(np.array_equal(pool, pool2) and np.array_equal(logits, logits2))
        finite = bool(np.isfinite(pool).all() and np.isfinite(logits).all())
        out[label] = dict(rel_err=errs, repeat_bit_equal=repeat, cpu_float64_s=cpu_s,
                          fid_semantics=net.fid_semantics)
        log(f"inception {label} ({classes}-way, fid_semantics {net.fid_semantics}): card "
            f"float32 against CPU float64 on {len(imgs)} 32 px images: pool3 "
            f"{errs['pool3']:.3g}, logits {errs['logits']:.3g} of the largest entry (gate "
            f"{INCEPTION_RTOL:g}); repeat sweep bit-equal {repeat}; CPU {cpu_s:.1f} s")
        if not finite or not repeat or max(errs.values()) > INCEPTION_RTOL:
            fail(f"inception {label}: {out[label]}, finite {finite}")
    results["inception"]["card_vs_cpu"] = out


def _inception_sweep_s(net, imgs) -> tuple:
    """Seconds of one ``pool3_and_probs`` sweep of ``imgs`` left on the card
    (after one warm-up batch), and its outputs."""
    import torch
    net.pool3_and_probs(imgs[:net.batch], fetch=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool, probs = net.pool3_and_probs(imgs, fetch=False)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, pool, probs


def time_inception(results: dict) -> None:
    """(b) images/s of ``pool3_and_probs`` at batch 64 and 256 over
    ``INCEPTION_SWEEP_IMAGES`` 32 px images on the card, TF32 off (the
    scoring path, gated: finite, and the two batches agree) and on
    (reported: time, feature and FID gap); the profiler's device busy share
    of the batch-64 sweep; FLOPs per image from FlopCounterMode."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from smmdax_torch.eval import fid_from_features, kid_from_features
    from smmdax_torch.eval.inception import (InceptionV3, convert_torchvision_state_dict,
                                             random_state_dict)
    params = convert_torchvision_state_dict(random_state_dict(0))
    g = torch.Generator(device="cuda").manual_seed(11)
    imgs = torch.rand((INCEPTION_SWEEP_IMAGES, 32, 32, 3), generator=g, device="cuda") * 2 - 1
    half = INCEPTION_SWEEP_IMAGES // 2
    arms, feats = {}, {}
    for batch in INCEPTION_BATCHES:
        for tf32 in (False, True):
            net = InceptionV3(params, batch=batch, device="cuda", allow_tf32=tf32)
            secs, pool, probs = _inception_sweep_s(net, imgs)
            feats[(batch, tf32)] = pool
            arm = arms[f"batch {batch}, tf32 {'on' if tf32 else 'off'}"] = dict(
                images_per_s=INCEPTION_SWEEP_IMAGES / secs, sweep_s=secs)
            if batch == INCEPTION_BATCHES[0]:
                # TF32's effect on the scores: FID / KID of the two halves
                arm.update(fid_halves=fid_from_features(pool[:half], pool[half:]),
                           kid_halves=kid_from_features(pool[:half], pool[half:],
                                                        n_subsets=10)[0])
            if not (bool(torch.isfinite(pool).all()) and bool(torch.isfinite(probs).all())):
                fail(f"inception sweep at batch {batch}, tf32 {tf32}: non-finite outputs")
    small, large = INCEPTION_BATCHES
    off = feats[(small, False)].cpu().numpy()
    batch_err = _rel_err(feats[(large, False)].cpu().numpy(), off)
    tf32_err = _rel_err(feats[(small, True)].cpu().numpy(), off)
    if batch_err > INCEPTION_RTOL:
        fail(f"inception: batch {large} features {batch_err:.3g} from batch {small}'s")

    net = InceptionV3(params, batch=64, device="cuda")
    with FlopCounterMode(display=False) as counter:
        net.pool3_and_probs(imgs[:64], fetch=False)
    flops_per_image = counter.get_total_flops() / 64
    secs = arms["batch 64, tf32 off"]["sweep_s"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        net.pool3_and_probs(imgs, fetch=False)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for label, arm in arms.items():
        achieved = flops_per_image * arm["images_per_s"]
        arm["achieved_tflops"] = achieved / 1e12
        arm["fp32_peak_share"] = achieved / FP32_FLOPS_PER_S
        arm["tf32_peak_share"] = achieved / TF32_FLOPS_PER_S
    out = dict(arms=arms, flops_per_image=flops_per_image,
               device_busy_s=busy_s, device_busy_share=busy_s / secs,
               batch_rel_err=batch_err, tf32_vs_fp32_rel_err=tf32_err,
               top=[dict(name=e.key[:90], calls=e.count,
                         device_ms=e.self_device_time_total / 1e3) for e in top])
    results["inception"]["throughput"] = out
    for label, arm in arms.items():
        log(f"inception {label}: {arm['images_per_s']:.1f} images/s over "
            f"{INCEPTION_SWEEP_IMAGES} 32 px images ({arm['achieved_tflops']:.2f} TFLOP/s, "
            f"{100 * arm['fp32_peak_share']:.1f}% of the 67 TFLOP/s FP32 peak, "
            f"{100 * arm['tf32_peak_share']:.2f}% of the 495 TFLOP/s TF32 peak)"
            + (f"; FID of the two halves {arm['fid_halves']:.6g}, KID {arm['kid_halves']:.6g}"
               if "fid_halves" in arm else ""))
    log(f"inception: {flops_per_image / 1e9:.3f} GFLOP per 299 px image (FlopCounterMode); "
        f"batch {INCEPTION_BATCHES[1]} features {batch_err:.3g} and TF32 features "
        f"{tf32_err:.3g} of the largest "
        f"entry from batch 64's TF32-off; device busy {busy_s:.3f} s of the unprofiled "
        f"{secs:.3f} s sweep ({100 * busy_s / secs:.1f}%)")
    for r in out["top"]:
        log(f"  {r['device_ms']:9.2f} ms {r['calls']:6d}x  {r['name']}")


def run_inception_trainer(tmp: str, results: dict) -> dict:
    """(c) The flagship's flags through the trainer with only a
    random-weights ``inception_v3.npz`` in ``--data_dir`` (cifar10 then
    trains on synthetic data and scores ``no_of_samples`` = 25,000), one
    scoring event, the features left on the card; then the same at 2,048
    samples.  Returns the kernels' launches of the first run."""
    import torch
    from smmdax_torch.configs import config_from_args
    from smmdax_torch.cuda import mmd_kernel as mk
    from smmdax_torch.eval.features import InceptionFeatures
    from smmdax_torch.trainer import Trainer
    data_dir = os.path.join(tmp, "data")
    _inception_asset(data_dir)
    out = {}
    for label, extra in (("25000", []), ("2048", ["--no_of_samples", "2048", "--max_iteration",
                                                   "4", "--score_every", "4"])):
        dirs = [x for d in ("checkpoint", "log", "sample")
                for x in (f"--{d}_dir", os.path.join(tmp, label, d))]
        cfg = config_from_args(FLAGSHIP_TRAIN_FLAGS + INCEPTION_TRAIN_CUT_FLAGS + dirs
                               + ["--data_dir", data_dir] + extra)
        trainer = Trainer(cfg, device="cuda")
        score_s = []
        _timed(trainer, "_score", score_s)
        counters = mk.kernel_launch_counters()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counters}
        rows = [r for r in _log_rows(trainer) if "fid" in r]
        ext = trainer._extractor
        if not isinstance(ext, InceptionFeatures) or ext.name != "inception_v3":
            fail(f"trainer {label}: scored with {getattr(ext, 'name', ext)}, not inception_v3")
        if len(rows) != 1 or not {"fid", "kid", "kid_std", "inception_score",
                                  "inception_score_std"} <= set(rows[0]) or not all(
                math.isfinite(v) for v in rows[0].values()):
            fail(f"trainer {label}: score rows {rows}")
        if trainer._real_feats.shape != (cfg.no_of_samples, 2048) or not isinstance(
                trainer._real_feats, torch.Tensor) or trainer._real_feats.device.type != "cuda":
            fail(f"trainer {label}: real features {type(trainer._real_feats)} "
                 f"{tuple(trainer._real_feats.shape)}, not left on the card")
        missing = [k for k in ("pair_sum", "pair_sum_grad_a") if launches[k] == 0]
        if missing:
            fail(f"trainer {label}: did not launch {missing} ({launches})")
        out[label] = dict(samples=cfg.no_of_samples, ms_per_score=1e3 * score_s[0],
                          extractor=ext.name, score_row=rows[0], launches=launches,
                          wall_s=wall)
        log(f"inception trainer at {cfg.no_of_samples} samples: scoring event "
            f"{1e3 * score_s[0]:.1f} ms (real and fake sets, {ext.name}); FID "
            f"{rows[0]['fid']:.6g}, KID {rows[0]['kid']:.6g}, IS "
            f"{rows[0]['inception_score']:.6g}; run {wall:.2f} s; launches {launches}")
        out[label].update(state=state, cfg=cfg)
    random_conv = results.get("trainer", {}).get("ms_per_score")
    log(f"inception trainer: 2,048-sample event {out['2048']['ms_per_score']:.1f} ms against "
        f"phase 5's random-conv events {random_conv} ms")
    results["inception"]["trainer"] = {
        k: {kk: vv for kk, vv in v.items() if kk not in ("state", "cfg")} for k, v in out.items()}
    results["inception"]["trainer"]["random_conv_ms_per_score"] = random_conv
    return out


def run_compute_scores(tmp: str, results: dict, tree: str) -> None:
    """(d) ``python -m smmdax_torch.compute_scores`` in a fresh process on
    two uint8 .npy sets of 32 px images, with ``--compare`` a third, with a
    random-weights Inception asset: FID, KID and IS from inception_v3."""
    import numpy as np
    from smmdax_torch.data import SyntheticImages
    data_dir = os.path.join(tmp, "data")
    _inception_asset(data_dir)
    src = SyntheticImages(32, 3, seed=0)
    n = COMPUTE_SCORES_IMAGES
    sets = {"real": src.batch_u8(n, key=1), "fake": src.batch_u8(n, key=2),
            "other": np.random.default_rng(3).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)}
    paths = {}
    for name, arr in sets.items():
        paths[name] = os.path.join(tmp, f"{name}.npy")
        np.save(paths[name], arr)
    cmd = [sys.executable, "-m", "smmdax_torch.compute_scores", paths["real"], paths["fake"],
           "--compare", paths["other"], "--data_dir", data_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=tree))
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        fail(f"compute_scores exited {proc.returncode}: {proc.stderr[-2000:]}")
    want = ["FID", "KID", "IS", "relative-MMD test (FAKE closer than COMPARE?)", "(extractor"]
    if [line.split(":")[0] for line in lines[-5:]] != want or lines[-1] != (
            f"(extractor: inception_v3, n_real={n}, n_fake={n})"):
        fail(f"compute_scores printed {lines}")
    values = [float(line.split()[1]) for line in lines[-5:-2]]
    if not all(math.isfinite(v) for v in values):
        fail(f"compute_scores: non-finite scores {lines}")
    results["inception"]["compute_scores"] = dict(wall_s=wall, lines=lines[-5:])
    log(f"compute_scores on 2 x {n} (+ {n} --compare) 32 px images, fresh process: "
        f"{wall:.1f} s of wall; " + " | ".join(lines[-5:]))


def _export_worker(path: str, z_path: str, out_path: str) -> None:
    """Load an exported generator in a fresh process with torch alone (no
    smmdax_torch), run it on the saved z, and time it."""
    import torch
    # a spawned process starts with PyTorch's defaults (cuDNN in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.export.load(path).module()
    z = torch.load(z_path, weights_only=True)
    with torch.no_grad():
        imgs = gen(z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXPORT_TIMED):
            gen(z)
        torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / EXPORT_TIMED
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "smmdax_torch")
    torch.save(dict(images=imgs.cpu(), secs=secs, smmdax_torch_modules=loaded), out_path)


def check_export(tmp: str, cfg, state, results: dict) -> None:
    """(e) The flagship's EMA generator exported at batch 512 on the card,
    loaded in a fresh process; equal to ``sample`` on the same z, and
    images/s of the loaded program against eager ``sample``."""
    import torch
    from smmdax_torch.export import export_generator
    from smmdax_torch.train import sample
    cfg = cfg.replace(batch_size=EXPORT_BATCH)        # sample decodes one batch
    t0 = time.perf_counter()
    program = export_generator(cfg, state, EXPORT_BATCH)
    path = os.path.join(tmp, "gen.pt2")
    torch.export.save(program, path)
    export_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(21)
    z = torch.rand((EXPORT_BATCH, cfg.z_dim), generator=g, device="cuda") * 2.0 - 1.0
    want = sample(cfg, state, torch.Generator(device="cuda").manual_seed(21), EXPORT_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EXPORT_TIMED):
        sample(cfg, state, torch.Generator(device="cuda").manual_seed(21), EXPORT_BATCH)
    torch.cuda.synchronize()
    eager_s = (time.perf_counter() - t0) / EXPORT_TIMED
    z_path, out_path = os.path.join(tmp, "z.pt"), os.path.join(tmp, "served.pt")
    torch.save(z, z_path)
    proc = multiprocessing.get_context("spawn").Process(
        target=_export_worker, args=(path, z_path, out_path))
    proc.start()
    proc.join(300)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if proc.exitcode != 0 or not os.path.exists(out_path):
        fail(f"export: the loading process exited with {proc.exitcode}")
    served = torch.load(out_path, weights_only=True)
    err = float((served["images"] - want.cpu()).abs().max())
    if served["smmdax_torch_modules"]:
        fail(f"export: the loading process imported {served['smmdax_torch_modules']}")
    if tuple(served["images"].shape) != (EXPORT_BATCH,) + cfg.image_shape or not err <= EXPORT_ATOL:
        fail(f"export: served images {tuple(served['images'].shape)} lie {err:.3g} from sample")
    out = dict(max_abs_err=err, export_s=export_s, mb=os.path.getsize(path) / 1e6,
               loaded_images_per_s=EXPORT_BATCH / served["secs"],
               eager_sample_images_per_s=EXPORT_BATCH / eager_s)
    results["inception"]["export"] = out
    log(f"export: the flagship's EMA generator at batch {EXPORT_BATCH}, exported and saved in "
        f"{export_s:.1f} s ({out['mb']:.1f} MB), loaded in a fresh process with torch alone: "
        f"{err:.3g} max abs from sample on the same z (gate {EXPORT_ATOL:g}); "
        f"{out['loaded_images_per_s']:.1f} images/s against eager sample's "
        f"{out['eager_sample_images_per_s']:.1f}")


def run_inception(tmp: str, results: dict, tree: str) -> dict:
    """Phase 10 (see the module docstring).  Returns the kernels' launches
    in the 25,000-sample trainer run."""
    t_phase = time.perf_counter()
    results["inception"] = {}
    check_inception_card_vs_cpu(results)
    time_inception(results)
    runs = run_inception_trainer(tmp, results)
    run_compute_scores(tmp, results, tree)
    check_export(tmp, runs["25000"]["cfg"], runs["25000"]["state"], results)
    results["inception"]["phase_s"] = time.perf_counter() - t_phase
    log(f"inception phase: {results['inception']['phase_s']:.1f} s")
    return runs["25000"]["launches"]


def profile_only(results: dict) -> int:
    """The timed and profiled bf16 macro-steps of phases 3 and 4 alone."""
    import torch
    from smmdax_torch.parallel import init_data_axis
    run_slice(flagship_config("bfloat16"), TIMED_STEPS, "flagship bf16", results,
              ("pair_sum", "pair_sum_grad_a"), profile=True)
    axis = init_data_axis("cuda:0")
    try:
        run_slice(tmmd_ring_config("bfloat16"), TIMED_STEPS, "tmmd ring bf16", results,
                  ("pair_sum", "pair_sum_grad_a", "pair_stats", "pair_stats_grad_a"),
                  profile=True, axis=axis)
    finally:
        axis.close()
    torch.cuda.synchronize()
    print(json.dumps({label: dict(launches=results[label]["launches"],
                                  ms_per_macro_step=results[label]["ms_per_macro_step"],
                                  device_ms_per_macro_step=results[label]["profile"][
                                      "device_busy_ms_per_macro_step"],
                                  csrc_device_us_per_launch=results[label]["profile"][
                                      "csrc_device_us_per_launch"])
                      for label in ("flagship bf16", "tmmd ring bf16")}), flush=True)
    print(card_line(), flush=True)
    return 0


def write_results(path, results: dict) -> None:
    """All results as JSON at ``path`` (nothing for None)."""
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(results, f, indent=1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write all results as JSON here")
    parser.add_argument("--tree", default=HERE,
                        help="import smmdax_torch from this checkout (default: beside "
                             "this script), e.g. an earlier commit unpacked by git archive")
    parser.add_argument("--only", choices=("profile", "ranks", "inception"), default=None,
                        help="profile: build, then only the timed and profiled bf16 "
                             "steps of phases 3 and 4; prints the launches and device "
                             "us per launch of each csrc kernel, and no ok line; "
                             "ranks: build, then phase 9 alone, and no ok line; "
                             "inception: build, then phase 10 alone, and no ok line")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    # cuBLAS reads it when CUDA starts: phase 5 runs deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(tree, "smmdax_torch")):
        print(f"chip_smoke: no smmdax_torch package in {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    from smmdax_torch.cuda import build
    from smmdax_torch.parallel import init_data_axis
    from smmdax_torch.train import sample

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    results = {}

    # phase 1
    _, nvcc_log, secs = build.build()
    log(f"build: {secs:.1f} s for {', '.join(build.sources())}")
    for line in nvcc_log.splitlines():
        if line.startswith("==") or any(w in line for w in
                                        ("entry function", "registers", "spill")):
            log(f"  {line.strip()}")
    results["build_s"] = secs
    if args.only == "profile":
        return profile_only(results)
    if args.only in ("ranks", "inception"):
        with tempfile.TemporaryDirectory() as tmp:
            (run_ranks if args.only == "ranks" else run_inception)(tmp, results, tree)
        write_results(args.out, results)
        print(card_line(), flush=True)
        return 0

    # phase 2, 2b
    t0 = time.perf_counter()
    slice_k = check_kernels(results)
    time_dense_vs_fused(results)
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slice_s = check_stats_kernels(results)
    log(f"stats kernel phase: {time.perf_counter() - t0:.1f} s")

    # phase 3
    t0 = time.perf_counter()
    cfg = flagship_config("bfloat16")
    state, flagship = run_slice(cfg, TIMED_STEPS, "flagship bf16", results,
                                ("pair_sum", "pair_sum_grad_a"), profile=True)
    check_fused_loss(cfg, state)
    imgs = sample(cfg, state, torch.Generator(device="cuda").manual_seed(1), n=256)
    torch.cuda.synchronize()
    if imgs.shape != (256,) + cfg.image_shape or not bool(torch.isfinite(imgs).all()) \
            or float(imgs.abs().max()) > 1.0:
        fail(f"sample: shape {tuple(imgs.shape)}, range/finiteness off")
    log(f"sample: 256 EMA images {tuple(imgs.shape)} in [{float(imgs.min()):.3f}, "
        f"{float(imgs.max()):.3f}]")
    del state
    run_slice(flagship_config("float32"), 1, "flagship f32", results,
              ("pair_sum", "pair_sum_grad_a"))
    log(f"flagship phase: {time.perf_counter() - t0:.1f} s")

    # phase 4
    t0 = time.perf_counter()
    axis = init_data_axis("cuda:0")
    try:
        cfg = tmmd_ring_config("bfloat16")
        required = ("pair_sum", "pair_sum_grad_a", "pair_stats", "pair_stats_grad_a")
        state, ring = run_slice(cfg, TIMED_STEPS, "tmmd ring bf16", results, required,
                                profile=True, axis=axis)
        check_ring_loss(cfg, state, axis, results)
        del state
        cfg = tmmd_ring_config("float32")
        state, _ = run_slice(cfg, 1, "tmmd ring f32", results, required, axis=axis)
        real, fake, one_rank = check_ring_critic_grads(cfg, state, axis, results)
    finally:
        axis.close()
    if torch.cuda.device_count() >= 2:
        check_two_ranks(cfg, state, real, fake, one_rank, results)
    else:
        log("2-rank ring: skipped, 1 card")
    log(f"tmmd ring phase: {time.perf_counter() - t0:.1f} s")

    # phase 5
    with tempfile.TemporaryDirectory() as tmp:
        trainer = run_trainer(tmp, results, tree)

    # phase 6
    t0 = time.perf_counter()
    dcgan = run_dcgan(results)
    log(f"dcgan phase: {time.perf_counter() - t0:.1f} s")

    # phase 7
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        toy = run_toy(tmp, results)
    log(f"toy phase: {time.perf_counter() - t0:.1f} s")

    # phase 8
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        time_data_arms(tmp, results)
        check_device_data_k_invariance(results)
        check_device_data_resume(tmp, results, tree)
    check_remat(results)
    log(f"device data and remat phase: {time.perf_counter() - t0:.1f} s")

    # phase 9
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(tmp, results, tree)

    # phase 10
    with tempfile.TemporaryDirectory() as tmp:
        inception = run_inception(tmp, results, tree)

    dev3 = results["flagship bf16"]["profile"]["csrc_device_us_per_launch"]
    dev4 = results["tmmd ring bf16"]["profile"]["csrc_device_us_per_launch"]

    def device_us(name):
        return {"flagship": dev3.get(name), "tmmd_ring": dev4.get(name)}

    t, ts = slice_k["times"], slice_s["times"]
    kernels = [
        dict(name="pair_sum_fwd", route="cuda", source="smmdax_torch/csrc/pair_sum.cu",
             replaces="smmdax/pallas/mmd_kernel.py:141", launches=flagship["pair_sum"],
             max_abs_err=slice_k["err"]["fwd"], ms=t["fwd_ms"], plain_ms=t["fwd_plain_ms"],
             bound_ms=t["fwd_bound_ms"], bound_by=t["fwd_bound_by"], library_ms=None,
             device_us_per_launch=device_us("pair_sum")),
        dict(name="pair_sum_grad_a", route="cuda", source="smmdax_torch/csrc/pair_sum.cu",
             replaces="smmdax/pallas/mmd_kernel.py:186", launches=flagship["pair_sum_grad_a"],
             max_abs_err=slice_k["err"]["bwd"], ms=t["bwd_ms"], plain_ms=t["bwd_plain_ms"],
             bound_ms=t["bwd_bound_ms"], bound_by=t["bwd_bound_by"], library_ms=None,
             device_us_per_launch=device_us("pair_sum_grad_a"),
             one_sweep=dict(ms=t["bwd2_ms"], plain_ms=t["bwd2_plain_ms"],
                            bound_ms=t["bwd2_bound_ms"])),
        dict(name="pair_stats", route="cuda", source="smmdax_torch/csrc/pair_stats.cu",
             replaces="smmdax/pallas/mmd_kernel.py:323", launches=ring["pair_stats"],
             max_abs_err=slice_s["err"]["fwd"], ms=ts["stats_fwd_ms"],
             plain_ms=ts["stats_fwd_plain_ms"], bound_ms=ts["stats_fwd_bound_ms"],
             bound_by=ts["stats_fwd_bound_by"], library_ms=None,
             device_us_per_launch=device_us("pair_stats"),
             one_sweep=dict(ms=ts["stats2_fwd_ms"], plain_ms=ts["stats2_fwd_plain_ms"],
                            bound_ms=ts["stats2_fwd_bound_ms"])),
        dict(name="pair_stats_grad_a", route="cuda", source="smmdax_torch/csrc/pair_stats.cu",
             replaces="smmdax/pallas/mmd_kernel.py:387", launches=ring["pair_stats_grad_a"],
             max_abs_err=slice_s["err"]["bwd"], ms=ts["stats_bwd_ms"],
             plain_ms=ts["stats_bwd_plain_ms"], bound_ms=ts["stats_bwd_bound_ms"],
             bound_by=ts["stats_bwd_bound_by"], library_ms=None,
             device_us_per_launch=device_us("pair_stats_grad_a"),
             one_sweep=dict(ms=ts["stats2_bwd_ms"], plain_ms=ts["stats2_bwd_plain_ms"],
                            bound_ms=ts["stats2_bwd_bound_ms"])),
    ]
    # launches on the training run of phase 5 (run A), on the DCGAN steps
    # of phase 6 (per macro-step) and on the toy run of phase 7, beside the
    # flagship step's
    for kern, counter in zip(kernels, KERNEL_PARTS):
        kern["trainer_launches"] = trainer[counter]
        kern["dcgan_launches_per_macro_step"] = {
            label: n[counter] / (TIMED_STEPS + 1) for label, n in dcgan.items()}
        kern["toy_launches"] = toy[counter]
        # phase 9: the 2-rank GSPMD and ring steps, per macro-step and rank
        kern["two_rank_launches_per_macro_step"] = {
            label: t["launches_per_macro_step"][counter] for label, t in ranks.items()}
        kern["two_rank_device_us_per_launch"] = {
            label: t["profile"]["csrc_device_us_per_launch"].get(counter)
            for label, t in ranks.items()}
        # phase 10: the flagship run with one 25,000-sample Inception event
        kern["inception_trainer_launches"] = inception[counter]
    card = card_line()
    results.update(kernels=kernels, card=card)
    write_results(args.out, results)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
