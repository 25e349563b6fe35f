#!/usr/bin/env python3
"""Drive the PyTorch port (``smmdax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --tree DIR --only profile

(The second form profiles the bf16 steps of phases 3 and 4 of the
``smmdax_torch`` in DIR, e.g. an earlier commit unpacked by ``git
archive``, to compare its kernels' device time with this tree's.)

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
   against the one-rank result.

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="write all results as JSON here")
    parser.add_argument("--tree", default=HERE,
                        help="import smmdax_torch from this checkout (default: beside "
                             "this script), e.g. an earlier commit unpacked by git archive")
    parser.add_argument("--only", choices=("profile",), default=None,
                        help="profile: build, then only the timed and profiled bf16 "
                             "steps of phases 3 and 4; prints the launches and device "
                             "us per launch of each csrc kernel, and no ok line")
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
    # launches on the training run of phase 5 (run A) beside the step's
    for kern, counter in zip(kernels, KERNEL_PARTS):
        kern["trainer_launches"] = trainer[counter]
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
