"""The readings a cell's limits are set from, on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control_seeds ...] [--fault_seeds ...] [--out chiprun_out/calib.jsonl]

For each seed of ``--seeds`` the program's set-up and checked readings
(as a run makes them) against the reference: the lower readings.  For
each of ``--control_seeds`` the control.  A training cell's is the
reference with every bfloat16 product taken in float8 (e4m3 forward, e5m2
gradients, one scale per tensor), put in the program's place.  A scoring
cell's is the reference in the program's place one precision below at
every stage (``control_event``); a ``train4`` cell's is the reference of
the data-parallel step with float8 products.  For each of
``--fault_seeds``: in a ``train4`` cell, each rank's own MMD^2 and half
of every rank's block left out, planted in that reference put in the
program's place, and rank 1 fed rank 0's block, planted in the program
(``block_gap``);
in a training cell the planted fault of half of the batch left out (the
reference on the first half of every real and fake batch, the means over
it) and, where the seed is also among ``--seeds``, the program's dispatch
reusing its first batch for all K macro-steps (``dispatch_gap``); in a
scoring cell the program with its own TF32 path switched on for
Inception, and the program sampling from its live weights, not the EMA.  One JSON line per reading; a summary of each number's largest
lower and smallest upper reading at the end.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import common  # noqa: E402
from benchmark import train_check as tc  # noqa: E402
from benchmark.reference import gan  # noqa: E402


def details(p: tc.Readings, r: tc.Readings) -> dict:
    """Per-macro-step loss gaps and the worst leaves, for the look."""
    per = [{k: abs(pl[k] - rl[k]) / max(abs(rl[k]), 1e-30) for k in tc.LOSS_KEYS}
           for pl, rl in zip(p.losses, r.losses)]

    def worst(pd, rd):
        out = {}
        for g in ("gen", "disc", "ema"):
            names = [k for k in rd if k.startswith(g + ".")]
            if not names:
                continue
            med = statistics.median(rd[k] for k in names)
            gaps = sorted(((abs(pd[k] - rd[k]) / max(rd[k], med, 1e-30), k) for k in names),
                          reverse=True)[:3]
            out[g] = [[k, v] for v, k in gaps]
        return out

    def median_gap(pd, rd):
        out = {}
        for g in ("gen", "disc", "ema"):
            names = [k for k in rd if k.startswith(g + ".")]
            if names:
                med = statistics.median(rd[k] for k in names)
                out[g] = statistics.median(abs(pd[k] - rd[k]) / max(rd[k], med, 1e-30)
                                           for k in names)
        return out

    return {"loss_per_step": per, "ref_losses": r.losses,
            "grad_worst": worst(p.grads, r.grads), "change_worst": worst(p.changes, r.changes),
            "grad_median_leaf": median_gap(p.grads, r.grads),
            "change_median_leaf": median_gap(p.changes, r.changes)}


def _train(c, t, args, dev, record) -> None:
    import numpy as np
    import torch
    from benchmark import train_cell
    from benchmark.feed import images
    refs = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        cfg, data, state, step, single, feed, prog = train_cell.start(c, t, seed, dev)
        state, gap = train_cell.dispatch_check(cfg, seed, state, step, single, feed, dev)
        if seed in args.fault_seeds:
            # the planted fault of a dispatch that reuses its first batch
            def stale(st, reals):
                return step(st, np.stack([reals[0]] * len(reals)))
            state, stale_gap = train_cell.dispatch_check(cfg, seed, state, stale, single, feed,
                                                         dev)
            record("stale_batch", seed, {"dispatch_gap": stale_gap}, {}, 0.0)
        feed.close()
        del state, step, single
        gc.collect()
        torch.cuda.empty_cache()
        ref = tc.reference_readings(c, seed, data, t["check_steps"], dev)
        ref.state = None
        refs[seed] = (data, ref)
        record("program", seed, {**tc.compare(prog, ref), "dispatch_gap": gap},
               details(prog, ref), time.perf_counter() - t0)
    for kind, seeds, kw in (("control", args.control_seeds, {"cast": gan.to_fp8_scaled}),
                            ("half_batch", args.fault_seeds, {"rows": c["batch_size"] // 2})):
        for seed in seeds:
            t0 = time.perf_counter()
            if seed in refs:
                data, ref = refs[seed]
            else:
                data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
                ref = tc.reference_readings(c, seed, data, t["check_steps"], dev)
            alt = tc.reference_readings(c, seed, data, t["check_steps"], dev, **kw)
            record(kind, seed, tc.compare(alt, ref), details(alt, ref), time.perf_counter() - t0)


def rank1_fed_rank0():
    """Plant the fault of rank 1's feed building rank 0's block of every
    batch, in the program (the port's ``macro_batch_at``); returns the
    function that takes it out."""
    import smmdax_torch.data.pipeline as pipeline
    real = pipeline.macro_batch_at

    def fed(source, step, per_step, batch, u8=False, block=None):
        if block is not None and block[0] == 1:
            block = (0, block[1])
        return real(source, step, per_step, batch, u8=u8, block=block)

    pipeline.macro_batch_at = fed
    return lambda: setattr(pipeline, "macro_batch_at", real)


def _train4_rank(axis, c, t, programs, jobs):
    """One rank of the ``train4`` calibration: the program's readings of
    every (kind, seed) of ``programs`` (all ranks together; kind
    ``rank1_block0`` with that fault planted), then its share of the
    reference's runs (``jobs``: (kind, seed, fault)), each on this rank's
    card; rank 0 returns both."""
    import torch
    from benchmark import train4_cell
    from benchmark.feed import images
    from benchmark.reference import gan_dp
    out = []
    for kind, seed in programs:
        t0 = time.perf_counter()
        undo = rank1_fed_rank0() if kind == "rank1_block0" else (lambda: None)
        try:
            cfg, data, state, step, single, feed, prog, fed = train4_cell.start(c, t, seed, axis)
        finally:
            undo()
        state, gaps = train4_cell.checks(cfg, c, seed, data, fed, state, step, single, feed,
                                         axis)
        feed.close()
        del state, step, single
        gc.collect()
        torch.cuda.empty_cache()
        out.append((kind, seed, prog, gaps, time.perf_counter() - t0))
    mine = {}
    for j, (kind, seed, fault) in enumerate(jobs):
        if j % axis.size == axis.index:
            t0 = time.perf_counter()
            data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
            cast = gan.to_fp8_scaled if kind == "control" else "config"
            r = tc.reference_readings(c, seed, data, t["check_steps"], axis.device, cast=cast,
                                      model=gan_dp, **fault)
            r.state = None
            mine[(kind, seed)] = (r, time.perf_counter() - t0)
    refs = {k: v for d in axis.gather_objects(mine) for k, v in d.items()}
    return out, refs


def _train4(c, t, args, record) -> None:
    """The program's readings on ``c["num_data_shards"]`` ranks, and four
    readings that must fail: the reference of the data-parallel step
    (``gan_dp``) in the program's place with float8 products (the
    control), with each rank's own MMD^2 (``global_batch_mmd=False``) and
    with half of every rank's block left out; and the program with rank 1
    fed rank 0's block."""
    from benchmark import ranks
    n = c["num_data_shards"]
    b = c["real_batch_size"] // n
    faults = {"own_mmd": {"local_mmd": True}, "half_batch": {"rows": b // 2}}
    extra = set(args.control_seeds) | set(args.fault_seeds)
    jobs = [("reference", s, {}) for s in sorted(set(args.seeds) | extra)]
    jobs += [("control", s, {}) for s in args.control_seeds]
    jobs += [(kind, s, faults[kind]) for kind in ("own_mmd", "half_batch")
             for s in args.fault_seeds]
    programs = [("program", s) for s in args.seeds]
    programs += [("rank1_block0", s) for s in args.fault_seeds]
    # a set-up and its checks take ~15 s on four ranks, a reference ~5 s
    deadline = 180.0 + 40.0 * len(programs) + 20.0 * len(jobs)
    got, refs = ranks.run(_train4_rank, n, "cuda", (c, t, programs, jobs), deadline=deadline)
    for kind, seed, prog, gaps, secs in got:
        ref, ref_s = refs[("reference", seed)]
        record(kind, seed, {**tc.compare(prog, ref), **gaps}, details(prog, ref),
               secs + ref_s)
    for kind, seed, _ in jobs:
        if kind != "reference":
            alt, secs = refs[(kind, seed)]
            ref = refs[("reference", seed)][0]
            record(kind, seed, tc.compare(alt, ref), details(alt, ref), secs)


def control_event(c: dict, t: dict, seed: int, data, path: str, dev) -> dict:
    """The scoring control: the reference in the program's place, one
    precision below what the configuration states at every stage: the
    set-up's macro-steps and the generator with their bfloat16 products in
    float8, Inception's float32 with TF32 on, the scores' float32 Gram and
    covariance products with TF32 on."""
    import math
    import torch
    from benchmark.reference import inception as ri
    from benchmark.score_cell import REAL_KEY, check_rows
    n, bs = c["no_of_samples"], c["batch_size"]
    st = tc.reference_readings(c, seed, data, t["train_steps"], dev, cast=gan.to_fp8_scaled).state
    gp = {k: v.detach() for k, v in (st.ema if st.ema is not None else st.gen).items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    zs = [torch.rand((bs, c["z_dim"]), generator=g, device=dev) * 2.0 - 1.0
          for _ in range(math.ceil(n / bs))]
    with torch.no_grad():
        imgs = torch.cat([gan.generator(c, gp, z, False, gan.to_fp8_scaled) for z in zs])[:n]
    params = ri.load(path, dev)
    real = gan.real_images(data, seed, REAL_KEY, n)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pools, probs, reals = [], [], []
        with torch.no_grad():
            for i in range(0, n, 64):
                f, logits = ri.forward(params, imgs[i:i + 64])
                pools.append(f)
                probs.append(torch.softmax(logits, 1))
                reals.append(ri.forward(params, torch.from_numpy(real[i:i + 64]).to(dev))[0])
        feats, probs, real_feats = torch.cat(pools), torch.cat(probs), torch.cat(reals)
        f32 = torch.float32
        scores = {"fid": ri.fid(real_feats, feats, f32),
                  "kid": ri.kid(real_feats, feats, min(c["score_subset_size"], n),
                                c["score_subsets"], f32),
                  "is": ri.inception_score(probs, dtype=f32)}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    rows = check_rows(seed, n)
    return {"rows": rows, "images": imgs[torch.as_tensor(rows)].float().cpu(), "scores": scores,
            "feats": feats, "probs": probs, "real_feats": real_feats}


def _score(c, t, args, dev, record) -> None:
    import torch
    from benchmark import score_cell, score_check
    from benchmark.feed import images

    import smmdax_torch.train as port_train

    def tf32(extractor):
        extractor._net.allow_tf32 = True

    real_sample = port_train.sample

    def live_sample(*a, **kw):
        return real_sample(*a, **{**kw, "use_ema": False})

    for kind, seeds, hook, sampler in (("program", args.seeds, None, real_sample),
                                       ("program_tf32", args.fault_seeds, tf32, real_sample),
                                       ("live_weights", args.fault_seeds, None, live_sample)):
        for seed in seeds:
            t0 = time.perf_counter()
            port_train.sample = sampler
            try:
                _, data, state, event, prev, readings, path = score_cell.start(c, t, seed, dev,
                                                                               hook)
            finally:
                port_train.sample = real_sample
            del state, event, prev
            gc.collect()
            torch.cuda.empty_cache()
            numbers = score_check.compare(c, t, seed, data, readings, path, dev)
            os.remove(path)
            record(kind, seed, numbers, {"scores": readings["scores"]},
                   time.perf_counter() - t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        data = images(seed, c["dataset_images"], c["output_size"], c["c_dim"])
        path = score_cell.weights_path()
        score_cell.write_inception_weights(path, seed, dev)
        readings = control_event(c, t, seed, data, path, dev)
        numbers = score_check.compare(c, t, seed, data, readings, path, dev)
        os.remove(path)
        record("control", seed, numbers, {"scores": readings["scores"]}, time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    bench = common.benchmark_file()
    cell = common.find(bench["workloads"], args.workload, "workload")
    c, t = common.load_config(cell["config"]), common.load_traffic(cell["traffic"])
    dev = torch.device("cuda")
    common.check_device(cell["chips"])
    out = open(args.out, "a") if args.out else None
    got = {"program": [], "control": [], "half_batch": [], "program_tf32": [],
           "stale_batch": [], "live_weights": [], "own_mmd": [], "rank1_block0": []}

    def record(kind: str, seed: int, numbers: dict, extra: dict, secs: float) -> None:
        got[kind].append(numbers)
        line = {"cell": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                "seconds": secs, **extra}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    if t["kind"] == "score":
        _score(c, t, args, dev, record)
    elif t["kind"] == "train4":
        _train4(c, t, args, record)
    else:
        _train(c, t, args, dev, record)
    summary = {}
    for key in sorted({k for n in got["program"] + got["control"] for k in n}):
        summary[key] = {
            "lower": max((n[key] for n in got["program"]), default=None),
            "control": min((n[key] for n in got["control"] if key in n), default=None),
            **{kind: min((n[key] for n in got[kind] if key in n), default=None)
               for kind in ("half_batch", "program_tf32", "stale_batch", "live_weights",
                            "own_mmd", "rank1_block0")}}
    print(json.dumps({"cell": args.workload, "summary": summary}), flush=True)
    if out:
        out.write(json.dumps({"cell": args.workload, "summary": summary}) + "\n")
        out.close()
    bad = common.loaded_forbidden()
    if bad:
        raise common.Refused("modules of the JAX stack were loaded: " + ", ".join(bad))


if __name__ == "__main__":
    main()
