"""Where the flagship's step time goes, the counterpart of the JAX
package's ``tools/profile_ablation.py``.

    python -m smmdax_torch.tools.profile_ablation [--batch 256] [--passes 3] [--device cpu]

It times the flagship's macro-step with batches drawn on the card
(``on_device_train_step``) under seven feature ablations (spectral norm,
the sigma double backward, the witness penalty, the dtype, the sigma
estimator), so the difference between two rows charges a cost to one
component.  Each row carries its own FLOPs (``macro_step_flops``), so
"cheaper because it does less work" and "cheaper because it runs the same
work faster" stay apart.  The configs are timed in interleaved round-robin
passes, so drift over the run lands on every config alike; each row is
the median over the passes, with the spread.  The peak comes from
``smmdax_torch.bench.PEAK_FLOPS``.  The default device is ``cuda``;
nothing falls back to the CPU.

Prints one JSON line per ablation.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from smmdax_torch.bench import barrier, peak_flops
WINDOW_STEPS = 10       # macro-steps per timed window


def _ablations(batch: int):
    from smmdax_torch.configs import Config
    base = dict(kernel="rq", architecture="resnet", dataset="synthetic",
                output_size=32, batch_size=batch, real_batch_size=batch,
                dof_dim=16, dsteps=5, gsteps=1, random_seed=0,
                on_device_data=True)
    flag = dict(compute_dtype="bfloat16", scaling_grad_estimator="hutchinson")
    return {
        "flagship_sn_smmd": Config(model="sn-smmd", **flag, **base),
        "no_sn (smmd)": Config(model="smmd", **flag, **base),
        "no_sigma (mmd+sn)": Config(model="mmd", with_sn=True,
                                    compute_dtype="bfloat16", **base),
        "plain_mmd": Config(model="mmd", compute_dtype="bfloat16", **base),
        "sigma_exact": Config(model="sn-smmd", compute_dtype="bfloat16",
                              scaling_grad_estimator="exact", **base),
        "f32_convs": Config(model="sn-smmd", compute_dtype="float32",
                            scaling_grad_estimator="hutchinson", **base),
        "gp_witness": Config(model="mmd", gradient_penalty=1.0,
                             compute_dtype="bfloat16", **base),
    }


class _Runner:
    """One ablation config's state and step, re-timeable across passes."""

    def __init__(self, cfg, device="cuda"):
        from smmdax_torch.train import create_state, on_device_train_step
        self.cfg = cfg
        self.state = create_state(cfg, 0, device=device)
        self.device = self.state.device
        self.step = on_device_train_step(cfg, cfg.dsteps, cfg.gsteps)
        for _ in range(2):                       # warm-up
            self.state, m = self.step(self.state)
            barrier(self.device, m)
        self.times = []

    def window(self) -> None:
        t0 = time.time()
        for _ in range(WINDOW_STEPS):
            self.state, m = self.step(self.state)
        barrier(self.device, m)
        self.times.append((time.time() - t0) / WINDOW_STEPS)

    def flops(self) -> float:
        from smmdax_torch.train import macro_step_flops
        return macro_step_flops(self.cfg, self.cfg.dsteps, self.cfg.gsteps, self.device)


def main(argv=None) -> None:
    from smmdax_torch.train import resolve_device
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--passes", type=int, default=3,
                   help="interleaved timing passes over all configs")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; nothing falls back to the CPU)")
    a = p.parse_args(argv)
    if a.passes < 1:
        p.error("--passes must be >= 1")
    device = resolve_device(a.device)
    peak = peak_flops(device)

    # the attribution is the DIFFERENCE between configs: interleaved
    # passes, a median per config, and the spread so drift stays visible
    runners = {name: _Runner(cfg, device) for name, cfg in _ablations(a.batch).items()}
    for _ in range(a.passes):
        for r in runners.values():
            r.window()
    for name, r in runners.items():
        med = statistics.median(r.times)
        per_step_imgs = (r.cfg.dsteps + r.cfg.gsteps) * r.cfg.batch_size
        row = {"ablation": name, "macro_step_ms": round(med * 1e3, 1),
               "window_ms": [round(t * 1e3, 1) for t in r.times],
               "spread_pct": round(100 * (max(r.times) - min(r.times)) / med, 1),
               "images_per_sec": round(per_step_imgs / med, 1)}
        flops = r.flops()
        row["tflops"] = round(flops / 1e12, 2)
        row["tflops_per_sec"] = round(flops / med / 1e12, 2)
        if peak:
            row["mfu"] = round(flops / med / peak, 4)
        print(json.dumps(row))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
