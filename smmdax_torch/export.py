"""Export a trained generator as a ``torch.export`` program (port of
``tools/export_generator.py``).

The serving path (load a checkpoint, then batched G(z)): the eval-mode
generator, carrying the weights that ``sample`` decodes with (the EMA
shadow pair when the run tracked one) as its own weights, is exported with
``torch.export.export`` and saved with ``torch.export.save``: one file that
``torch.export.load`` runs WITHOUT this repo or the checkpoint.

  python -m smmdax_torch.export --checkpoint_dir ckpt/... --out gen.pt2 \\
      [--batch 512] [--use_best] [--device cuda] \\
      [--model sn-smmd --architecture resnet --output_size 32 ...]

The program's calling convention is ``call(z) -> images`` with ``z:
(batch, z_dim) float32`` and images (batch, H, W, C) in [-1, 1]; metadata
(shapes, config provenance, the device it was exported on) is written
beside it as ``<out>.json``.  Its tensors live on the device of the state
it was exported from, so it runs there.

Loading needs only torch:
  gen = torch.export.load("gen.pt2").module()
  imgs = gen(z)
"""

from __future__ import annotations

import copy
import json
import os

import torch
from torch import nn

from smmdax_torch.configs import Config
from smmdax_torch.train import TrainState, eval_g_params, eval_g_stats


class _Serve(nn.Module):
    """``gen(z, train=False)`` as a one-argument module."""

    def __init__(self, gen: nn.Module):
        super().__init__()
        self.gen = gen

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.gen(z, train=False)


def export_generator(cfg: Config, state: TrainState, batch: int):
    """The eval-mode generator of ``state`` as an ``ExportedProgram`` taking
    ``z`` of shape (batch, z_dim), float32, on the state's device."""
    gen = copy.deepcopy(state.gen)
    # serve the EMA shadow pair when the run tracked one (ema_decay > 0)
    gen.load_state_dict({**eval_g_params(state), **eval_g_stats(state)}, strict=True)
    serve = _Serve(gen).eval().requires_grad_(False)
    z = torch.zeros((batch, cfg.z_dim), dtype=torch.float32, device=state.device)
    return torch.export.export(serve, (z,))


def load_generator(path: str) -> nn.Module:
    """The runnable module of an exported generator: ``gen(z) -> images``."""
    return torch.export.load(path).module()


def main(argv=None) -> None:
    from smmdax_torch.checkpoint import CheckpointManager
    from smmdax_torch.configs import build_argparser, config_from_namespace
    from smmdax_torch.train import create_state

    ap = build_argparser()          # the full training flag surface
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--use_best", action="store_true",
                    help="export the scheduler's best snapshot instead "
                         "of the latest checkpoint")
    ap.add_argument("--allow_untrained", action="store_true",
                    help="export from random init when no checkpoint "
                         "directory exists (smoke/CI use only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the exported program runs there")
    args = ap.parse_args(argv)
    cfg = config_from_namespace(args)

    state = create_state(cfg, seed=cfg.random_seed, device=args.device)
    step = None
    # the trainer nests runs as checkpoint_dir/run_name(); accept either
    # the parent (same flags as the training run) or the run dir itself
    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.run_name())
    if not os.path.isdir(ckpt_dir):
        ckpt_dir = cfg.checkpoint_dir
    if cfg.checkpoint_dir and os.path.isdir(ckpt_dir):
        mgr = CheckpointManager(ckpt_dir)
        restored = mgr.restore_best(state) if args.use_best else mgr.restore(state)
        if restored is None:
            raise SystemExit(
                f"[export] no checkpoint under {cfg.checkpoint_dir!r} "
                "(pass a trained run's --checkpoint_dir)")
        state = restored
        step = int(state.step)
        print(f"[export] restored {'best' if args.use_best else 'latest'} "
              f"checkpoint at step {step}")
    elif args.allow_untrained:
        print("[export] NOTE: --allow_untrained — exporting an UNTRAINED "
              "generator (smoke/CI use)")
    else:
        # a typo'd / unmounted path must never silently become a
        # valid-looking artifact built from random weights
        raise SystemExit(
            f"[export] checkpoint directory not found: "
            f"{cfg.checkpoint_dir!r} (nor a {cfg.run_name()!r} run dir "
            "under it); pass a trained run's --checkpoint_dir, or "
            "--allow_untrained for a smoke export")

    torch.export.save(export_generator(cfg, state, args.batch), args.out)
    meta = {"batch": args.batch, "z_dim": cfg.z_dim,
            "image_shape": list(cfg.image_shape), "step": step,
            "model": cfg.model, "architecture": cfg.architecture,
            "output_size": cfg.output_size,
            "platforms": [state.device.type]}
    with open(args.out + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"[export] wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB) + .json")


if __name__ == "__main__":
    main()
