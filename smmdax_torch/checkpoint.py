"""Checkpoints of the full training state (port of ``smmdax/checkpoint.py``
on ``torch.save`` / ``torch.load``).

A checkpoint holds everything the next macro-step reads, so a resumed run
continues bit for bit: both modules' parameters and buffers (BN running
averages, spectral-norm ``u``), both Adam states (count, mu, nu), both
EMA shadows, ``lr_d`` / ``lr_g``, ``step``, ``sched_fails`` and the state
of the train step's ``torch.Generator``.  Tensors are stored on the CPU,
so a checkpoint written on the card loads on the CPU and back.

Layout under the manager's directory: ``<step>.pt`` per periodic save
(the newest ``max_to_keep`` kept), and ``best/state/{state.pt,meta.json}``
for the KID scheduler's best snapshot.  Every file is written under a
temporary name and renamed; the best directory is swapped through
``state.new`` / ``state.old`` so that a crash at any point leaves one
complete (state, meta) pair.  Saves are synchronous: the step mutates the
state in place, so a save must finish before training continues.

Toggling the EMA across a resume keeps the JAX package's semantics: with
the EMA on and no shadow in the checkpoint, the shadows start from the
restored live weights and BN statistics; with the EMA off, saved shadows
are dropped.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

from smmdax_torch.train import AdamState, TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _cpu(tensors: Optional[Dict[str, torch.Tensor]]):
    if tensors is None:
        return None
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def state_dict(state: TrainState) -> Dict[str, Any]:
    """Every field of ``state`` as CPU tensors and Python numbers."""
    def adam(opt: AdamState):
        return {"count": opt.count, "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}

    return {
        "step": int(state.step),
        "sched_fails": int(state.sched_fails),
        "generator": state.generator.get_state(),
        "gen": _cpu(state.gen.state_dict()),
        "disc": _cpu(state.disc.state_dict()),
        "g_opt": adam(state.g_opt),
        "d_opt": adam(state.d_opt),
        "lr_g": state.lr_g.detach().cpu(),
        "lr_d": state.lr_d.detach().cpu(),
        "g_params_ema": _cpu(state.g_params_ema),
        "g_stats_ema": _cpu(state.g_stats_ema),
    }


def load_state_dict(state: TrainState, sd: Dict[str, Any]) -> TrainState:
    """Load ``sd`` into ``state`` in place (its device kept) and return
    it.  Whether EMA shadows are kept follows ``state``: present there,
    they are loaded, or backfilled from the loaded live weights and BN
    statistics when ``sd`` has none; absent there, saved ones are dropped."""
    dev = state.device

    def to_dev(tensors):
        return {k: v.to(dev) for k, v in tensors.items()}

    def adam(d) -> AdamState:
        return AdamState(count=int(d["count"]), mu=to_dev(d["mu"]), nu=to_dev(d["nu"]))

    state.gen.load_state_dict(sd["gen"])
    state.disc.load_state_dict(sd["disc"])
    state.g_opt = adam(sd["g_opt"])
    state.d_opt = adam(sd["d_opt"])
    state.lr_g = sd["lr_g"].to(dev)
    state.lr_d = sd["lr_d"].to(dev)
    state.step = int(sd["step"])
    state.sched_fails = int(sd["sched_fails"])
    state.generator.set_state(sd["generator"])
    if state.g_params_ema is not None:
        if sd["g_params_ema"] is not None:
            state.g_params_ema = to_dev(sd["g_params_ema"])
        else:
            state.g_params_ema = {n: p.detach().clone()
                                  for n, p in state.gen.named_parameters()}
        if sd["g_stats_ema"] is not None:
            state.g_stats_ema = to_dev(sd["g_stats_ema"])
        else:
            state.g_stats_ema = {n: b.detach().clone()
                                 for n, b in state.gen.named_buffers()}
    return state


def _like(state: TrainState) -> TrainState:
    """A separate state with ``state``'s modules, device and EMA setting,
    to be overwritten by ``load_state_dict``; shares no tensor with it."""
    ema = state.g_params_ema is not None
    return TrainState(
        step=0, generator=torch.Generator(device=state.device),
        gen=copy.deepcopy(state.gen), disc=copy.deepcopy(state.disc),
        g_opt=state.g_opt, d_opt=state.d_opt,
        lr_g=state.lr_g.clone(), lr_d=state.lr_d.clone(),
        g_params_ema={} if ema else None, g_stats_ema={} if ema else None)


def _save_file(obj: Dict[str, Any], path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load_file(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")

    def _steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: TrainState) -> None:
        """Write the checkpoint of ``step`` and drop all but the newest
        ``max_to_keep``."""
        _save_file(state_dict(state), self._path(step))
        steps = self._steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Optional[TrainState]:
        """Load the latest checkpoint (or ``step``'s) into ``state`` in
        place and return it; None, with ``state`` untouched, if nothing
        was saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return load_state_dict(state, _load_file(self._path(step)))

    def save_best(self, state: TrainState, meta: Optional[dict] = None) -> None:
        """Overwrite the best-so-far snapshot (KID scheduler).  ``meta``
        (``{"best_kid": ..., "best_step": ...}``) is written inside the
        state directory before the swap, so state and meta never mismatch."""
        path = os.path.join(self._best_dir, "state")
        path_new, path_old = path + ".new", path + ".old"
        if os.path.exists(path_old) and not os.path.exists(path):
            # a prior crash landed between the two renames: state.old is
            # the only complete pair, so promote it before deleting anything
            os.rename(path_old, path)
        for p in (path_new, path_old):
            if os.path.exists(p):
                shutil.rmtree(p)
        os.makedirs(path_new)
        _save_file(state_dict(state), os.path.join(path_new, "state.pt"))
        if meta is not None:
            with open(os.path.join(path_new, "meta.json"), "w") as f:
                json.dump(meta, f)
        # at every instant either `state` or `state.old` is a complete pair
        if os.path.exists(path):
            os.rename(path, path_old)
        os.rename(path_new, path)
        if os.path.exists(path_old):
            shutil.rmtree(path_old)

    def _best_state_dir(self) -> Optional[str]:
        path = os.path.join(self._best_dir, "state")
        if os.path.exists(path):
            return path
        if os.path.exists(path + ".old"):     # crashed mid-swap
            return path + ".old"
        return None

    def best_meta(self) -> Optional[dict]:
        d = self._best_state_dir()
        if d is None or not os.path.exists(os.path.join(d, "meta.json")):
            return None
        with open(os.path.join(d, "meta.json")) as f:
            return json.load(f)

    def restore_best(self, state: TrainState) -> Optional[TrainState]:
        """The best snapshot as a NEW state shaped like ``state`` (same
        device and EMA setting), or None.  ``state`` itself is neither
        read nor changed beyond its shape."""
        d = self._best_state_dir()
        if d is None:
            return None
        return load_state_dict(_like(state), _load_file(os.path.join(d, "state.pt")))

    def close(self) -> None:
        """Nothing is held open between calls (saves are synchronous)."""
