"""What decides ``correct`` in a training cell.

Set-up drives the program's state through its first ``check_steps``
macro-steps, each a dispatch of one through the port's
``dispatch_train_step`` (the function whose K-macro-step form the window
calls, which loops it), fed by the window's feed; the plain reference
(``benchmark/reference/gan.py``) follows the same macro-steps from the
seed.  Three numbers are compared, each against its limit in the
configuration file (a fourth is read beside them):

* ``loss_gap``: the largest relative gap of a macro-step's last critic
  objective (``d_ratio``) or its generator MMD^2 (``g_loss``), over the
  checked macro-steps;
* ``first_loss_gap``: the same over the first checked macro-step alone,
  which the later macro-steps' divergence between bfloat16 and float32
  does not reach (the ``train4`` cell compares it in ``loss_gap``'s
  place; a cell compares the numbers its limits name);
* ``grad_gap``: the gradient as Adam holds it after the first macro-step
  (the bias-corrected first moment: the generator's first gradient, the
  critic's first ``dsteps`` gradients mixed), by median leaf: the larger
  of the generator's and the critic's median leaf gap;
* ``change_gap``: how far each leaf moved over the checked macro-steps
  (the critic, the generator with its BN running averages and the EMA
  shadows), by worst leaf.

A fourth number holds the window's own callable, the K-macro-step
dispatch, to the dispatch of one that the three above read:

* ``dispatch_gap``: after the window, a copy of the program's state runs
  each macro-step of two of the window's dispatches as a dispatch of one,
  on the same batches; the largest absolute difference of any tensor of
  the two states (weights, BN and spectral-norm buffers, Adam moments,
  EMA shadows, learning rates) or of the last macro-step's losses.  The
  dispatch promises the state bit-identical, so its limit is 0; a
  different step count or noise stream reads infinitely far.

Over ranks (the ``train4`` cell) two more numbers hold the state
replicated, as the data-parallel step promises, and each rank to its own
block of the global batch:

* ``rank_gap``: after the window, the largest absolute difference between
  any tensor of a rank's state and rank 0's (the noise streams apart,
  which are each rank's own), or infinitely far where a step count
  differs.  Its limit is 0.
* ``block_gap``: the largest absolute difference, over the ranks, between
  the uint8 rows a rank's feed handed to each checked macro-step and that
  rank's columns of the reference's global batch
  (``gan.real_batches``), or infinitely far where a shape differs.  With
  uniform data a rank fed another's block, or a block half left out,
  moves the global MMD^2 less than bfloat16 rounding does, so the
  numbers above cannot see it; this one can.  Its limit is 0.

A leaf's gap: the gap between the program's norm of the leaf and the
reference's, over the reference's norm of that leaf or of the group's
median leaf, whichever is larger.  The gradient is held by the median
leaf because its worst leaf is one small leaf's noise (a bias of 3, a BN
scale): sound runs read up to a third of the control there.  Leaves whose reference gradient is
under a thousandth of the median leaf's (the critic head's bias, the
generator convolutions' biases ahead of BN: zero in exact arithmetic)
move under Adam by round-off alone and are left out of ``change_gap``.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import gan

LOSS_KEYS = ("d_ratio", "g_loss")
NOUGHT = 1e-3


class Readings:
    """Per-macro-step losses, gradient norms after the first and change
    norms after the last, keyed ``gen.*``, ``disc.*``, ``ema.*``; the
    reference's keep its state after the last (``state``)."""

    def __init__(self):
        self.losses: List[Dict[str, float]] = []
        self.grads: Dict[str, float] = {}
        self.changes: Dict[str, float] = {}
        self.state: Optional[gan.State] = None


def _bc(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def grad_norms(prefix: str, mu: Dict[str, torch.Tensor], count: int, b1: float
               ) -> Dict[str, float]:
    bc = _bc(b1, count)
    return {f"{prefix}.{k}": float(torch.linalg.vector_norm(v.float() / bc)) for k, v in mu.items()}


def snapshot(groups: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{g}.{k}": v.detach().clone() for g, d in groups.items() for k, v in d.items()}


def change_norms(before: Dict[str, torch.Tensor], groups: Dict[str, Dict[str, torch.Tensor]]
                 ) -> Dict[str, float]:
    return {f"{g}.{k}": float(torch.linalg.vector_norm((v.detach() - before[f"{g}.{k}"]).float()))
            for g, d in groups.items() for k, v in d.items()}


def program_groups(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's ``TrainState`` leaves that the comparison reads."""
    gen = {**dict(state.gen.named_parameters()), **dict(state.gen.named_buffers())}
    out = {"gen": gen, "disc": dict(state.disc.named_parameters())}
    if state.g_params_ema is not None:
        out["ema"] = {**state.g_params_ema, **state.g_stats_ema}
    return out


def program_grads(state, b1: float) -> Dict[str, float]:
    return {**grad_norms("gen", state.g_opt.mu, state.g_opt.count, b1),
            **grad_norms("disc", state.d_opt.mu, state.d_opt.count, b1)}


def reference_groups(st: gan.State) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {"gen": dict(st.gen),
           "disc": {k: v for k, v in st.disc.items() if not gan.is_buffer(k)}}
    if st.ema is not None:
        out["ema"] = dict(st.ema)
    return out


def compute_cast(c: dict):
    """The reference's cast of the configuration's compute dtype."""
    return gan.to_bf16 if c["compute_dtype"] == "bfloat16" else None


def reference_readings(c: dict, seed: int, data: np.ndarray, steps: int,
                       device, cast="config", model=gan, **fault) -> Readings:
    """The reference (or, with another ``cast`` or a ``fault`` of
    ``model.macro_step``, the control or a planted fault) over the checked
    macro-steps, from the seed.  ``model``: ``gan``, or ``gan_dp`` for the
    data-parallel step over ``c["num_data_shards"]`` ranks."""
    if cast == "config":
        cast = compute_cast(c)
    st = model.State(c, seed, device)
    before = snapshot(reference_groups(st))
    dsteps, gsteps = c["dsteps"], c["gsteps"]
    r = Readings()
    for i in range(steps):
        real = gan.real_batches(data, seed, i, dsteps + gsteps, c["real_batch_size"])
        out = model.macro_step(c, st, torch.from_numpy(real), dsteps, gsteps, cast, **fault)
        r.losses.append({key: float(out[key]) for key in LOSS_KEYS})
        if i == 0:
            r.grads = {**grad_norms("gen", st.adam["gen"][0], st.count["gen"], c["beta1"]),
                       **grad_norms("disc", st.adam["disc"][0], st.count["disc"], c["beta1"])}
    r.changes = change_norms(before, reference_groups(st))
    r.state = st
    return r


def same_state(a, b, ma: Dict[str, torch.Tensor], mb: Dict[str, torch.Tensor]) -> float:
    """``dispatch_gap`` of two ``TrainState``s and their last losses."""
    from smmdax_torch.checkpoint import state_dict
    sa, sb = state_dict(a), state_dict(b)
    if (sa["step"], sa["sched_fails"]) != (sb["step"], sb["sched_fails"]) or \
            not torch.equal(sa.pop("generator"), sb.pop("generator")):
        return float("inf")
    worst = 0.0

    def walk(x, y) -> None:
        nonlocal worst
        if isinstance(x, dict) and isinstance(y, dict) and set(x) == set(y):
            for k in x:
                walk(x[k], y[k])
        elif isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                and x.shape == y.shape and x.dtype == y.dtype:
            if x.numel():
                gap = float((x.double() - y.double()).abs().max())
                worst = max(worst, gap if np.isfinite(gap) else np.inf)
        elif x != y:
            worst = np.inf

    walk(sa, sb)
    walk({k: ma[k] for k in LOSS_KEYS}, {k: mb[k] for k in LOSS_KEYS})
    return float(worst)


def _leaves(sd: dict, prefix: str = ""):
    """(name, value) of every tensor and number of a state dict."""
    for k, v in sd.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def rank_gap(state, axis) -> float:
    """``rank_gap`` of this rank's ``TrainState``, the same on every rank
    of ``axis``.  Each rank hashes its tensors; those whose hash differs
    from rank 0's on any rank are sent from rank 0 and compared."""
    import hashlib
    from smmdax_torch.checkpoint import state_dict
    sd = state_dict(state)
    sd.pop("generator")
    leaves = dict(_leaves(sd))

    def digest(v) -> str:
        if not isinstance(v, torch.Tensor):
            return repr(v)
        raw = v.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        return f"{v.dtype}{tuple(v.shape)}" + hashlib.sha256(raw).hexdigest()

    mine = {k: digest(v) for k, v in leaves.items()}
    every = axis.gather_objects(mine)
    differ = sorted({k for d in every for k in set(d) | set(every[0])
                     if d.get(k) != every[0].get(k)})
    worst = 0.0
    for k in differ:
        ref = axis.broadcast_object(leaves.get(k))
        v = leaves.get(k)
        if (isinstance(v, torch.Tensor) and isinstance(ref, torch.Tensor)
                and v.shape == ref.shape and v.numel()):
            gap = float((v.double() - ref.double()).abs().max())
        else:
            gap = 0.0 if not isinstance(v, torch.Tensor) and v == ref else np.inf
        worst = max(worst, gap if np.isfinite(gap) else np.inf)
    return float(max(axis.gather_objects(worst)))


def block_gap(c: dict, seed: int, data: np.ndarray, fed, axis) -> float:
    """``block_gap`` of the batches ``fed`` to this rank's checked
    macro-steps (one (per_step, B / ranks, H, W, C) uint8 block each, in
    step order), the same on every rank of ``axis``."""
    b = c["real_batch_size"] // axis.size
    worst = 0.0 if fed else np.inf
    for step, got in enumerate(fed):
        want = gan.real_batches(data, seed, step, c["dsteps"] + c["gsteps"],
                                c["real_batch_size"])[:, axis.index * b:(axis.index + 1) * b]
        got = np.asarray(got)
        if got.shape != want.shape or got.dtype != want.dtype:
            worst = np.inf
        else:
            worst = max(worst, float(np.abs(got.astype(np.int16) - want).max()))
    return float(max(axis.gather_objects(worst)))


def _worst(p: Dict[str, float], r: Dict[str, float], keys) -> float:
    worst = 0.0
    groups: Dict[str, List[str]] = {}
    for k in keys:
        groups.setdefault(k.split(".", 1)[0], []).append(k)
    for names in groups.values():
        med = statistics.median(r[k] for k in names)
        for k in names:
            gap = abs(p.get(k, np.nan) - r[k]) / max(r[k], med, 1e-30)
            worst = max(worst, gap if np.isfinite(gap) else np.inf)
    return worst


def _median(p: Dict[str, float], r: Dict[str, float]) -> float:
    """The larger of the groups' median leaf gaps."""
    worst = 0.0
    for g in sorted({k.split(".", 1)[0] for k in r}):
        names = [k for k in r if k.startswith(g + ".")]
        med = statistics.median(r[k] for k in names)
        gaps = [abs(p.get(k, np.nan) - r[k]) / max(r[k], med, 1e-30) for k in names]
        if not np.all(np.isfinite(gaps)):
            return np.inf
        worst = max(worst, statistics.median(gaps))
    return worst


def compare(p: Readings, r: Readings) -> Dict[str, float]:
    """The three numbers of the module docstring (a missing or non-finite
    reading of the program counts as infinitely far)."""
    gaps = [abs(pl.get(k, np.nan) - rl[k]) / max(abs(rl[k]), 1e-30)
            for pl, rl in zip(p.losses, r.losses) for k in LOSS_KEYS]
    loss = max(gaps) if gaps and len(p.losses) == len(r.losses) else np.inf
    if not np.all(np.isfinite(gaps)):
        loss = np.inf
    first = max(gaps[:len(LOSS_KEYS)]) if np.isfinite(loss) else np.inf
    med = {g: statistics.median(v for k, v in r.grads.items() if k.startswith(g + "."))
           for g in ("gen", "disc")}
    nought = {k for k, v in r.grads.items() if v < NOUGHT * med[k.split(".", 1)[0]]}
    # an EMA shadow follows its generator leaf
    nought |= {"ema." + k.split(".", 1)[1] for k in nought if k.startswith("gen.")}
    grad = _median(p.grads, r.grads)
    change = _worst(p.changes, r.changes, [k for k in r.changes if k not in nought])
    out = {"loss_gap": loss, "first_loss_gap": first, "grad_gap": grad, "change_gap": change}
    return {k: (float(v) if np.isfinite(v) else float("inf")) for k, v in out.items()}




