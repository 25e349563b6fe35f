"""Carry weights from the JAX package's state into the port's.

Takes flax trees whose leaves are numpy arrays (e.g. a ``smmdax``
``TrainState`` after ``jax.tree.map(np.asarray, state)``) and maps them
by name onto the port's modules:

* HWIO conv kernels -> OIHW ``weight``; (in, out) dense kernels ->
  (out, in) ``weight``; the HWIO kernels of flax's ``ConvTranspose``,
  which does not flip them, -> flipped in H and W and laid out (in, out,
  H, W) for ``conv_transpose2d``, which does;
* BatchNorm ``scale``/``bias`` and running ``mean``/``var``, spectral-norm
  ``u`` (keyed on the out dim) and biases carry over unchanged;
* Adam's count, mu and nu, both EMA shadows, the learning rates, the step
  and the scheduler's failure count.

The port's module names follow the flax tree, so ``block0/conv1/kernel``
becomes ``block0.conv1.weight``.  A kernel's layout depends on the module
that holds it, so trees are flattened against the port's module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from smmdax_torch.configs import Config
from smmdax_torch.nn.layers import ConvTranspose
from smmdax_torch.train import AdamState, TrainState, create_state

Array = np.ndarray


def _leaf(name: str, arr: Array, transposed: bool):
    if name == "kernel":
        if arr.ndim == 4 and transposed:        # HWIO, flipped -> (I, O, H, W)
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if arr.ndim == 4:                       # HWIO -> OIHW
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:                       # (in, out) -> (out, in)
            return "weight", arr.T
        raise ValueError(f"kernel of rank {arr.ndim}")
    return name, arr


def flatten(tree: Mapping[str, Any], module: Optional[nn.Module] = None,
            prefix: str = "") -> Dict[str, Array]:
    """flax tree -> {torch state-dict name: array in torch layout}.  The
    kernels of ``module``'s ``ConvTranspose`` layers take their layout;
    without ``module`` every 4-D kernel is a convolution's."""
    out: Dict[str, Array] = {}
    owner = module.get_submodule(prefix[:-1]) if module is not None and prefix else module
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten(value, module, f"{prefix}{key}."))
        else:
            name, arr = _leaf(key, np.asarray(value), isinstance(owner, ConvTranspose))
            out[prefix + name] = np.ascontiguousarray(arr)
    return out


def _tensors(flat: Dict[str, Array], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in flat.items()}


def load_module(module: nn.Module, *trees: Mapping[str, Any]) -> None:
    """Load flax trees (params, batch_stats / spectral) into ``module``;
    every parameter and buffer must be covered."""
    flat: Dict[str, Array] = {}
    for tree in trees:
        flat.update(flatten(tree, module))
    device = next(module.parameters()).device
    module.load_state_dict(_tensors(flat, device), strict=True)


def _adam(opt_state, module: nn.Module, device) -> AdamState:
    return AdamState(count=int(np.asarray(opt_state.count)),
                     mu=_tensors(flatten(opt_state.mu, module), device),
                     nu=_tensors(flatten(opt_state.nu, module), device))


def state_from_jax(cfg: Config, jstate, device="cuda") -> TrainState:
    """The port's TrainState holding the JAX state's values.  The noise
    generator is fresh: JAX keys do not translate (tests replay draws
    through ``train_step(..., noise=...)``)."""
    state = create_state(cfg, device=device)
    dev = state.device
    load_module(state.gen, jstate.g_params, jstate.g_batch_stats)
    load_module(state.disc, jstate.d_params, jstate.d_spectral)
    state.g_opt = _adam(jstate.g_opt_state, state.gen, dev)
    state.d_opt = _adam(jstate.d_opt_state, state.disc, dev)
    state.lr_g = torch.tensor(float(np.asarray(jstate.lr_g)), device=dev)
    state.lr_d = torch.tensor(float(np.asarray(jstate.lr_d)), device=dev)
    state.step = int(np.asarray(jstate.step))
    if jstate.sched_fails is not None:
        state.sched_fails = int(np.asarray(jstate.sched_fails))
    if jstate.g_params_ema is not None:
        state.g_params_ema = _tensors(flatten(jstate.g_params_ema, state.gen), dev)
    if jstate.g_stats_ema is not None:
        state.g_stats_ema = _tensors(flatten(jstate.g_stats_ema, state.gen), dev)
    return state


def random_conv_weights_from_jax(extractor, c_in: int = 3) -> List[Array]:
    """The four HWIO kernels of the JAX package's ``RandomConvFeatures``
    (drawn for ``c_in`` input channels if it has not run yet), as numpy:
    pass them as ``weights=`` to the port's ``RandomConvFeatures`` for
    features, and so scores, equal to the JAX extractor's."""
    if extractor._params is None:
        extractor._init(c_in)
    return [np.asarray(w, np.float32) for w in extractor._params]
