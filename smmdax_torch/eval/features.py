"""Feature extractors for FID/KID/IS (port of ``smmdax/eval/features.py``).

``RandomConvFeatures`` is the offline extractor: a fixed random 4-layer
convolutional projection, global-mean-pooled.  FID/KID on its features
still rank distributions by distance, so the scheduler and the score math
run without any asset; they are not comparable to Inception-based numbers.

Its default weights are drawn from ``torch.Generator().manual_seed(seed)``
on the CPU: JAX's PRNG cannot be reproduced in torch, so the port's
default random-conv scores differ in absolute value from the JAX
package's default ones.  With the same weights (``weights=``, e.g. from
``smmdax_torch.convert.random_conv_weights_from_jax``) the features, and
so the scores, are equal.

The Inception-v3 extractor is not ported yet (ROADMAP: Inception-v3): when its
weights asset is present, ``get_feature_extractor`` raises instead of
scoring with random features.
"""

from __future__ import annotations

import inspect
import math
import os
from typing import List, Optional, Protocol, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from smmdax_torch.train import resolve_device

Array = np.ndarray


class FeatureExtractor(Protocol):
    name: str
    feature_dim: int

    def __call__(self, images) -> Array:
        """(N, H, W, C) images in [-1, 1] -> (N, feature_dim) float32."""
        ...


def _same_pad(size: int, k: int = 3, stride: int = 2) -> tuple:
    """(before, after) padding of a SAME convolution, XLA's split: 0 / 1
    on even sizes for a stride-2 3x3 window, 1 / 1 on odd ones."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class RandomConvFeatures:
    """Fixed random 4-layer conv net (3x3, stride 2, SAME, leaky ReLU 0.2
    after the first three), mean over H and W.  Images (NHWC, numpy or a
    tensor) run ``batch`` at a time on ``device``; a tensor runs where it
    lives.  ``weights``: the four HWIO kernels, else drawn N(0, 2/fan_in)
    from ``seed`` at the first call (their input width follows the
    images')."""

    name = "random_conv"

    def __init__(self, feature_dim: int = 256, width: int = 64,
                 seed: int = 1234, batch: int = 256, device="cuda",
                 weights: Optional[Sequence[Array]] = None):
        self.feature_dim = feature_dim
        self.width = width
        self.batch = batch
        self.device = resolve_device(device)
        self._seed = seed
        self._weights: Optional[List[torch.Tensor]] = None
        if weights is not None:
            self._set(weights)

    def _set(self, weights: Sequence[Array]) -> None:
        # HWIO -> OIHW
        self._weights = [torch.from_numpy(np.array(w, np.float32)).permute(3, 2, 0, 1)
                         .contiguous() for w in weights]

    def _init(self, c_in: int) -> None:
        g = torch.Generator().manual_seed(self._seed)
        chans = [c_in, self.width, self.width * 2, self.width * 4, self.feature_dim]
        self._set([torch.randn((3, 3, chans[i], chans[i + 1]), generator=g).numpy()
                   * math.sqrt(2.0 / (9 * chans[i])) for i in range(4)])

    def _forward(self, ws: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i, w in enumerate(ws):
            (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
            if i < 3:
                x = F.leaky_relu(x, 0.2)
        return x.mean(dim=(2, 3))

    def __call__(self, images, fetch: bool = True):
        """(N, feature_dim) float32: numpy with ``fetch``, else a tensor on
        the device the features were computed on."""
        if isinstance(images, torch.Tensor):
            dev = images.device
        else:
            images, dev = np.asarray(images, np.float32), self.device
        if self._weights is None:
            self._init(images.shape[-1])
        ws = [w.to(dev) for w in self._weights]
        with torch.no_grad():
            outs = [self._forward(ws, torch.as_tensor(images[i:i + self.batch])
                                  .to(dev, torch.float32))
                    for i in range(0, len(images), self.batch)]
            # no images (a rank's empty share of a set): no features
            feats = torch.cat(outs) if outs else torch.empty((0, self.feature_dim), device=dev)
        return feats.cpu().numpy() if fetch else feats


def _takes_fetch(fn) -> bool:
    """Whether ``fn`` takes a ``fetch`` keyword (signature inspection, so a
    TypeError inside the sweep is never mistaken for its absence)."""
    try:
        return "fetch" in inspect.signature(fn).parameters
    except (TypeError, ValueError):     # builtins / odd callables
        return False


def extract_features(extractor: FeatureExtractor, images, fetch: bool = True):
    """``extractor(images)`` with ``fetch`` threaded when supported.
    Extractors without the flag return host arrays."""
    if _takes_fetch(extractor.__call__):
        return extractor(images, fetch=fetch)
    return extractor(images)


def extract_with_probs(extractor: FeatureExtractor, images, fetch: bool = True):
    """(features, probs-or-None) from ONE network sweep when the extractor
    supports it; ``fetch=False`` asks for outputs left on the device."""
    if hasattr(extractor, "features_and_probs"):
        fn = extractor.features_and_probs
        return fn(images, fetch=fetch) if _takes_fetch(fn) else fn(images)
    feats = extract_features(extractor, images, fetch=fetch)
    probs = None
    if hasattr(extractor, "probs"):
        fn = extractor.probs
        probs = fn(images, fetch=fetch) if _takes_fetch(fn) else fn(images)
    return feats, probs


def find_inception_weights(data_dir: str = "./data") -> Optional[str]:
    """First existing Inception weight asset under data_dir, if any."""
    for fname in ("inception_v3.pt", "inception_v3.pth", "inception_v3.npz",
                  "classify_image_graph_def.pb", "inception_v3.pb"):
        path = os.path.join(data_dir, fname)
        if os.path.exists(path):
            return path
    return None


def get_feature_extractor(data_dir: str = "./data", prefer_inception: bool = True,
                          device="cuda") -> FeatureExtractor:
    """The offline random-conv extractor on ``device``.  Raises when an
    Inception asset is present (and preferred): Inception is not ported yet,
    and silently scoring with random features would change the numbers."""
    path = find_inception_weights(data_dir)
    if prefer_inception and path is not None:
        raise NotImplementedError(
            f"Inception weights found at {path}, but the port's Inception "
            "extractor is not ported yet (ROADMAP: Inception-v3); move the asset away "
            "or pass prefer_inception=False to score with random conv features")
    return RandomConvFeatures(device=device)
