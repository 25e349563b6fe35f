"""Feature extractors for FID/KID/IS (port of ``smmdax/eval/features.py``).

``InceptionFeatures`` runs Inception-v3 (``smmdax_torch.eval.inception``)
when its weights asset is present: pool3 features for FID/KID, class
probabilities for the Inception Score.  ``RandomConvFeatures`` is the
offline extractor: a fixed random 4-layer convolutional projection,
global-mean-pooled.  FID/KID on its features
still rank distributions by distance, so the scheduler and the score math
run without any asset; they are not comparable to Inception-based numbers.

Its default weights are drawn from ``torch.Generator().manual_seed(seed)``
on the CPU: JAX's PRNG cannot be reproduced in torch, so the port's
default random-conv scores differ in absolute value from the JAX
package's default ones.  With the same weights (``weights=``, e.g. from
``smmdax_torch.convert.random_conv_weights_from_jax``) the features, and
so the scores, are equal.
"""

from __future__ import annotations

import inspect
import math
import os
from typing import List, Optional, Protocol, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from smmdax_torch import tracing
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


class InceptionFeatures:
    """Inception-v3 pool3 features + class probs from the weights asset at
    ``weights_path`` (a torchvision ``inception_v3`` state dict as ``.pt`` /
    ``.pth`` / ``.npz``, or the frozen TF FID graph ``.pb``), on ``device``.
    Raises FileNotFoundError naming the asset when it is absent.

    ``__call__`` returns pool3 (2048-d) for FID/KID, ``probs`` the softmax
    for the Inception Score, ``features_and_probs`` both from one sweep;
    ``fetch=False`` leaves them on the device.  ``fid_semantics=None``
    detects the FID graph's pooling from the fc width."""

    name = "inception_v3"
    feature_dim = 2048

    def __init__(self, weights_path: str, batch: int = 64,
                 fid_semantics: Optional[bool] = None, device="cuda"):
        if not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"Inception weights not found at {weights_path}. Place a "
                "torchvision inception_v3 state_dict (.pt / .pth / an .npz of "
                "the same tensors) or the frozen TF FID graph "
                "(classify_image_graph_def.pb) there to score with Inception "
                "FID/KID/IS (get_feature_extractor falls back to "
                "RandomConvFeatures otherwise).")
        from smmdax_torch.eval.inception import InceptionV3, load_params
        device = resolve_device(device)
        self._net = InceptionV3(load_params(weights_path), batch=batch,
                                fid_semantics=fid_semantics, device=device)
        self.batch = batch

    def __call__(self, images, fetch: bool = True):
        return self._net.pool3(images, fetch=fetch)

    def probs(self, images, fetch: bool = True):
        """Softmax class probabilities (for the Inception Score)."""
        return self._net.probs(images, fetch=fetch)

    def features_and_probs(self, images, fetch: bool = True):
        """(pool3, probs) from one network sweep (the scoring path)."""
        return self._net.pool3_and_probs(images, fetch=fetch)


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
    with tracing.span("eval.inception"):
        if _takes_fetch(extractor.__call__):
            return extractor(images, fetch=fetch)
        return extractor(images)


def extract_with_probs(extractor: FeatureExtractor, images, fetch: bool = True):
    """(features, probs-or-None) from ONE network sweep when the extractor
    supports it; ``fetch=False`` asks for outputs left on the device."""
    with tracing.span("eval.inception"):
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
                          fid_semantics: Optional[bool] = None,
                          device="cuda") -> FeatureExtractor:
    """Inception on ``device`` if its weights asset exists under
    ``data_dir`` (and is preferred), else the offline random-conv
    extractor.  An asset that fails to load is reported and falls back to
    random conv features, as in the JAX package.  ``fid_semantics`` goes to
    ``InceptionFeatures`` (None = detect from the fc width)."""
    device = resolve_device(device)
    path = find_inception_weights(data_dir)
    if prefer_inception and path is not None:
        try:
            return InceptionFeatures(path, fid_semantics=fid_semantics, device=device)
        except Exception as e:          # corrupt / mismatched file, ...
            print(f"[smmdax_torch.eval] Inception load failed ({e}); "
                  "falling back to RandomConvFeatures")
    return RandomConvFeatures(device=device)
