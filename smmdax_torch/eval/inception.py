"""Inception-v3 (pool3 features + logits) for FID/KID/IS (port of
``smmdax/eval/inception.py``).

The network is written out here in PyTorch, in the exact torchvision
``inception_v3`` layout (module names, branch concat order, padding and
stride, BN eps 1e-3, average pools that count padded zeros), so a
torchvision state dict maps onto it one to one; only the *weights* are an
asset: a torchvision ``inception_v3`` state dict (``.pt`` / ``.pth``, or an
``.npz`` of the same tensors) or the frozen TF FID graph (``.pb``, read by
``smmdax_torch.eval.tf_graph`` without TensorFlow).  BatchNorm is folded
into each convolution at load time, with the same float32 numpy operations
as the JAX package, and the folded kernels are laid out OIHW for
``F.conv2d``; ``fc`` stays ``(2048, classes)``.

The JAX extractor is a float32 program.  PyTorch runs cuDNN convolutions
in TF32 by default, which moves the features on the card by ~1e-3
relative, so ``InceptionV3`` runs its sweep with TF32 off (cuDNN and
cuBLAS) in a scope it sets and restores, unless built with
``allow_tf32=True`` (for timing that arm only).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from smmdax_torch.train import resolve_device

Array = np.ndarray
Params = Dict[str, Dict[str, torch.Tensor]]

BN_EPS = 1e-3

# --------------------------------------------------------------------------
# Conv spec table: name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw)),
# every BasicConv2d of torchvision's inception_v3 by its module path.
# --------------------------------------------------------------------------


def _inception_a(prefix: str, c_in: int, c_pool: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (c_in, 64, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch5x5_1": (c_in, 48, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch5x5_2": (48, 64, (5, 5), (1, 1), (2, 2)),
        f"{prefix}.branch3x3dbl_1": (c_in, 64, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch_pool": (c_in, c_pool, (1, 1), (1, 1), (0, 0)),
    }


def _inception_c(prefix: str, c7: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (768, 192, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7_1": (768, c7, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7_2": (c7, c7, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch7x7_3": (c7, 192, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_1": (768, c7, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7dbl_2": (c7, c7, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_3": (c7, c7, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch7x7dbl_4": (c7, c7, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_5": (c7, 192, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch_pool": (768, 192, (1, 1), (1, 1), (0, 0)),
    }


def _inception_e(prefix: str, c_in: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.branch1x1": (c_in, 320, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3_1": (c_in, 384, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3_2a": (384, 384, (1, 3), (1, 1), (0, 1)),
        f"{prefix}.branch3x3_2b": (384, 384, (3, 1), (1, 1), (1, 0)),
        f"{prefix}.branch3x3dbl_1": (c_in, 448, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3dbl_2": (448, 384, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch3x3dbl_3a": (384, 384, (1, 3), (1, 1), (0, 1)),
        f"{prefix}.branch3x3dbl_3b": (384, 384, (3, 1), (1, 1), (1, 0)),
        f"{prefix}.branch_pool": (c_in, 192, (1, 1), (1, 1), (0, 0)),
    }


def conv_specs() -> Dict[str, tuple]:
    """Every BasicConv2d in torchvision inception_v3 (main tower)."""
    s: Dict[str, tuple] = {
        "Conv2d_1a_3x3": (3, 32, (3, 3), (2, 2), (0, 0)),
        "Conv2d_2a_3x3": (32, 32, (3, 3), (1, 1), (0, 0)),
        "Conv2d_2b_3x3": (32, 64, (3, 3), (1, 1), (1, 1)),
        "Conv2d_3b_1x1": (64, 80, (1, 1), (1, 1), (0, 0)),
        "Conv2d_4a_3x3": (80, 192, (3, 3), (1, 1), (0, 0)),
    }
    s.update(_inception_a("Mixed_5b", 192, 32))
    s.update(_inception_a("Mixed_5c", 256, 64))
    s.update(_inception_a("Mixed_5d", 288, 64))
    s.update({
        "Mixed_6a.branch3x3": (288, 384, (3, 3), (2, 2), (0, 0)),
        "Mixed_6a.branch3x3dbl_1": (288, 64, (1, 1), (1, 1), (0, 0)),
        "Mixed_6a.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
        "Mixed_6a.branch3x3dbl_3": (96, 96, (3, 3), (2, 2), (0, 0)),
    })
    s.update(_inception_c("Mixed_6b", 128))
    s.update(_inception_c("Mixed_6c", 160))
    s.update(_inception_c("Mixed_6d", 160))
    s.update(_inception_c("Mixed_6e", 192))
    s.update({
        "Mixed_7a.branch3x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
        "Mixed_7a.branch3x3_2": (192, 320, (3, 3), (2, 2), (0, 0)),
        "Mixed_7a.branch7x7x3_1": (768, 192, (1, 1), (1, 1), (0, 0)),
        "Mixed_7a.branch7x7x3_2": (192, 192, (1, 7), (1, 1), (0, 3)),
        "Mixed_7a.branch7x7x3_3": (192, 192, (7, 1), (1, 1), (3, 0)),
        "Mixed_7a.branch7x7x3_4": (192, 192, (3, 3), (2, 2), (0, 0)),
    })
    s.update(_inception_e("Mixed_7b", 1280))
    s.update(_inception_e("Mixed_7c", 2048))
    return s


_SPECS = conv_specs()


# --------------------------------------------------------------------------
# Weight conversion: torchvision state dict -> folded-BN params (numpy).
# --------------------------------------------------------------------------


def convert_torchvision_state_dict(state: Mapping[str, object]) -> Dict[str, Dict[str, Array]]:
    """Fold each BasicConv2d's BatchNorm into its conv, OIHW.

    ``state`` maps torchvision key -> array (tensors, numpy arrays and npz
    entries all work); ``AuxLogits.*`` keys are ignored (train-time head).
    Returns ``{name: {"w": OIHW f32, "b": (out,) f32}, "fc": {"w": (2048,
    classes), "b": (classes,)}}`` as numpy, ``classes`` 1000 (torchvision)
    or 1008 (the FID graph's port)."""
    def arr(key: str) -> Array:
        v = state[key]
        np_v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return np_v.astype(np.float32)

    params: Dict[str, Dict[str, Array]] = {}
    for name, (c_in, c_out, k, _, _) in _SPECS.items():
        w = arr(f"{name}.conv.weight")              # OIHW
        if w.shape != (c_out, c_in, *k):
            raise ValueError(f"{name}: expected {(c_out, c_in, *k)}, got {w.shape}")
        gamma = arr(f"{name}.bn.weight")
        beta = arr(f"{name}.bn.bias")
        mean = arr(f"{name}.bn.running_mean")
        var = arr(f"{name}.bn.running_var")
        scale = gamma / np.sqrt(var + BN_EPS)
        params[name] = {"w": w * scale[:, None, None, None], "b": beta - mean * scale}
    fc_w = arr("fc.weight")                         # (classes, 2048)
    if fc_w.ndim != 2 or fc_w.shape[1] != 2048:
        raise ValueError(f"fc.weight: bad shape {fc_w.shape}")
    params["fc"] = {"w": np.ascontiguousarray(fc_w.T), "b": arr("fc.bias")}
    return params


def load_params(weights_path: str) -> Dict[str, Dict[str, Array]]:
    """Load Inception weights as folded-BN params: a torchvision
    inception_v3 state dict (``.pt`` / ``.pth`` through ``torch.load(...,
    weights_only=True)``, or ``.npz`` with the same keys) or a frozen TF
    GraphDef (``.pb``, the 2015 FID graph, matched structurally by
    ``smmdax_torch.eval.tf_graph``)."""
    if weights_path.endswith(".pb"):
        from smmdax_torch.eval.tf_graph import convert_frozen_graph
        params, meta = convert_frozen_graph(weights_path, return_meta=True)
        # fid_semantics is auto-detected downstream from the fc width
        # (1008 = FID graph); a graph whose last-block pool contradicts
        # that rule fails here instead of being mis-pooled
        fid_auto = int(params["fc"]["w"].shape[1]) == 1008
        pool_7c = meta.get("Mixed_7c_pool", "avg")
        if fid_auto != (pool_7c == "max"):
            raise ValueError(
                f"{weights_path}: graph has a {pool_7c} pool in its last "
                f"block but a {params['fc']['w'].shape[1]}-way fc — the "
                "fc-width fid_semantics auto-detection would apply the "
                "wrong pooling; construct InceptionV3/InceptionFeatures "
                f"with fid_semantics={pool_7c == 'max'} explicitly")
        if not fid_auto:
            # any frozen TF graph excludes padded cells from SAME avg pools;
            # fid_semantics=False counts them, as torchvision does
            print(f"[smmdax_torch.eval] {weights_path}: non-FID frozen graph; "
                  "TF avg-pool padding semantics differ at the borders "
                  "from the torchvision mode this will run in")
        return params
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as z:
            state = {k: z[k] for k in z.files}
    else:
        state = torch.load(weights_path, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
    return convert_torchvision_state_dict(state)


# --------------------------------------------------------------------------
# Forward pass (NCHW, functional).
# --------------------------------------------------------------------------


def _conv(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    _, _, _, stride, pad = _SPECS[name]
    return F.relu(F.conv2d(x, p[name]["w"], p[name]["b"], stride=stride, padding=pad))


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2)


def _avgpool3s1p1(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    # torchvision divides by 9, padded zeros included; the frozen TF FID
    # graph excludes padding (fid_semantics)
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1,
                        count_include_pad=count_include_pad)


def _maxpool3s1p1(x: torch.Tensor) -> torch.Tensor:
    # the TF FID graph's Mixed_7c branch pool
    return F.max_pool2d(x, kernel_size=3, stride=1, padding=1)


def _block_a(p: Params, prefix: str, x: torch.Tensor, fid: bool) -> torch.Tensor:
    b1 = _conv(p, f"{prefix}.branch1x1", x)
    b5 = _conv(p, f"{prefix}.branch5x5_2", _conv(p, f"{prefix}.branch5x5_1", x))
    b3 = _conv(p, f"{prefix}.branch3x3dbl_3",
               _conv(p, f"{prefix}.branch3x3dbl_2",
                     _conv(p, f"{prefix}.branch3x3dbl_1", x)))
    bp = _conv(p, f"{prefix}.branch_pool", _avgpool3s1p1(x, count_include_pad=not fid))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(p: Params, x: torch.Tensor) -> torch.Tensor:          # Mixed_6a
    b3 = _conv(p, "Mixed_6a.branch3x3", x)
    bd = _conv(p, "Mixed_6a.branch3x3dbl_3",
               _conv(p, "Mixed_6a.branch3x3dbl_2",
                     _conv(p, "Mixed_6a.branch3x3dbl_1", x)))
    return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)


def _block_c(p: Params, prefix: str, x: torch.Tensor, fid: bool) -> torch.Tensor:
    b1 = _conv(p, f"{prefix}.branch1x1", x)
    b7 = x
    for i in (1, 2, 3):
        b7 = _conv(p, f"{prefix}.branch7x7_{i}", b7)
    bd = x
    for i in (1, 2, 3, 4, 5):
        bd = _conv(p, f"{prefix}.branch7x7dbl_{i}", bd)
    bp = _conv(p, f"{prefix}.branch_pool", _avgpool3s1p1(x, count_include_pad=not fid))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(p: Params, x: torch.Tensor) -> torch.Tensor:          # Mixed_7a
    b3 = _conv(p, "Mixed_7a.branch3x3_2", _conv(p, "Mixed_7a.branch3x3_1", x))
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = _conv(p, f"Mixed_7a.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)


def _block_e(p: Params, prefix: str, x: torch.Tensor, fid: bool,
             pool_max: bool = False) -> torch.Tensor:
    b1 = _conv(p, f"{prefix}.branch1x1", x)
    b3 = _conv(p, f"{prefix}.branch3x3_1", x)
    b3 = torch.cat([_conv(p, f"{prefix}.branch3x3_2a", b3),
                    _conv(p, f"{prefix}.branch3x3_2b", b3)], dim=1)
    bd = _conv(p, f"{prefix}.branch3x3dbl_2", _conv(p, f"{prefix}.branch3x3dbl_1", x))
    bd = torch.cat([_conv(p, f"{prefix}.branch3x3dbl_3a", bd),
                    _conv(p, f"{prefix}.branch3x3dbl_3b", bd)], dim=1)
    pooled = _maxpool3s1p1(x) if pool_max else _avgpool3s1p1(x, count_include_pad=not fid)
    bp = _conv(p, f"{prefix}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


def transform_input(x: torch.Tensor) -> torch.Tensor:
    """torchvision's ``transform_input=True`` remap (NCHW): ImageNet
    mean/std-normalized channels -> the [-1, 1] range the original TF
    weights expect."""
    ch = [x[:, 0] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
          x[:, 1] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
          x[:, 2] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5]
    return torch.stack(ch, dim=1)


def forward(params: Params, x: torch.Tensor, *, apply_transform_input: bool = True,
            fid_semantics: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3, 299, 299) ImageNet-normalized NCHW -> (pool3, logits).

    pool3 is the 2048-d pre-fc global-average feature (FID/KID input);
    logits the class scores (softmax -> Inception Score).  ``params``: the
    folded tensors, ``{name: {"w": OIHW, "b"}, "fc": {"w": (2048, k),
    "b"}}``.  ``fid_semantics``: the frozen TF FID graph's pooling (branch
    average pools exclude padding, Mixed_7c's branch pool is a max pool)."""
    if apply_transform_input:
        x = transform_input(x)
    fid = fid_semantics
    for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
        x = _conv(params, name, x)
    x = _maxpool3s2(x)
    x = _conv(params, "Conv2d_4a_3x3", _conv(params, "Conv2d_3b_1x1", x))
    x = _maxpool3s2(x)
    for prefix in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _block_a(params, prefix, x, fid)
    x = _block_b(params, x)
    for prefix in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _block_c(params, prefix, x, fid)
    x = _block_d(params, x)
    x = _block_e(params, "Mixed_7b", x, fid)
    x = _block_e(params, "Mixed_7c", x, fid, pool_max=fid)
    pool3 = x.mean(dim=(2, 3))                      # adaptive avg pool (1, 1)
    logits = pool3 @ params["fc"]["w"] + params["fc"]["b"]
    return pool3, logits


# ImageNet eval normalization (applied to [0, 1] images before forward).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[-1, 1] NHWC images of any resolution -> ImageNet-normalized NCHW
    ``size`` x ``size`` (bilinear, half-pixel centers, no antialiasing: the
    resize of the JAX package's ``jax.image.resize``)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(images.device, images.dtype)
    std = torch.from_numpy(IMAGENET_STD).to(images.device, images.dtype)
    x = ((images + 1.0) * 0.5 - mean) / std
    x = x.permute(0, 3, 1, 2)
    if x.shape[2] != size or x.shape[3] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=False)
    return x.contiguous()


@contextlib.contextmanager
def _tf32(allow: bool):
    """cuDNN's and cuBLAS's TF32 set to ``allow`` for the block, restored
    after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class InceptionV3(nn.Module):
    """Batched extractor on ``device``: images in [-1, 1] -> pool3 / probs.

    The folded weights are buffers (``<conv>_w`` / ``<conv>_b`` with the
    dots of torchvision's names as ``_``) in ``dtype``.  Images (NHWC,
    numpy or a tensor) run ``batch`` at a time; ``fetch=False`` leaves both
    heads on the device as float32 tensors.  ``fid_semantics=None``: on for
    a 1008-way fc (the FID graph), off for 1000-way torchvision weights."""

    def __init__(self, params: Mapping[str, Mapping[str, Array]], batch: int = 64,
                 fid_semantics: Optional[bool] = None, device="cuda",
                 dtype: torch.dtype = torch.float32, allow_tf32: bool = False):
        super().__init__()
        self.batch = batch
        if fid_semantics is None:
            fid_semantics = int(np.shape(params["fc"]["w"])[1]) == 1008
        self.fid_semantics = bool(fid_semantics)
        self.allow_tf32 = allow_tf32
        self.device = resolve_device(device)
        self._names = list(_SPECS) + ["fc"]
        for name in self._names:
            for leaf in ("w", "b"):
                t = torch.from_numpy(np.array(params[name][leaf], np.float32))
                self.register_buffer(f"{name.replace('.', '_')}_{leaf}", t.contiguous())
        self.to(self.device, dtype)

    def params(self) -> Params:
        """The buffers as ``forward``'s nested dict."""
        return {name: {leaf: getattr(self, f"{name.replace('.', '_')}_{leaf}")
                       for leaf in ("w", "b")} for name in self._names}

    @property
    def dtype(self) -> torch.dtype:
        return self.fc_w.dtype

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pool3, logits) of NHWC images in [-1, 1] on the module's device."""
        return forward(self.params(), preprocess(images.to(self.dtype)),
                       fid_semantics=self.fid_semantics)

    def pool3_and_logits(self, images, fetch: bool = True):
        """(pool3, logits) of every image, ``batch`` at a time: float32
        numpy with ``fetch``, else float32 tensors on the device."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images, np.float32)
        pools, logits = [], []
        with torch.no_grad(), _tf32(self.allow_tf32):
            for i in range(0, len(images), self.batch):
                p, l = self(torch.as_tensor(images[i:i + self.batch]).to(self.device))
                pools.append(p.float())
                logits.append(l.float())
        if not pools:               # no images (a rank's empty share of a set)
            pools = [torch.empty((0, 2048), device=self.device)]
            logits = [torch.empty((0, self.fc_w.shape[1]), device=self.device)]
        pool, logit = torch.cat(pools), torch.cat(logits)
        if not fetch:
            return pool, logit
        return pool.cpu().numpy(), logit.cpu().numpy()

    @staticmethod
    def _softmax(logits):
        # host logits: float64 numpy; device logits stay there in float32
        # (a shifted exp / sum has no cancellation hazard)
        if isinstance(logits, torch.Tensor):
            return torch.softmax(logits.float(), dim=1)
        z = logits.astype(np.float64)
        z -= z.max(axis=1, keepdims=True)
        e = np.exp(z)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    def pool3(self, images, fetch: bool = True):
        return self.pool3_and_logits(images, fetch=fetch)[0]

    def probs(self, images, fetch: bool = True):
        return self._softmax(self.pool3_and_logits(images, fetch=fetch)[1])

    def pool3_and_probs(self, images, fetch: bool = True):
        """Both heads from ONE sweep (FID/KID want pool3, IS the probs of
        the same samples)."""
        pool, logits = self.pool3_and_logits(images, fetch=fetch)
        return pool, self._softmax(logits)


def random_state_dict(seed: int = 0, include_aux: bool = True,
                      num_classes: int = 1000) -> Dict[str, Array]:
    """Synthetic torchvision-schema state dict (random weights) for offline
    tests and runs without the asset: exactly the keys and shapes of
    torchvision's ``inception_v3(aux_logits=True)``, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order, so the two
    packages build equal dicts."""
    rng = np.random.default_rng(seed)

    def conv_bn(name: str, c_in: int, c_out: int, k: Tuple[int, int]) -> dict:
        # fan-in-scaled weights keep activations O(1) through all 94 convs
        std = np.sqrt(2.0 / (c_in * k[0] * k[1]))
        return {
            f"{name}.conv.weight": rng.normal(0, std, (c_out, c_in, *k)).astype(np.float32),
            f"{name}.bn.weight": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
            f"{name}.bn.bias": rng.normal(0, 0.1, c_out).astype(np.float32),
            f"{name}.bn.running_mean": rng.normal(0, 0.1, c_out).astype(np.float32),
            f"{name}.bn.running_var": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
            f"{name}.bn.num_batches_tracked": np.asarray(0, np.int64),
        }

    state: Dict[str, Array] = {}
    for name, (c_in, c_out, k, _, _) in _SPECS.items():
        state.update(conv_bn(name, c_in, c_out, k))
    if include_aux:
        state.update(conv_bn("AuxLogits.conv0", 768, 128, (1, 1)))
        state.update(conv_bn("AuxLogits.conv1", 128, 768, (5, 5)))
        state["AuxLogits.fc.weight"] = rng.normal(0, 0.01, (num_classes, 768)).astype(np.float32)
        state["AuxLogits.fc.bias"] = np.zeros(num_classes, np.float32)
    state["fc.weight"] = rng.normal(0, 0.02, (num_classes, 2048)).astype(np.float32)
    state["fc.bias"] = np.zeros(num_classes, np.float32)
    return state
