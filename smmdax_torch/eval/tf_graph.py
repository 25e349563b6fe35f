"""Frozen TF GraphDef (.pb) -> the port's Inception params (port of
``smmdax/eval/tf_graph.py``, which the port keeps its own copy of).

The scoring asset of the reference lineage is a frozen TF Inception graph
(the 2015 ``classify_image_graph_def.pb`` every published FID/KID number
was computed with).  This module reads it with NO TensorFlow dependency:

* a reader of the GraphDef subset a frozen inference graph uses (NodeDef,
  AttrValue, TensorProto) on the port's protobuf wire-format reader
  (``smmdax_torch/protowire.py``, from the public protobuf encoding spec);
* a **structural matcher** that identifies the Inception-v3 architecture
  by graph topology and tensor shapes, never by node names, and emits
  the folded-BN torchvision-schema params that
  :func:`smmdax_torch.eval.inception.convert_torchvision_state_dict`
  produces: numpy, conv kernels OIHW, ``fc`` ``(2048, classes)``.

Node names drift across exporter versions; what the matcher keys on (conv
kernel shapes, strides and padding, the chains between concats, the
concat topology) is fixed by the architecture.  The branch order inside
every concat is recovered from the graph, and where it differs from the
torchvision order the channel permutation is folded into the downstream
consumers' weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from smmdax_torch.protowire import fields as _fields
from smmdax_torch.protowire import packed_varints as _packed_varints
from smmdax_torch.protowire import signed as _signed

__all__ = ["parse_graph_def", "convert_frozen_graph", "GraphDefNode"]


# --------------------------------------------------------------------------
# The GraphDef subset frozen graphs use, read with ``smmdax_torch.protowire``.
#
# Field numbers are from the public tensorflow .proto definitions
# (graph.proto / node_def.proto / attr_value.proto / tensor.proto /
# tensor_shape.proto), which are stable public API.
# --------------------------------------------------------------------------


# tensorflow DataType enum values we understand.
_DT_NUMPY = {1: np.float32, 2: np.float64, 3: np.int32, 9: np.int64,
             10: np.bool_}


def _parse_tensor(buf: bytes) -> Optional[np.ndarray]:
    """TensorProto -> np.ndarray, or None for payloads we don't model
    (DT_STRING JPEG blobs etc. in the graph preamble — the real 2015
    graph carries a DecodeJpeg/contents string Const; an unreadable
    Const is only an error if the matcher actually needs its value)."""
    dtype_enum, shape, content = 1, [], b""
    float_vals: List[float] = []
    double_vals: List[float] = []
    int_vals: List[int] = []
    for field, wt, val in _fields(buf):
        if field == 1:                       # dtype
            dtype_enum = val
        elif field == 2:                     # tensor_shape
            for f2, _, v2 in _fields(val):
                if f2 == 2:                  # repeated Dim
                    size = 0
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            size = _signed(v3)
                    shape.append(size)
        elif field == 4:                     # tensor_content
            content = val
        elif field == 5:                     # float_val (packed or not)
            if wt == 5:
                float_vals.append(float(np.frombuffer(val, "<f4")[0]))
            else:
                float_vals.extend(np.frombuffer(val, "<f4"))
        elif field == 6:                     # double_val
            if wt == 1:
                double_vals.append(float(np.frombuffer(val, "<f8")[0]))
            else:
                double_vals.extend(np.frombuffer(val, "<f8"))
        elif field == 7:                     # int_val
            int_vals.extend(_signed(v) for v in _packed_varints(val, wt))
    if dtype_enum not in _DT_NUMPY:
        return None
    np_dtype = _DT_NUMPY[dtype_enum]
    n_elem = int(np.prod(shape)) if shape else 1
    if content:
        arr = np.frombuffer(content, np_dtype)
    else:
        vals = (float_vals if dtype_enum == 1 else
                double_vals if dtype_enum == 2 else int_vals)
        arr = np.asarray(vals, np_dtype)
        if arr.size == 1 and n_elem > 1:     # proto small-tensor broadcast
            arr = np.full(n_elem, arr.flat[0], np_dtype)
    if arr.size != n_elem:
        return None                          # mis-modeled payload: lazy error
    return arr.reshape(shape)


class _Attr:
    """Parsed AttrValue: only the members frozen conv graphs use."""

    __slots__ = ("s", "i", "f", "b", "type", "tensor", "list_i", "list_s")

    def __init__(self, buf: bytes):
        self.s = self.i = self.f = self.b = self.type = self.tensor = None
        self.list_i: List[int] = []
        self.list_s: List[bytes] = []
        for field, wt, val in _fields(buf):
            if field == 2:
                self.s = val
            elif field == 3:
                self.i = _signed(val)
            elif field == 4:
                self.f = float(np.frombuffer(val, "<f4")[0])
            elif field == 5:
                self.b = bool(val)
            elif field == 6:
                self.type = val
            elif field == 8:
                self.tensor = _parse_tensor(val)
            elif field == 1:                 # ListValue
                for f2, wt2, v2 in _fields(val):
                    if f2 == 3:
                        self.list_i.extend(
                            _signed(v) for v in _packed_varints(v2, wt2))
                    elif f2 == 2:
                        self.list_s.append(v2)


class GraphDefNode:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, buf: bytes):
        self.name, self.op = "", ""
        self.inputs: List[str] = []
        self.attrs: Dict[str, _Attr] = {}
        for field, _, val in _fields(buf):
            if field == 1:
                self.name = val.decode()
            elif field == 2:
                self.op = val.decode()
            elif field == 3:
                self.inputs.append(val.decode())
            elif field == 5:                 # map<string, AttrValue>
                key, attr = "", None
                for f2, _, v2 in _fields(val):
                    if f2 == 1:
                        key = v2.decode()
                    elif f2 == 2:
                        attr = _Attr(v2)
                if key and attr is not None:
                    self.attrs[key] = attr

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<{self.op} {self.name!r}>"


def parse_graph_def(data: bytes) -> List[GraphDefNode]:
    """Serialized GraphDef bytes -> list of nodes."""
    nodes = []
    for field, _, val in _fields(data):
        if field == 1:                       # repeated NodeDef
            nodes.append(GraphDefNode(val))
    if not nodes:
        raise ValueError("no nodes parsed — not a GraphDef?")
    return nodes


# --------------------------------------------------------------------------
# Structural matcher: GraphDef topology -> torchvision-schema params.
#
# Channel-permutation convention used throughout: a layout map P for a
# tensor with C channels satisfies canonical[..., j] == graph[..., P[j]].
# A conv consuming a tensor with layout P needs its HWIO weight's input
# axis gathered: W_canonical = W_graph[:, :, P, :] (then its OUTPUT is
# in canonical == graph order, i.e. identity layout).
# --------------------------------------------------------------------------

_BN_OPS = ("BatchNormWithGlobalNormalization", "FusedBatchNorm",
           "FusedBatchNormV2", "FusedBatchNormV3")
_SKIP_OPS = ("Identity", "CheckNumerics", "StopGradient")
_CONCAT_OPS = ("Concat", "ConcatV2")
_UNIT_OPS = ("Relu", "BiasAdd", "Conv2D", "AvgPool", "MaxPool") + _BN_OPS


def _base(ref: str) -> str:
    return ref.lstrip("^").split(":")[0]


class _Graph:
    def __init__(self, nodes: List[GraphDefNode]):
        self.by_name = {n.name: n for n in nodes}
        self.consumers: Dict[str, List[GraphDefNode]] = {}
        for n in nodes:
            for ref in n.inputs:
                if ref.startswith("^"):
                    continue
                self.consumers.setdefault(_base(ref), []).append(n)

    def node(self, ref: str) -> GraphDefNode:
        return self.by_name[_base(ref)]

    def skip(self, ref: str) -> GraphDefNode:
        node = self.node(ref)
        while node.op in _SKIP_OPS:
            node = self.node(node.inputs[0])
        return node

    def const(self, ref: str) -> np.ndarray:
        node = self.skip(ref)
        if node.op != "Const":
            raise ValueError(f"expected Const, got {node.op} {node.name!r}")
        tensor = node.attrs["value"].tensor
        if tensor is None:
            raise ValueError(
                f"Const {node.name!r} has a payload this reader does not "
                "model (unsupported dtype or encoding)")
        return tensor

    def concat_values(self, node: GraphDefNode) -> List[str]:
        # Concat: (concat_dim, values...); ConcatV2: (values..., axis)
        return node.inputs[1:] if node.op == "Concat" else node.inputs[:-1]


class _ConvUnit:
    """One BasicConv2d: Conv2D (+BN or bias) (+Relu), BN folded."""

    kind = "conv"

    def __init__(self, g: _Graph, conv: GraphDefNode,
                 bn: Optional[GraphDefNode], bias_ref: Optional[str]):
        w = g.const(conv.inputs[1]).astype(np.float32)      # HWIO
        if w.ndim != 4:
            raise ValueError(f"conv weight ndim {w.ndim} at {conv.name!r}")
        fmt = conv.attrs.get("data_format")
        if fmt is not None and fmt.s not in (None, b"", b"NHWC"):
            raise ValueError(f"unsupported data_format {fmt.s!r}")
        strides = conv.attrs["strides"].list_i
        self.stride = (int(strides[1]), int(strides[2]))
        self.padding = (conv.attrs["padding"].s or b"").decode()
        if bn is not None:
            if bn.op == "BatchNormWithGlobalNormalization":
                # inputs: (t, mean, variance, beta, gamma)
                mean = g.const(bn.inputs[1]).astype(np.float32)
                var = g.const(bn.inputs[2]).astype(np.float32)
                beta = g.const(bn.inputs[3]).astype(np.float32)
                scale_attr = bn.attrs.get("scale_after_normalization")
                if scale_attr is not None and scale_attr.b:
                    gamma = g.const(bn.inputs[4]).astype(np.float32)
                else:
                    gamma = np.ones_like(beta)
                eps = bn.attrs["variance_epsilon"].f
            else:                             # FusedBatchNorm{,V2,V3}
                # inputs: (x, scale, offset, mean, variance)
                gamma = g.const(bn.inputs[1]).astype(np.float32)
                beta = g.const(bn.inputs[2]).astype(np.float32)
                mean = g.const(bn.inputs[3]).astype(np.float32)
                var = g.const(bn.inputs[4]).astype(np.float32)
                eps = bn.attrs["epsilon"].f
            scale = gamma / np.sqrt(var + np.float32(eps))
            w = w * scale                     # HWIO: output channels last
            b = beta - mean * scale
        elif bias_ref is not None:
            b = g.const(bias_ref).astype(np.float32)
        else:
            b = np.zeros(w.shape[-1], np.float32)
        self.w, self.b = w, b
        self.kernel = (int(w.shape[0]), int(w.shape[1]))
        self.c_in, self.c_out = int(w.shape[2]), int(w.shape[3])


class _PoolUnit:
    kind = "pool"

    def __init__(self, node: GraphDefNode):
        self.pool = "max" if node.op == "MaxPool" else "avg"
        ks = node.attrs["ksize"].list_i
        st = node.attrs["strides"].list_i
        self.kernel = (int(ks[1]), int(ks[2]))
        self.stride = (int(st[1]), int(st[2]))
        self.padding = (node.attrs["padding"].s or b"").decode()


def _step_back(g: _Graph, ref: str):
    """One chain unit ending at ``ref`` -> (unit, ref_below) or None.

    Units are Relu[BN[Conv2D]] / Relu[BiasAdd[Conv2D]] / BN[Conv2D] /
    bare Conv2D / pools.  Returns None when ``ref`` is not produced by
    a chain unit (block boundary / graph preamble)."""
    node = g.skip(ref)
    if node.op in ("AvgPool", "MaxPool"):
        return _PoolUnit(node), node.inputs[0]
    inner = node
    if node.op == "Relu":
        inner = g.skip(node.inputs[0])
    bn, bias_ref = None, None
    if inner.op in _BN_OPS:
        bn = inner
        conv = g.skip(inner.inputs[0])
    elif inner.op == "BiasAdd":
        bias_ref = inner.inputs[1]
        conv = g.skip(inner.inputs[0])
    else:
        conv = inner
    if conv.op != "Conv2D":
        return None
    return _ConvUnit(g, conv, bn, bias_ref), conv.inputs[0]


def _trail(g: _Graph, ref: str, max_len: int = 400) -> List[str]:
    """Node names along the main (data) path walking backward from
    ``ref``, passing THROUGH concats (via their first value input) so
    trails from different branches can be intersected to find the
    common block input."""
    names: List[str] = []
    while len(names) < max_len:
        node = g.skip(ref)
        if node.name in names:               # safety: no cycles expected
            break
        names.append(node.name)
        if node.op in _CONCAT_OPS:
            ref = g.concat_values(node)[0]
        elif node.op in _UNIT_OPS:
            ref = node.inputs[0]
        else:
            break
    return names


def _block_input(g: _Graph, concat: GraphDefNode) -> str:
    """The node all of a concat's branches converge on (the block
    input): the first name on branch 0's backward trail that appears
    on every other branch's trail."""
    trails = [_trail(g, r) for r in g.concat_values(concat)]
    rest = [set(t) for t in trails[1:]]
    for name in trails[0]:
        if all(name in s for s in rest):
            return name
    raise ValueError(f"branches of {concat.name!r} never converge")


def _walk_chain(g: _Graph, ref: str, stop: str) -> list:
    """Units from ``stop`` (exclusive) up to ``ref`` (inclusive), in
    forward order.  The chain must be pure (no concats)."""
    units = []
    while True:
        node = g.skip(ref)
        if node.name == stop:
            break
        step = _step_back(g, ref)
        if step is None:
            raise ValueError(
                f"unexpected op {node.op} {node.name!r} inside a branch "
                f"(walking toward {stop!r})")
        unit, ref = step
        units.append(unit)
    return list(reversed(units))


# -- branch signatures & canonical names -------------------------------------


def _sig(units) -> tuple:
    out = []
    for u in units:
        if u == "SPLIT":
            out.append("split")
        elif u.kind == "pool":
            out.append(("pool", u.pool))
        else:
            out.append(("conv", u.kernel, u.stride))
    return tuple(out)


def _names_a(prefix):
    return {
        (("conv", (1, 1), (1, 1)),): [f"{prefix}.branch1x1"],
        (("conv", (1, 1), (1, 1)), ("conv", (5, 5), (1, 1))):
            [f"{prefix}.branch5x5_1", f"{prefix}.branch5x5_2"],
        (("conv", (1, 1), (1, 1)), ("conv", (3, 3), (1, 1)),
         ("conv", (3, 3), (1, 1))):
            [f"{prefix}.branch3x3dbl_{i}" for i in (1, 2, 3)],
        (("pool", "avg"), ("conv", (1, 1), (1, 1))):
            [None, f"{prefix}.branch_pool"],
    }


def _names_b():
    return {
        (("conv", (3, 3), (2, 2)),): ["Mixed_6a.branch3x3"],
        (("conv", (1, 1), (1, 1)), ("conv", (3, 3), (1, 1)),
         ("conv", (3, 3), (2, 2))):
            [f"Mixed_6a.branch3x3dbl_{i}" for i in (1, 2, 3)],
        (("pool", "max"),): [None],
    }


def _names_c(prefix):
    return {
        (("conv", (1, 1), (1, 1)),): [f"{prefix}.branch1x1"],
        (("conv", (1, 1), (1, 1)), ("conv", (1, 7), (1, 1)),
         ("conv", (7, 1), (1, 1))):
            [f"{prefix}.branch7x7_{i}" for i in (1, 2, 3)],
        (("conv", (1, 1), (1, 1)), ("conv", (7, 1), (1, 1)),
         ("conv", (1, 7), (1, 1)), ("conv", (7, 1), (1, 1)),
         ("conv", (1, 7), (1, 1))):
            [f"{prefix}.branch7x7dbl_{i}" for i in (1, 2, 3, 4, 5)],
        (("pool", "avg"), ("conv", (1, 1), (1, 1))):
            [None, f"{prefix}.branch_pool"],
    }


def _names_d():
    return {
        (("conv", (1, 1), (1, 1)), ("conv", (3, 3), (2, 2))):
            ["Mixed_7a.branch3x3_1", "Mixed_7a.branch3x3_2"],
        (("conv", (1, 1), (1, 1)), ("conv", (1, 7), (1, 1)),
         ("conv", (7, 1), (1, 1)), ("conv", (3, 3), (2, 2))):
            [f"Mixed_7a.branch7x7x3_{i}" for i in (1, 2, 3, 4)],
        (("pool", "max"),): [None],
    }


def _names_e(prefix):
    # the branch pool may be avg (torchvision semantics) or — in the
    # LAST block only — max (the FID graph's Mixed_7c patch, the only
    # max branch pool forward() can express); both map to the same
    # canonical name, and parse_block records which kind the graph
    # used so load_params can check it against the runtime semantics.
    d = {
        (("conv", (1, 1), (1, 1)),): [f"{prefix}.branch1x1"],
        (("conv", (1, 1), (1, 1)), "split"):
            [f"{prefix}.branch3x3_1", "SPLIT"],
        (("conv", (1, 1), (1, 1)), ("conv", (3, 3), (1, 1)), "split"):
            [f"{prefix}.branch3x3dbl_1", f"{prefix}.branch3x3dbl_2", "SPLIT"],
    }
    pools = ("avg", "max") if prefix == "Mixed_7c" else ("avg",)
    for pool in pools:
        d[(("pool", pool), ("conv", (1, 1), (1, 1)))] = \
            [None, f"{prefix}.branch_pool"]
    return d


# Canonical slot order = torchvision concat order (inception.py
# _block_a/.../_block_e).
_SLOT_ORDERS = {
    "a": ["branch1x1", "branch5x5", "branch3x3dbl", "branch_pool"],
    "b": ["branch3x3", "branch3x3dbl", "passthrough"],
    "c": ["branch1x1", "branch7x7", "branch7x7dbl", "branch_pool"],
    "d": ["branch3x3", "branch7x7x3", "passthrough"],
    "e": ["branch1x1", "branch3x3", "branch3x3dbl", "branch_pool"],
}


def _slot_of(sig: tuple, block_type: str) -> str:
    if sig and sig[0][0] == "pool" and len(sig) == 1:
        return "passthrough"
    if sig and sig[0][0] == "pool":
        return "branch_pool"
    if block_type == "a":
        return {1: "branch1x1", 2: "branch5x5", 3: "branch3x3dbl"}[len(sig)]
    if block_type == "b":
        return {1: "branch3x3", 3: "branch3x3dbl"}[len(sig)]
    if block_type == "c":
        return {1: "branch1x1", 3: "branch7x7", 5: "branch7x7dbl"}[len(sig)]
    if block_type == "d":
        return {2: "branch3x3", 4: "branch7x7x3"}[len(sig)]
    if block_type == "e":
        return {1: "branch1x1", 2: "branch3x3", 3: "branch3x3dbl"}[len(sig)]
    raise ValueError(block_type)


def _check_pool(unit, where: str, kernel=(3, 3), stride=(1, 1),
                padding="SAME", kind=None) -> None:
    """Pools are parsed but not emitted, so forward() re-applies them
    with hardcoded geometry — reject any graph whose pool geometry
    differs (silent feature corruption otherwise)."""
    if unit.kind != "pool":
        raise ValueError(f"{where}: expected a pool, got {unit.kind}")
    if unit.kernel != kernel or unit.stride != stride \
            or unit.padding != padding:
        raise ValueError(
            f"{where}: pool geometry {unit.kernel}/{unit.stride}/"
            f"{unit.padding} != expected {kernel}/{stride}/{padding}")
    if kind is not None and unit.pool != kind:
        raise ValueError(f"{where}: {unit.pool} pool, expected {kind}")


class _Matcher:
    def __init__(self, g: _Graph):
        from smmdax_torch.eval.inception import conv_specs
        self.g = g
        self.specs = conv_specs()
        self.params: Dict[str, dict] = {}
        self.meta: Dict[str, str] = {}       # e.g. Mixed_7c_pool: max|avg

    def _emit(self, name: str, unit: _ConvUnit,
              perm: Optional[np.ndarray]) -> None:
        spec = self.specs.get(name)
        if spec is None:
            raise ValueError(f"no torchvision spec for {name!r}")
        c_in, c_out, kernel, stride, pad = spec
        if (unit.c_in, unit.c_out) != (c_in, c_out) or unit.kernel != kernel:
            raise ValueError(
                f"{name}: graph conv ({unit.c_in}->{unit.c_out} "
                f"{unit.kernel}) != spec ({c_in}->{c_out} {kernel})")
        if unit.stride != stride:
            raise ValueError(f"{name}: stride {unit.stride} != {stride}")
        want_pad = "VALID" if pad == (0, 0) else "SAME"
        # 1x1 convs pad nothing either way, and the 2015 graph's blocks
        # were built under an arg_scope padding='SAME' — accept any
        # declaration whose EFFECTIVE padding matches the spec
        if unit.padding != want_pad and kernel != (1, 1):
            raise ValueError(f"{name}: padding {unit.padding} != {want_pad}")
        if name in self.params:
            raise ValueError(f"duplicate assignment of {name}")
        w = unit.w if perm is None else unit.w[:, :, perm, :]
        self.params[name] = {"w": w, "b": unit.b}

    def _emit_chain(self, names: List[Optional[str]], units: list,
                    perm_in: Optional[np.ndarray]) -> Optional[int]:
        """Emit a branch chain (pools pass channels through; the first
        conv absorbs perm_in).  Returns the chain's output width, or
        None for a pure-pool chain."""
        perm = perm_in
        width = None
        for name, unit in zip(names, units):
            if unit.kind == "pool":
                continue
            self._emit(name, unit, perm)
            width = unit.c_out
            perm = None                      # conv outputs are canonical
        return width

    def parse_block(self, concat: GraphDefNode, block_type: str,
                    prefix: str, block_input: str,
                    perm_in: Optional[np.ndarray], width_in: int
                    ) -> Tuple[Optional[np.ndarray], int]:
        """Convert one inception block; returns (perm_out, width_out).
        perm values of None mean identity layout."""
        g = self.g
        names_by_sig = {"a": _names_a, "c": _names_c, "e": _names_e,
                        "b": lambda _: _names_b(),
                        "d": lambda _: _names_d()}[block_type](prefix)
        # slot -> (graph_offset, local_layout_or_None, width)
        slots: Dict[str, Tuple[int, Optional[np.ndarray], int]] = {}
        offset = 0
        for ref in g.concat_values(concat):
            units, nested = self._branch_units(ref, block_input)
            sig = _sig(units)
            if sig not in names_by_sig:
                raise ValueError(
                    f"{prefix}: unrecognized branch signature {sig}")
            names = names_by_sig[sig]
            slot = _slot_of(sig, block_type)
            if slot == "branch_pool":
                _check_pool(units[0], f"{prefix}.branch_pool")
                if block_type == "e":
                    self.meta[f"{prefix}_pool"] = units[0].pool
            if slot == "passthrough":        # B/D max-pool branch
                _check_pool(units[0], f"{prefix}.passthrough",
                            stride=(2, 2), padding="VALID", kind="max")
                local, width = perm_in, width_in
            elif nested is None:
                width = self._emit_chain(names, units, perm_in)
                local = None
            else:                            # E-block split tail
                self._emit_chain(names[:-1], units[:-1], perm_in)
                local, width = self._emit_split(names[0], nested)
            if slot in slots:
                raise ValueError(f"{prefix}: duplicate branch slot {slot}")
            slots[slot] = (offset, local, width)
            offset += width
        order = _SLOT_ORDERS[block_type]
        missing = [s for s in order if s not in slots]
        if missing:
            raise ValueError(f"{prefix}: missing branches {missing}")
        perm = np.concatenate([
            slots[s][0] + (np.arange(slots[s][2]) if slots[s][1] is None
                           else slots[s][1])
            for s in order])
        if np.array_equal(perm, np.arange(len(perm))):
            return None, len(perm)
        return perm, len(perm)

    def _branch_units(self, ref: str, block_input: str):
        """Forward-order units of one branch.  E-block branches whose
        tail is a nested (1,3)/(3,1) concat return that concat
        separately, with 'SPLIT' closing the unit list."""
        g = self.g
        node = g.skip(ref)
        if node.op in _CONCAT_OPS:
            sub_below = []
            for r in g.concat_values(node):
                step = _step_back(g, r)
                if step is None:
                    raise ValueError("nested concat input is not a unit")
                sub_below.append(step[1])
            shared = {_base(r) for r in sub_below}
            if len(shared) != 1:
                raise ValueError("nested concat branches do not share input")
            units = _walk_chain(g, sub_below[0], block_input)
            return units + ["SPLIT"], node
        return _walk_chain(g, ref, block_input), None

    def _emit_split(self, first_name: str, concat: GraphDefNode):
        """The E-block (1,3)/(3,1) pair: canonical order is a=(1,3)
        then b=(3,1) (torchvision _block_e)."""
        g = self.g
        base = first_name.rsplit("_", 1)[0]   # Mixed_7x.branch3x3[dbl]
        suffix = "3" if base.endswith("dbl") else "2"
        parts = []                            # (kernel, graph_offset, unit)
        offset = 0
        for ref in g.concat_values(concat):
            step = _step_back(g, ref)
            if step is None or step[0].kind != "conv":
                raise ValueError("nested concat input is not a conv")
            unit = step[0]
            parts.append((unit.kernel, offset, unit))
            offset += unit.c_out
        by_kernel = {k: (off, u) for k, off, u in parts}
        if set(by_kernel) != {(1, 3), (3, 1)} or len(parts) != 2:
            raise ValueError(
                f"unexpected split kernels {[p[0] for p in parts]}")
        local: List[int] = []
        for kernel, tag in (((1, 3), "a"), ((3, 1), "b")):
            off, unit = by_kernel[kernel]
            self._emit(f"{base}_{suffix}{tag}", unit, None)
            local.extend(range(off, off + unit.c_out))
        return np.asarray(local), offset


def _find_top_concats(g: _Graph):
    """The 11 block concats in forward (dataflow) order, plus each
    block's input node name."""
    tops = []
    for node in g.by_name.values():
        if node.op not in _CONCAT_OPS:
            continue
        cons = g.consumers.get(node.name, [])
        if any(c.op in _CONCAT_OPS for c in cons):
            continue                          # nested (E-block split)
        tops.append(node)
    if len(tops) != 11:
        raise ValueError(f"expected 11 inception blocks, found {len(tops)}")
    input_of = {c.name: _block_input(g, c) for c in tops}
    top_names = {c.name for c in tops}
    first = [c for c in tops if input_of[c.name] not in top_names]
    if len(first) != 1:
        raise ValueError("could not identify the first inception block")
    ordered = [first[0]]
    by_input = {input_of[c.name]: c for c in tops}
    while len(ordered) < 11:
        nxt = by_input.get(ordered[-1].name)
        if nxt is None:
            raise ValueError("broken inception block chain")
        ordered.append(nxt)
    return ordered, input_of


_BLOCK_LAYOUT = [("a", "Mixed_5b"), ("a", "Mixed_5c"), ("a", "Mixed_5d"),
                 ("b", "Mixed_6a"),
                 ("c", "Mixed_6b"), ("c", "Mixed_6c"), ("c", "Mixed_6d"),
                 ("c", "Mixed_6e"),
                 ("d", "Mixed_7a"),
                 ("e", "Mixed_7b"), ("e", "Mixed_7c")]

_STEM_NAMES = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
               "Conv2d_3b_1x1", "Conv2d_4a_3x3"]


def convert_frozen_graph(data, return_meta: bool = False):
    """Frozen Inception GraphDef (bytes or a .pb path) -> folded-BN
    torchvision-schema params as numpy (the dict
    :func:`inception.convert_torchvision_state_dict` produces: conv
    kernels OIHW, ``fc`` ``(2048, classes)``), ready for
    :class:`inception.InceptionV3` / ``InceptionFeatures``.

    ``return_meta=True`` additionally returns ground truth the params
    alone cannot carry: the E-block branch-pool kinds the graph
    actually used (``{"Mixed_7b_pool": "avg", "Mixed_7c_pool": "max"}``
    for the real FID graph) — load_params checks these against the
    runtime fid_semantics auto-detection."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    g = _Graph(parse_graph_def(data))
    tops, input_of = _find_top_concats(g)
    matcher = _Matcher(g)

    # stem: walk back from the first block's input until the preamble
    # (resize/normalize ops) stops the chain
    stem_units = []
    ref = input_of[tops[0].name]
    while True:
        step = _step_back(g, ref)
        if step is None:
            break
        unit, ref = step
        stem_units.append(unit)
    stem_units.reverse()
    kinds = [u.kind for u in stem_units]
    if kinds != ["conv", "conv", "conv", "pool", "conv", "conv", "pool"]:
        raise ValueError(f"unrecognized stem structure {kinds}")
    for unit in (stem_units[3], stem_units[6]):
        _check_pool(unit, "stem", stride=(2, 2), padding="VALID", kind="max")
    for name, unit in zip(_STEM_NAMES,
                          [u for u in stem_units if u.kind == "conv"]):
        matcher._emit(name, unit, None)

    # the 11 mixed blocks, threading the channel permutation through
    perm, width = None, 192
    for concat, (btype, prefix) in zip(tops, _BLOCK_LAYOUT):
        perm, width = matcher.parse_block(
            concat, btype, prefix, input_of[concat.name], perm, width)

    # head: last concat -> global avg pool (AvgPool 8x8 / Mean) ->
    # (Reshape/Squeeze) -> MatMul (+BiasAdd)
    frontier = [tops[-1].name]
    matmul = None
    for _ in range(6):
        nxt: List[str] = []
        for name in frontier:
            for c in g.consumers.get(name, []):
                if c.op == "MatMul":
                    matmul = c
                    break
                if c.op in ("AvgPool", "Mean", "Reshape", "Squeeze",
                            "Identity"):
                    if c.op == "AvgPool":    # pool_3: global 8x8 average
                        _check_pool(_PoolUnit(c), "pool_3", kernel=(8, 8),
                                    stride=(1, 1), padding="VALID",
                                    kind="avg")
                    nxt.append(c.name)
            if matmul is not None:
                break
        if matmul is not None:
            break
        frontier = nxt
    if matmul is None:
        raise ValueError("could not locate the fc MatMul after pool_3")
    fc_w = g.const(matmul.inputs[1]).astype(np.float32)
    tb = matmul.attrs.get("transpose_b")
    if tb is not None and tb.b:
        fc_w = fc_w.T
    if fc_w.ndim != 2 or fc_w.shape[0] != 2048:
        raise ValueError(f"fc weight shape {fc_w.shape}")
    fc_b = np.zeros(fc_w.shape[1], np.float32)
    for c in g.consumers.get(matmul.name, []):
        if c.op in ("BiasAdd", "Add", "AddV2"):
            fc_b = g.const(c.inputs[1]).astype(np.float32)
            break
    if perm is not None:
        fc_w = fc_w[perm, :]

    missing = sorted(set(matcher.specs) - set(matcher.params))
    if missing:
        raise ValueError(f"unassigned convs after matching: {missing}")
    # the matcher folds BN in HWIO, as the JAX package does; F.conv2d
    # takes OIHW
    params = {name: {"w": np.ascontiguousarray(v["w"].transpose(3, 2, 0, 1)), "b": v["b"]}
              for name, v in matcher.params.items()}
    params["fc"] = {"w": np.ascontiguousarray(fc_w), "b": fc_b}
    if return_meta:
        return params, dict(matcher.meta)
    return params
