"""TFRecord ingestion without TensorFlow (port of ``smmdax/data/tfrecord.py``).

TFRecords are a sequential format, but batches must be a pure function of
(seed, step) for exact resume, so the loader scans each file once at
startup to build an offset index (header hopping, no payload reads; the
CRCs are not checked, as in the JAX package) and serves batches by seek
and read, decoding the records of a batch in a pool of threads.
``tf.train.Example`` protos are parsed with the port's protobuf
wire-format reader (``smmdax_torch/protowire.py``).

Supported record layouts, as in the JAX package:
  * raw bytes feature  'image'/'data'/'image/raw' + optional 'shape' int64 list
  * encoded feature    'image/encoded'/'encoded' (JPEG or PNG, decoded by
    ``data/image.decode_image``)
followed by a center crop (not clamped to the image) and PIL's bilinear
resize to the configured output size.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from smmdax_torch.data.image import (DECODE_THREADS, DecodePool, decode_image,
                                     resize_bilinear_pil)
from smmdax_torch.protowire import fields, packed_varints, signed

Array = np.ndarray

_HEADER = struct.Struct("<QI")     # length (u64), masked crc32 of length (u32)
_FOOTER_LEN = 4                    # masked crc32 of data


def index_tfrecord(path: str) -> List[Tuple[int, int]]:
    """One pass over a TFRecord file -> [(payload_offset, length), ...]."""
    index = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + _HEADER.size <= size:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break
            length, _ = _HEADER.unpack(header)
            payload_off = pos + _HEADER.size
            index.append((payload_off, length))
            pos = payload_off + length + _FOOTER_LEN
            f.seek(pos)
    return index


def parse_example(payload: bytes) -> Dict[str, Tuple[str, list]]:
    """``tf.train.Example`` bytes -> {feature name: (kind, values)}, kind
    "bytes", "float" or "int64" (Example.features = 1, Features.feature =
    1 as map entries of key 1 and value 2, Feature's oneof bytes_list = 1,
    float_list = 2, int64_list = 3, each list's values = 1).  A key given
    twice keeps its last value, as a protobuf map does."""
    feats: Dict[str, Tuple[str, list]] = {}
    for field, wt, features in fields(payload):
        if field != 1 or wt != 2:
            continue
        for f2, wt2, entry in fields(features):
            if f2 != 1 or wt2 != 2:
                continue
            key, feature = "", b""
            for f3, wt3, v3 in fields(entry):
                if f3 == 1 and wt3 == 2:
                    key = bytes(v3).decode()
                elif f3 == 2 and wt3 == 2:
                    feature = v3
            kind, values = "", []
            for f4, wt4, lst in fields(feature):
                if wt4 != 2:
                    continue
                if f4 == 1:
                    kind, values = "bytes", [bytes(v) for f5, wt5, v in fields(lst)
                                             if f5 == 1 and wt5 == 2]
                elif f4 == 2:
                    kind, values = "float", [
                        x for f5, wt5, v in fields(lst) if f5 == 1
                        for x in (np.frombuffer(v, "<f4").tolist() if wt5 == 2
                                  else struct.unpack("<f", v))]
                elif f4 == 3:
                    kind, values = "int64", [signed(x) for f5, wt5, v in fields(lst)
                                             if f5 == 1 for x in packed_varints(v, wt5)]
            feats[key] = (kind, values)
    return feats


class TFRecordSource:
    """Deterministic random-access batches from TFRecord shards."""

    def __init__(self, root: str, output_size: int, crop: Optional[int] = None,
                 seed: int = 0, pattern: str = ".tfrecord",
                 decode_threads: int = DECODE_THREADS):
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if pattern in f)
        if not self.files:
            raise FileNotFoundError(f"no TFRecord files under {root}")
        self.output_size = output_size
        self.crop = crop
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        # global record index: (file_id, offset, length)
        self._index: List[Tuple[int, int, int]] = []
        for fi, path in enumerate(self.files):
            for off, ln in index_tfrecord(path):
                self._index.append((fi, off, ln))
        if not self._index:
            raise ValueError(f"no records found under {root}")
        self._handles = [open(p, "rb") for p in self.files]
        # the trainer reads batches from a prefetch thread while scoring
        # reads from the main thread: seek+read on shared handles must
        # be serialized
        self._lock = threading.Lock()
        # the records are read in order, then decoded in a pool of threads
        self.pool = DecodePool(decode_threads)

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        return (self.output_size, self.output_size, 3)

    def __len__(self) -> int:
        return len(self._index)

    def _decode(self, payload: bytes) -> Array:
        feat = parse_example(payload)

        def values(key: str, kind: str) -> list:
            got = feat.get(key)
            return got[1] if got is not None and got[0] == kind else []

        img: Optional[Array] = None
        for key in ("image/encoded", "encoded"):
            if values(key, "bytes"):
                img = decode_image(values(key, "bytes")[0])
                break
        if img is None:
            for key in ("image", "data", "image/raw"):
                if values(key, "bytes"):
                    buf = np.frombuffer(values(key, "bytes")[0], np.uint8)
                    if values("shape", "int64"):
                        shape = tuple(values("shape", "int64"))
                    else:
                        side = int(round((buf.size / 3) ** 0.5))
                        shape = (side, side, 3)
                    img = buf.reshape(shape)
                    break
        if img is None:
            raise ValueError("record has no recognizable image feature "
                             f"(keys: {list(feat.keys())})")
        return self._crop_resize(img)

    def _crop_resize(self, img: Array) -> Array:
        h, w = img.shape[:2]
        c = self.crop or min(h, w)
        if (h, w) != (c, c):
            top, left = (h - c) // 2, (w - c) // 2
            img = img[top:top + c, left:left + c]
        if img.shape[0] != self.output_size:
            img = resize_bilinear_pil(img, (self.output_size,) * 2)
        return img

    def batch(self, n: int, key: Optional[int] = None,
              rows: Optional[Array] = None) -> Array:
        """n samples in [-1, 1], or the ``rows`` of them (every draw is
        made, only those records are read and decoded)."""
        rng = self._rng if key is None else np.random.default_rng(
            (self.seed, key))
        ids = rng.integers(0, len(self._index), size=n)
        if rows is not None:
            ids = ids[rows]
        payloads = []
        with self._lock:
            for rid in ids:
                fi, off, ln = self._index[rid]
                fh = self._handles[fi]
                fh.seek(off)
                payloads.append(fh.read(ln))
        u8 = self.pool.decode_into(self._decode, payloads, np.empty(
            (len(ids), self.output_size, self.output_size, 3), np.uint8))
        return (u8.astype(np.float32) - 127.5) / 127.5
