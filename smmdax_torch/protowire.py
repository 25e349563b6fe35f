"""A minimal protobuf wire-format reader and writer, written from the public
protobuf encoding spec: the port's frozen TF graph reader
(``eval/tf_graph.py``) and its TFRecord reader (``data/tfrecord.py``,
``tf.train.Example``) parse their messages with it, and its TensorBoard
writer (``tfevents.py``) encodes its ``Event`` records, without
TensorFlow.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
from typing import List, Tuple


def varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes.

    value is an int for varint fields, bytes for length-delimited,
    and raw little-endian bytes for fixed32/fixed64.
    """
    i, n = 0, len(buf)
    while i < n:
        key, i = varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, i = varint(buf, i)
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def packed_varints(val, wt) -> List[int]:
    if wt == 0:
        return [val]
    out, i = [], 0
    while i < len(val):
        v, i = varint(val, i)
        out.append(v)
    return out


def signed(v: int) -> int:
    """Plain (non-zigzag) int64 varints store negatives as 2^64 - |x|."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Encoders, the inverse of the readers above (TensorBoard's ``Event``
# records, ``tfevents.py``).


def encode_varint(v: int) -> bytes:
    """A non-negative integer as a varint."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def field_varint(field: int, v: int) -> bytes:
    return encode_varint(field << 3) + encode_varint(v)


def field_bytes(field: int, data: bytes) -> bytes:
    return encode_varint(field << 3 | 2) + encode_varint(len(data)) + data


def field_double(field: int, x: float) -> bytes:
    return encode_varint(field << 3 | 1) + struct.pack("<d", x)
