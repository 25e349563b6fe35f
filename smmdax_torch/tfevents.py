"""TensorBoard event files with the standard library alone.

The JAX package writes its metrics through ``tf.summary`` (TF2's
``create_file_writer`` and ``tf.summary.scalar``); the machine with the
card has no TensorFlow, so this module writes the same files:

* the name ``events.out.tfevents.<seconds>.<host>.<pid>.<n>.v2``, ``n``
  counting the files this process opened, as TF2's ``EventsWriter``;
* records framed as TFRecords: the length as a little-endian uint64, the
  masked CRC32C of those 8 bytes, the data, the masked CRC32C of the data
  (mask ``((c >> 15) | (c << 17)) + 0xa282ead8``; CRC32C is Castagnoli's
  polynomial, which ``zlib.crc32`` is not);
* a first ``Event`` with the whole seconds as ``wall_time``,
  ``file_version: "brain.Event:2"`` and TF's writer name as
  ``source_metadata``;
* one ``Event`` per scalar, field for field as ``tf.summary.scalar``
  writes it: ``wall_time``, ``step``, and a ``Summary.Value`` with the
  tag, a scalar ``DT_FLOAT`` tensor whose 4 bytes lie in
  ``tensor_content``, and the ``scalars`` plugin's metadata.

``read_events`` reads a file back, checking both CRCs of every record.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Dict, List

import numpy as np

from smmdax_torch import protowire

_POLY = 0x82F63B78   # CRC32C (Castagnoli), reflected
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
_FILES = itertools.count()
_WRITER = b"tensorflow.core.util.events_writer"
_DT_FLOAT = 1


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord frame around ``data``."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc(head)) + data
            + struct.pack("<I", masked_crc(data)))


def scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    """The ``Event`` of ``tf.summary.scalar(tag, value)`` at ``step``."""
    tensor = (protowire.field_varint(1, _DT_FLOAT) + protowire.field_bytes(2, b"")
              + protowire.field_bytes(4, np.float32(value).tobytes()))
    metadata = protowire.field_bytes(1, protowire.field_bytes(1, b"scalars"))
    val = (protowire.field_bytes(1, tag.encode()) + protowire.field_bytes(8, tensor)
           + protowire.field_bytes(9, metadata))
    return (protowire.field_double(1, wall_time) + protowire.field_varint(2, int(step))
            + protowire.field_bytes(5, protowire.field_bytes(1, val)))


class EventFileWriter:
    """One event file under ``log_dir``, as TF2's ``create_file_writer``
    opens it; ``scalars`` appends one event per metric, and ``flush`` puts
    them on disk."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        name = (f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_FILES)}.v2")
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        first = (protowire.field_double(1, float(int(now)))
                 + protowire.field_bytes(3, b"brain.Event:2")
                 + protowire.field_bytes(10, protowire.field_bytes(1, _WRITER)))
        self._fh.write(record(first))

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            self._fh.write(record(scalar_event(step, k, float(v), time.time())))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _parse_event(data: bytes) -> dict:
    ev = {"wall_time": None, "step": 0, "file_version": None, "values": []}
    for field, _, val in protowire.fields(data):
        if field == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2:
            ev["step"] = protowire.signed(val)
        elif field == 3:
            ev["file_version"] = val.decode()
        elif field == 5:
            for _, _, v in protowire.fields(val):            # Summary.value
                tag = value = None
                for vf, _, vv in protowire.fields(v):
                    if vf == 1:
                        tag = vv.decode()
                    elif vf == 8:                              # the scalar tensor
                        for tf_, _, tv in protowire.fields(vv):
                            if tf_ == 4:
                                value = float(np.frombuffer(tv, np.float32)[0])
                ev["values"].append((tag, value))
    return ev


def read_events(path: str) -> List[dict]:
    """The events of a file, in order, as dicts (``wall_time``, ``step``,
    ``file_version``, ``values``: (tag, float32 value) pairs).  A record
    whose length or data CRC does not match raises ``ValueError``."""
    with open(path, "rb") as f:
        buf = f.read()
    out, i = [], 0
    while i < len(buf):
        if len(buf) - i < 12:
            raise ValueError(f"{path}: truncated record header at byte {i}")
        head = buf[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        if struct.unpack("<I", buf[i + 8:i + 12])[0] != masked_crc(head):
            raise ValueError(f"{path}: length CRC mismatch at byte {i}")
        if len(buf) - i - 12 < n + 4:
            raise ValueError(f"{path}: truncated record at byte {i}")
        data = buf[i + 12:i + 12 + n]
        if struct.unpack("<I", buf[i + 12 + n:i + 16 + n])[0] != masked_crc(data):
            raise ValueError(f"{path}: data CRC mismatch at byte {i}")
        out.append(_parse_event(data))
        i += 16 + n
    return out
