"""Protobuf wire-format primitives (copy of the two helpers of
``ivf_tpu/utils/tf_bundle.py`` that ``data/tfrecords.py`` reads Example
protos with). The rest of that module, the TensorFlow checkpoint-bundle
reader and writer, belongs to checkpoint I/O (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import struct
from typing import Tuple


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) from a serialized message.
    value is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 0x7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val
