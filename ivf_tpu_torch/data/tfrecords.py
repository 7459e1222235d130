"""Dependency-free reader (and test-support writer) for the reference's
``.tfrecords`` artifacts (copy of ``ivf_tpu/data/tfrecords.py``).

The TF half's entire data pipeline emits TFRecord files of ``tf.train.Example``
protos with six fixed features (``generate_tfrecords.py:26-55``):
``nb_frames``/``height``/``width``/``label`` (int64), ``video_id`` (bytes) and
``frames`` (bytes list, one JPEG per frame). A user holding such files must be
able to load them directly — this module parses both the TFRecord wire framing
(little-endian uint64 length + masked crc32c of the length bytes, payload,
masked crc32c of the payload) and the Example proto, with no TensorFlow
dependency, exactly like ``utils/tf_bundle.py`` already does for checkpoints.

``TFRecordReader`` exposes the same surface as ``records.RecordReader``
(``__len__`` / ``read_meta`` / ``read(i, decode)``), so ``RecordDataset`` and
the whole loader/training stack work on reference-produced data unchanged.

Color note: the reference writer JPEG-encodes with ``cv2.imencode`` arrays
that were loaded RGB (``helpers/util.py process_image``), so the stored JPEGs
have R and B swapped relative to the original video. The TF training pipeline
decodes them as-is (``train_kth.py:75-80``), i.e. the models see the swapped
channels consistently — this reader likewise decodes as stored, byte-for-byte
what the reference training saw.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ivf_tpu_torch.utils.tf_bundle import _proto_fields, _read_varint

# ---------------------------------------------------------------------------
# masked crc32c (Castagnoli), as used by the TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []

def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        # atomic swap of a fully-built local — readers run from loader
        # thread pools, and two first-callers appending into the shared
        # list would interleave and corrupt the table permanently
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


def iter_tfrecord_offsets(path: str, verify_crc: bool = False):
    """Yield ``(offset, payload_bytes)`` for every record in the file.

    ``verify_crc=True`` additionally checks the payload checksum (a pure-
    Python byte loop — enable for integrity checks/tests, not bulk loading;
    the cheap 8-byte length crc is always verified)."""
    with open(path, "rb") as f:
        while True:
            offset = f.tell()
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != len_crc:
                raise ValueError(
                    f"bad length crc at offset {offset} in {path} — "
                    "not a TFRecord file?"
                )
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) < length or len(tail) < 4:
                raise ValueError(f"truncated TFRecord payload in {path}")
            if verify_crc:
                (data_crc,) = struct.unpack("<I", tail)
                if masked_crc32c(payload) != data_crc:
                    raise ValueError(
                        f"bad data crc at offset {offset} in {path}"
                    )
            yield offset, payload


# ---------------------------------------------------------------------------
# tf.train.Example proto
# ---------------------------------------------------------------------------


def _parse_feature(buf: bytes):
    """Feature{bytes_list=1, float_list=2, int64_list=3} -> python value."""
    for field, wire, val in _proto_fields(buf):
        if field == 1 and wire == 2:  # BytesList{repeated bytes value=1}
            return [v for f2, w2, v in _proto_fields(val) if f2 == 1]
        if field == 3 and wire == 2:  # Int64List{repeated int64 value=1}
            out: List[int] = []
            for f2, w2, v in _proto_fields(val):
                if f2 != 1:
                    continue
                if w2 == 0:
                    out.append(v)
                else:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(x)
            # two's-complement for negative int64 varints
            return [x - (1 << 64) if x >= 1 << 63 else x for x in out]
        if field == 2 and wire == 2:  # FloatList{packed float value=1}
            for f2, w2, v in _proto_fields(val):
                if f2 == 1 and w2 == 2:
                    return list(
                        struct.unpack(f"<{len(v) // 4}f", v)
                    )
            return []
    return []


def parse_example(buf: bytes) -> Dict[str, list]:
    """Example{features=1: Features{feature=1: map<string, Feature>}}."""
    feats: Dict[str, list] = {}
    for field, wire, val in _proto_fields(buf):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _proto_fields(val):
            if f2 != 1 or w2 != 2:
                continue
            key, feature = None, []
            for f3, w3, v3 in _proto_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feature = _parse_feature(v3)
            if key is not None:
                feats[key] = feature
    return feats


# ---------------------------------------------------------------------------
# reader with the RecordReader surface
# ---------------------------------------------------------------------------


class TFRecordReader:
    """Random-access reader over reference ``.tfrecords`` shards.

    TFRecord files carry no index, so offsets are scanned once at open
    (header-only reads); Example payloads parse lazily per access."""

    def __init__(self, paths, verify_crc: bool = False):
        import threading

        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        self._lock = threading.Lock()
        self._files = []
        self._entries: List[Tuple[int, int, int]] = []  # (file, off, len)
        for fi, p in enumerate(self.paths):
            f = open(p, "rb")
            self._files.append(f)
            for off, payload in iter_tfrecord_offsets(p, verify_crc):
                self._entries.append((fi, off + 12, len(payload)))

    def __len__(self) -> int:
        return len(self._entries)

    def _example(self, i: int) -> Dict[str, list]:
        fi, off, ln = self._entries[i]
        f = self._files[fi]
        with self._lock:
            f.seek(off)
            buf = f.read(ln)
        return parse_example(buf)

    @staticmethod
    def _meta(feats: Dict[str, list]) -> Dict:
        def _int(key, default=0):
            v = feats.get(key) or [default]
            return int(v[0])

        vid = feats.get("video_id") or [b""]
        return {
            "video_id": vid[0].decode("utf-8", "replace"),
            "label": _int("label"),
            "nb_frames": _int("nb_frames", len(feats.get("frames") or [])),
            "height": _int("height"),
            "width": _int("width"),
        }

    def read_meta(self, i: int) -> Dict:
        return self._meta(self._example(i))

    def read(self, i: int, decode: bool = True):
        feats = self._example(i)
        meta = self._meta(feats)
        payloads = list(feats.get("frames") or [])
        if not decode:
            return meta, payloads
        from ivf_tpu_torch.data.records import decode_jpeg

        frames = np.stack([decode_jpeg(p) for p in payloads])
        return meta, frames

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self.read(i)

    def close(self):
        for f in self._files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# writer (interop/testing) — emits files TF itself can read
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = b""
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _int64_feature(values: List[int]) -> bytes:
    body = b"".join(
        _varint(1 << 3) + _varint(v & ((1 << 64) - 1)) for v in values
    )
    return _field(3, body)


def _bytes_feature(values: List[bytes]) -> bytes:
    return _field(1, b"".join(_field(1, v) for v in values))


def build_example(
    video_id: str,
    label: int,
    frames: List[bytes],
    height: int,
    width: int,
) -> bytes:
    """Serialize the reference's 6-feature Example
    (generate_tfrecords.py:41-53)."""
    feats = {
        "nb_frames": _int64_feature([len(frames)]),
        "height": _int64_feature([height]),
        "width": _int64_feature([width]),
        "label": _int64_feature([label]),
        "video_id": _bytes_feature([video_id.encode("utf-8")]),
        "frames": _bytes_feature(frames),
    }
    entries = b"".join(
        _field(1, _field(1, k.encode()) + _field(2, v))
        for k, v in feats.items()
    )
    return _field(1, entries)  # Example.features


def write_tfrecord(path: str, examples: List[bytes]):
    """Write serialized Example payloads with TFRecord framing."""
    with open(path, "wb") as f:
        for payload in examples:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))
