"""Pure-Python reader and writer of TensorFlow V2 checkpoint bundles (port
of ``ivf_tpu/utils/tf_bundle.py``, copied, not imported).

The TF half of the reference saves models with ``tf.train.Saver``
(video_features_tf/train_kth.py:207,314-320), which emits the *tensor
bundle* format: ``prefix.index`` (a leveldb-style SSTable mapping tensor
names to BundleEntryProto records) plus ``prefix.data-00000-of-NNNNN``
shards holding the raw tensor bytes. This module reads that format with
no TensorFlow so reference-trained TF checkpoints import into the port's
models (``utils/import_tf.py``), and writes it.

Tensors come back, and may go in, as CPU ``torch.Tensor``s (numpy arrays
are written too): ``DT_BFLOAT16`` (code 14) is read as raw 16-bit words
and viewed as ``torch.bfloat16``, so no ``ml_dtypes`` is needed. The
writer takes every dtype the reader knows, bfloat16, int16 and int8
included.

Format references (public specs):
  * leveldb table: block = entries(prefix-compressed keys) + restart
    array + num_restarts; per-block trailer = 1-byte compression type +
    4-byte masked crc32c; footer = metaindex handle + index handle +
    padding to 40 bytes + 8-byte magic 0xdb4775248b80fb57.
  * tensorflow/core/protobuf/tensor_bundle.proto: BundleHeaderProto
    (key ""), BundleEntryProto {dtype=1, shape=2, shard_id=3, offset=4,
    size=5, crc32c=6}; TensorShapeProto {dim=2 {size=1}}.

Only uncompressed blocks are supported (TF writes the .index table
uncompressed); data crc32c checks are skipped. ``_proto_fields`` and
``_read_varint`` also serve ``data/tfrecords.py``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> torch dtype (the subset a Saver checkpoint can hold
# that we care about)
_DTYPES = {
    1: torch.float32,
    2: torch.float64,
    3: torch.int32,
    4: torch.uint8,
    5: torch.int16,
    6: torch.int8,
    9: torch.int64,
    10: torch.bool,
    14: torch.bfloat16,  # DT_BFLOAT16
    19: torch.float16,  # DT_HALF
}
_DTYPE_CODES = {dtype: code for code, dtype in _DTYPES.items()}
# the numpy dtype each one's bytes are read as (bfloat16 as its raw 16-bit
# words, viewed as torch.bfloat16 after)
_WIRE = {dtype: np.dtype(torch.empty(0, dtype=dtype).numpy().dtype) for dtype in _DTYPES.values()
         if dtype != torch.bfloat16}
_WIRE[torch.bfloat16] = np.dtype("int16")


# ---------------------------------------------------------------------------
# varint / protobuf primitives
# ---------------------------------------------------------------------------


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


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


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


def _proto_field_bytes(field: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | 2) + _write_varint(len(payload)) + payload


def _proto_field_varint(field: int, value: int) -> bytes:
    return _write_varint(field << 3) + _write_varint(value)


# ---------------------------------------------------------------------------
# SSTable (leveldb table) block parsing
# ---------------------------------------------------------------------------


def _parse_block(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Parse one uncompressed table block into (key, value) pairs."""
    if len(data) < 4:
        return []
    (num_restarts,) = struct.unpack_from("<I", data, len(data) - 4)
    entries_end = len(data) - 4 - 4 * num_restarts
    pos = 0
    key = b""
    out = []
    while pos < entries_end:
        shared, pos = _read_varint(data, pos)
        non_shared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos : pos + non_shared]
        pos += non_shared
        value = data[pos : pos + value_len]
        pos += value_len
        out.append((key, value))
    return out


def _read_block(f, offset: int, size: int) -> List[Tuple[bytes, bytes]]:
    f.seek(offset)
    raw = f.read(size + 5)  # block + 1-byte type + 4-byte crc
    ctype = raw[size]
    block = raw[:size]
    if ctype == 1:  # snappy — TF index tables are written uncompressed
        raise NotImplementedError("snappy-compressed checkpoint block")
    return _parse_block(block)


def _decode_handle(buf: bytes, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


class BundleEntry:
    __slots__ = ("dtype", "shape", "shard_id", "offset", "size")

    def __init__(self, dtype, shape, shard_id, offset, size):
        self.dtype = dtype
        self.shape = shape
        self.shard_id = shard_id
        self.offset = offset
        self.size = size


def _parse_entry(buf: bytes) -> BundleEntry:
    dtype_code, shard_id, offset, size = 1, 0, 0, 0
    shape: List[int] = []
    for field, _wire, val in _proto_fields(buf):
        if field == 1:
            dtype_code = val
        elif field == 2:  # TensorShapeProto
            for f2, _w2, v2 in _proto_fields(val):
                if f2 == 2:  # Dim
                    for f3, _w3, v3 in _proto_fields(v2):
                        if f3 == 1:
                            # Dim.size may be negative varint (unknown);
                            # interpret as signed 64-bit
                            if v3 >= 1 << 63:
                                v3 -= 1 << 64
                            shape.append(v3)
        elif field == 3:
            shard_id = val
        elif field == 4:
            offset = val
        elif field == 5:
            size = val
    if dtype_code not in _DTYPES:
        raise ValueError(f"unsupported checkpoint dtype code {dtype_code}")
    return BundleEntry(_DTYPES[dtype_code], tuple(shape), shard_id, offset, size)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def list_variables(prefix: str) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Map of tensor name -> (shape, dtype) in the bundle at ``prefix``."""
    entries = _read_index(prefix)
    return {
        name: (e.shape, e.dtype) for name, e in entries.items()
    }


def _read_index(prefix: str) -> Dict[str, BundleEntry]:
    index_path = prefix + ".index"
    with open(index_path, "rb") as f:
        f.seek(0, os.SEEK_END)
        file_size = f.tell()
        f.seek(file_size - 48)
        footer = f.read(48)
        magic = struct.unpack_from("<Q", footer, 40)[0]
        if magic != _TABLE_MAGIC:
            raise ValueError(f"{index_path}: not an SSTable (bad magic)")
        pos = 0
        _mi_off, _mi_size, pos = _decode_handle(footer, pos)
        idx_off, idx_size, pos = _decode_handle(footer, pos)
        index_entries = _read_block(f, idx_off, idx_size)
        entries: Dict[str, BundleEntry] = {}
        for _last_key, handle in index_entries:
            off, size, _ = _decode_handle(handle)
            for key, value in _read_block(f, off, size):
                if key == b"":
                    continue  # BundleHeaderProto
                entries[key.decode("utf-8")] = _parse_entry(value)
    return entries


def _shard_path(prefix: str, shard_id: int) -> str:
    # find the matching data shard file regardless of shard count
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix)
    for name in os.listdir(d):
        if name.startswith(f"{base}.data-{shard_id:05d}-of-"):
            return os.path.join(d, name)
    raise FileNotFoundError(
        f"data shard {shard_id} for checkpoint prefix {prefix}"
    )


def _to_tensor(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    arr = np.frombuffer(raw, dtype=_WIRE[dtype]).reshape(shape)
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def load_bundle(prefix: str) -> Dict[str, torch.Tensor]:
    """Read every tensor from a TF V2 checkpoint bundle as CPU tensors.

    ``prefix`` is the ``tf.train.Saver`` save path, e.g.
    ``checkpoints/model.ckpt`` (the files on disk are
    ``model.ckpt.index`` / ``model.ckpt.data-00000-of-00001``).
    """
    entries = _read_index(prefix)
    shard_files: Dict[int, object] = {}
    out: Dict[str, torch.Tensor] = {}
    try:
        for name, e in entries.items():
            f = shard_files.get(e.shard_id)
            if f is None:
                f = open(_shard_path(prefix, e.shard_id), "rb")
                shard_files[e.shard_id] = f
            f.seek(e.offset)
            out[name] = _to_tensor(f.read(e.size), e.dtype, e.shape)
    finally:
        for f in shard_files.values():
            f.close()
    return out


def _wire_array(value: Union[torch.Tensor, np.ndarray]) -> Tuple[np.ndarray, torch.dtype]:
    """(the bytes to write as a contiguous array, the tensor's dtype)."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
    t = t.detach().cpu().contiguous()
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {t.dtype}")
    words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return words.numpy(), t.dtype


def save_bundle(prefix: str, tensors: Mapping[str, Union[torch.Tensor, np.ndarray]]) -> None:
    """Write tensors (torch tensors or numpy arrays) as a TF V2 checkpoint
    bundle (single data shard): an export path toward TF tooling and the
    reference's TF half.
    """
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    names = sorted(tensors)
    wire = {}
    for name in names:
        try:
            wire[name] = _wire_array(tensors[name])
        except ValueError as exc:
            raise ValueError(f"{exc} for {name}") from None

    # ---- data shard: concatenated raw bytes ----
    data_path = prefix + ".data-00000-of-00001"
    offsets: Dict[str, Tuple[int, int]] = {}
    with open(data_path, "wb") as f:
        off = 0
        for name in names:
            raw = wire[name][0].tobytes()
            f.write(raw)
            offsets[name] = (off, len(raw))
            off += len(raw)

    # ---- index SSTable ----
    def entry_proto(name: str) -> bytes:
        arr, dtype = wire[name]
        shape = b"".join(
            _proto_field_bytes(2, _proto_field_varint(1, int(d)))
            for d in arr.shape
        )
        off, size = offsets[name]
        msg = _proto_field_varint(1, _DTYPE_CODES[dtype])
        msg += _proto_field_bytes(2, shape)
        # shard_id (3) = 0 is omitted (proto3 default)
        if off:
            msg += _proto_field_varint(4, off)
        msg += _proto_field_varint(5, size)
        return msg

    # header entry under key "": BundleHeaderProto{num_shards=1, version{producer=1}}
    header = _proto_field_varint(1, 1) + _proto_field_bytes(
        3, _proto_field_varint(1, 1)
    )

    def build_block(pairs: List[Tuple[bytes, bytes]]) -> bytes:
        # no prefix compression: every entry is a restart point
        body = bytearray()
        restarts = []
        for key, value in pairs:
            restarts.append(len(body))
            body += _write_varint(0)  # shared
            body += _write_varint(len(key))
            body += _write_varint(len(value))
            body += key
            body += value
        for r in restarts:
            body += struct.pack("<I", r)
        body += struct.pack("<I", len(restarts))
        return bytes(body)

    data_block = build_block(
        [(b"", header)] + [(n.encode(), entry_proto(n)) for n in names]
    )
    with open(prefix + ".index", "wb") as f:
        def write_block(block: bytes) -> Tuple[int, int]:
            off = f.tell()
            f.write(block)
            f.write(b"\x00")  # no compression
            f.write(struct.pack("<I", 0))  # crc placeholder (unchecked)
            return off, len(block)

        d_off, d_size = write_block(data_block)
        handle = _write_varint(d_off) + _write_varint(d_size)
        # index block: one entry, key >= last data key, value = handle
        last_key = names[-1].encode() if names else b""
        index_block = build_block([(last_key + b"\xff", handle)])
        mi_off, mi_size = write_block(build_block([]))  # empty metaindex
        i_off, i_size = write_block(index_block)
        footer = (
            _write_varint(mi_off)
            + _write_varint(mi_size)
            + _write_varint(i_off)
            + _write_varint(i_size)
        )
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        f.write(footer)
