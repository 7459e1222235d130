"""ivfrecords, the packed clip-record format (copy of
``ivf_tpu/data/records.py``: byte-compatible, so each package reads the
other's shards).

Replaces the reference's TFRecord layer
(``video_features_tf/tfrecords/generate_tfrecords.py``): each record holds
the same fields the reference serializes (nb_frames, height, width, label,
video_id, JPEG-encoded frames), in a dependency-free binary container:

  file  := MAGIC(4)=b'IVFR' | version u32 | record* | index | index_off u64
           | index_len u64 | MAGIC
  record:= meta_len u32 | meta(json utf8) | nframes u32 |
           (frame_len u32 | jpeg bytes)*
  index := json list of record byte offsets

The trailing index gives O(1) random access; readers mmap-friendly
sequential scans work too. Shard-per-subject layout (KTH:
``kth_subject_<s>.ivfrecords``) mirrors script_generate_tfrecords_kth.py.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC = b"IVFR"
VERSION = 1


def encode_jpeg(frame: np.ndarray, quality: int = 95) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame.astype(np.uint8)).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def decode_jpeg(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


class RecordWriter:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<I", VERSION))
        self._offsets: List[int] = []

    def write(
        self,
        frames: np.ndarray,  # (T, H, W, 3) uint8 — or pre-encoded bytes list
        label: int,
        video_id: str,
        extra: Optional[Dict] = None,
        quality: int = 95,
    ):
        if isinstance(frames, np.ndarray):
            assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
            t, h, w, _ = frames.shape
            payloads = [encode_jpeg(f, quality) for f in frames]
        else:
            payloads = list(frames)
            probe = decode_jpeg(payloads[0])
            t, h, w = len(payloads), probe.shape[0], probe.shape[1]
        meta = {
            "nb_frames": int(t),
            "height": int(h),
            "width": int(w),
            "label": int(label),
            "video_id": str(video_id),
        }
        if extra:
            meta.update(extra)
        mb = json.dumps(meta).encode()
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<I", len(mb)))
        self._f.write(mb)
        self._f.write(struct.pack("<I", len(payloads)))
        for p in payloads:
            self._f.write(struct.pack("<I", len(p)))
            self._f.write(p)

    def close(self):
        index = json.dumps(self._offsets).encode()
        off = self._f.tell()
        self._f.write(index)
        self._f.write(struct.pack("<QQ", off, len(index)))
        self._f.write(MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # A build that died mid-dataset must not leave a complete-looking
            # shard behind: skip the footer (readers reject the truncated
            # file) and remove it so a later run can't silently train on a
            # partial dataset.
            self._f.close()
            path = self.path
            try:
                os.remove(path)
            except OSError:
                pass
            return False
        self.close()


class RecordReader:
    """Random-access reader over one or more ivfrecords shards."""

    def __init__(self, paths):
        import threading

        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        # readers are used from loader thread pools; seek+read must be atomic
        self._lock = threading.Lock()
        self._files = []
        self._entries: List[Tuple[int, int]] = []  # (file_idx, offset)
        for fi, p in enumerate(self.paths):
            f = open(p, "rb")
            assert f.read(4) == MAGIC, f"bad magic in {p}"
            (version,) = struct.unpack("<I", f.read(4))
            assert version == VERSION
            f.seek(-20, os.SEEK_END)
            off, ln = struct.unpack("<QQ", f.read(16))
            assert f.read(4) == MAGIC, f"truncated record file {p}"
            f.seek(off)
            offsets = json.loads(f.read(ln))
            self._files.append(f)
            self._entries.extend((fi, o) for o in offsets)

    def __len__(self):
        return len(self._entries)

    def read_meta(self, i: int) -> Dict:
        fi, off = self._entries[i]
        f = self._files[fi]
        with self._lock:
            f.seek(off)
            (mlen,) = struct.unpack("<I", f.read(4))
            return json.loads(f.read(mlen))

    def read(self, i: int, decode: bool = True):
        """Returns (meta, frames) — frames decoded (T,H,W,3) uint8 or raw
        JPEG bytes list when decode=False. Thread-safe."""
        fi, off = self._entries[i]
        f = self._files[fi]
        with self._lock:
            f.seek(off)
            (mlen,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(mlen))
            (nframes,) = struct.unpack("<I", f.read(4))
            payloads = []
            for _ in range(nframes):
                (flen,) = struct.unpack("<I", f.read(4))
                payloads.append(f.read(flen))
        if not decode:
            return meta, payloads
        frames = np.stack([decode_jpeg(p) for p in payloads])
        return meta, frames

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self.read(i)

    def close(self):
        for f in self._files:
            f.close()
