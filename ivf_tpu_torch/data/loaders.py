"""Runtime clip loading: parallel host JPEG decode -> uint8 batches on the
device (port of ``ivf_tpu/data/loaders.py``).

Frames are decoded by a thread pool (libjpeg through ``native`` in one
batch call, else PIL), assembled into numpy batches, and, with
``to_device``, copied once to the device: each uint8 array goes into
pinned host memory and crosses with a ``non_blocking`` copy to an explicit
``device``. The data stays uint8, a quarter of float32's bytes; consumers
cast on the device (``api.find_masks``).

``FrameDirDataset`` mirrors ``ImLoader`` (data_loader_jpg.py): clip dirs of
``frame01..frameNN.jpg``; ``KTHFrameDataset`` mirrors ``KTHImLoader``
(data_loader_kth.py): numbered dirs + class.txt/label.txt;
``RecordDataset`` reads ``.ivfrecords`` or the reference's ``.tfrecords``
shards. All emit **uint8** (T, H, W, C) clips of raw 0..255 values: the
reference applies no normalization at load time.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _load_frame(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path)
    if im.mode != "RGB":  # grayscale/CMYK JPEGs (e.g. KTH) must not crash
        im = im.convert("RGB")
    arr = np.frombuffer(im.tobytes(), dtype=np.uint8)
    return arr.reshape((im.size[1], im.size[0], 3))


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is absent and no
    device was asked for. Every entry point of the port places its work
    with it (``api`` imports it from here)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ivf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


class FrameDirDataset:
    """smth-smth-style ``root/<class>/<clip_id>/frameNN.jpg`` clips."""

    def __init__(
        self,
        root: str,
        clip_size: int = 16,
        step_size: int = 1,
        get_item_id: bool = False,
    ):
        from ivf_tpu_torch.data.catalogs import FrameDirCatalog

        self.catalog = FrameDirCatalog(root)
        self.clip_size = clip_size
        self.step_size = step_size
        self.get_item_id = get_item_id

    def __len__(self):
        return len(self.catalog)

    def __getitem__(self, index: int):
        item = self.catalog.items[index]
        frames = [
            _load_frame(
                os.path.join(item.path, f"frame{i * self.step_size + 1:02d}.jpg")
            )
            for i in range(self.clip_size)
        ]
        clip = np.asarray(frames, dtype=np.uint8)
        if self.get_item_id:
            return clip, int(item.label), item.id
        return clip, int(item.label)

    def get_payloads(self, index: int):
        """Raw JPEG bytes per frame — for the native batch-decode path."""
        item = self.catalog.items[index]
        payloads = [
            _read_bytes(
                os.path.join(item.path, f"frame{i * self.step_size + 1:02d}.jpg")
            )
            for i in range(self.clip_size)
        ]
        if self.get_item_id:
            return payloads, int(item.label), item.id
        return payloads, int(item.label)


class KTHFrameDataset:
    """KTH ``root/<idx>/frameNN.jpg`` + class.txt/label.txt clips."""

    def __init__(self, root: str, clip_size: int = 32, get_item_id: bool = False):
        self.root = root
        self.clip_size = clip_size
        self.get_item_id = get_item_id
        # enumerate NUMERIC clip dirs explicitly (sorted by index) rather
        # than counting all subdirs and assuming contiguous 0-based names:
        # a stray non-clip dir (.ipynb_checkpoints, plots/) must not shift
        # or overrun the index space
        self._dirs = sorted(
            (
                d
                for d in os.listdir(root)
                if d.isdigit() and os.path.isdir(os.path.join(root, d))
            ),
            key=int,
        )

    def __len__(self):
        return len(self._dirs)

    def __getitem__(self, index: int):
        base = os.path.join(self.root, self._dirs[index])
        frames = [
            _load_frame(os.path.join(base, f"frame{i + 1:02d}.jpg"))
            for i in range(self.clip_size)
        ]
        clip = np.asarray(frames, dtype=np.uint8)
        with open(os.path.join(base, "class.txt")) as f:
            label = int(f.readline())
        if self.get_item_id:
            with open(os.path.join(base, "label.txt")) as f:
                tag = f.readline().strip()
            return clip, label, tag
        return clip, label

    def get_payloads(self, index: int):
        base = os.path.join(self.root, self._dirs[index])
        payloads = [
            _read_bytes(os.path.join(base, f"frame{i + 1:02d}.jpg"))
            for i in range(self.clip_size)
        ]
        with open(os.path.join(base, "class.txt")) as f:
            label = int(f.readline())
        if self.get_item_id:
            with open(os.path.join(base, "label.txt")) as f:
                tag = f.readline().strip()
            return payloads, label, tag
        return payloads, label


class RecordDataset:
    """Clips out of record shards — native ``.ivfrecords`` (records.py) or
    the reference's ``.tfrecords`` (tfrecords.py), dispatched per extension
    so reference-produced datasets load through the same stack."""

    def __init__(self, paths, clip_size: Optional[int] = None, get_item_id=False):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        paths = [str(p) for p in paths]
        is_tf = [p.endswith((".tfrecord", ".tfrecords")) for p in paths]
        if any(is_tf):
            if not all(is_tf):
                raise ValueError(
                    "cannot mix .tfrecords and .ivfrecords shards in one "
                    f"dataset: {paths}"
                )
            from ivf_tpu_torch.data.tfrecords import TFRecordReader

            self.reader = TFRecordReader(paths)
        else:
            from ivf_tpu_torch.data.records import RecordReader

            self.reader = RecordReader(paths)
        self.clip_size = clip_size
        self.get_item_id = get_item_id

    def __len__(self):
        return len(self.reader)

    def __getitem__(self, index: int):
        meta, frames = self.reader.read(index)
        clip = frames  # uint8 straight from the decoder
        if self.clip_size is not None:
            t = clip.shape[0]
            if t >= self.clip_size:
                clip = clip[: self.clip_size]
            else:
                pad = np.repeat(clip[-1:], self.clip_size - t, axis=0)
                clip = np.concatenate([clip, pad], axis=0)
        if self.get_item_id:
            return clip, int(meta["label"]), meta["video_id"]
        return clip, int(meta["label"])

    def get_payloads(self, index: int):
        meta, payloads = self.reader.read(index, decode=False)
        if self.clip_size is not None:
            if len(payloads) >= self.clip_size:
                payloads = payloads[: self.clip_size]
            else:
                payloads = payloads + [payloads[-1]] * (
                    self.clip_size - len(payloads)
                )
        if self.get_item_id:
            return payloads, int(meta["label"]), meta["video_id"]
        return payloads, int(meta["label"])


class ClipLoader:
    """Batched, shuffled, prefetching loader over any indexable dataset.

    Decodes with ``num_workers`` threads and keeps ``prefetch`` batches in
    flight. With ``to_device`` each batch's arrays are copied to
    ``device`` (``_place``): ``cuda`` unless the caller passes another
    device such as ``"cpu"``; without a card and with no device given the
    loader raises. ``to_device=False`` yields the numpy batches.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        mesh=None,
        to_device: bool = True,
        use_native: bool = True,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "ClipLoader(mesh=...): sharded placement is not ported yet "
                "(ROADMAP.md, Queue 1 item 13)"
            )
        self.use_native = use_native
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._epoch = 0
        self._skip_batches = 0  # consumed by the next __iter__ only
        self._native = None  # lazily resolved native-decode capability

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int, skip_batches: int = 0):
        """Pin the next iteration's shuffle epoch (torch DistributedSampler
        style) so batch order is a pure function of (seed, epoch) across
        process restarts, and optionally skip the first ``skip_batches``
        batches at the INDEX level — mid-epoch resume pays zero decode for
        the already-trained prefix (train/loop.py::fit)."""
        self._epoch = epoch - 1  # __iter__ pre-increments
        self._skip_batches = skip_batches

    def _batch_indices(self, skip: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        nb = len(self)
        for b in range(skip, nb):
            sl = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if len(sl):
                yield sl

    def _assemble(self, pool: ThreadPoolExecutor, indices) -> Tuple:
        if self._use_native():
            return self._assemble_native(pool, indices)
        samples = list(pool.map(self.dataset.__getitem__, indices))
        clips = np.stack([s[0] for s in samples])
        labels = np.asarray([s[1] for s in samples], np.int32)
        if len(samples[0]) == 3:
            ids = [s[2] for s in samples]
            return clips, labels, ids
        return clips, labels

    def _use_native(self) -> bool:
        if self._native is None:
            from ivf_tpu_torch import native

            self._native = bool(
                self.use_native
                and native.available()
                and hasattr(self.dataset, "get_payloads")
            )
        return self._native

    def _assemble_native(self, pool: ThreadPoolExecutor, indices) -> Tuple:
        """IO via the thread pool, then ONE native libjpeg batch decode for
        every frame of every clip in the batch."""
        from ivf_tpu_torch import native

        samples = list(pool.map(self.dataset.get_payloads, indices))
        t = len(samples[0][0])
        flat = [p for s in samples for p in s[0]]
        frames = native.decode_batch(flat, n_threads=self.num_workers)
        clips = frames.reshape(len(samples), t, *frames.shape[1:])  # uint8
        labels = np.asarray([s[1] for s in samples], np.int32)
        if len(samples[0]) == 3:
            return clips, labels, [s[2] for s in samples]
        return clips, labels

    def _place(self, batch):
        """Each numpy array of ``batch`` as a tensor on ``self.device``, its
        dtype kept: through pinned host memory and a ``non_blocking`` copy
        on a CUDA device (the pinned block is not reused before the copy
        ends), as it is on the CPU. Ids and other entries pass as they
        are."""
        if not self.to_device:
            return batch
        cuda = self.device.type == "cuda"

        def put(x):
            host = torch.from_numpy(np.ascontiguousarray(x))
            if not cuda:
                return host.to(self.device)
            return host.pin_memory().to(self.device, non_blocking=True)

        return tuple(put(x) if isinstance(x, np.ndarray) else x for x in batch)

    def __iter__(self) -> Iterator:
        self._epoch += 1
        skip, self._skip_batches = self._skip_batches, 0
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def _put(item) -> bool:
            # bounded put that honors consumer cancellation so an
            # early break (test_run / max_steps) can't strand us
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in self._batch_indices(skip):
                        if not _put(self._assemble(pool, indices)):
                            return
            except BaseException as exc:  # surface on the consumer side
                _put(exc)
                return
            _put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._place(item)
        finally:
            cancel.set()
            t.join(timeout=30)
