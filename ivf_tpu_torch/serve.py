"""Serving: ``torch.export`` artifacts, a dynamic batcher and an HTTP
endpoint (port of ``ivf_tpu/serve.py``).

  * **Artifacts.** ``export_forward`` exports the model's eval forward,
    weights baked in, with a symbolic batch dimension (``torch.export``,
    the training IR), so one artifact serves every bucket size. The
    float32 forward kernels are custom ops in the graph
    (``ops/kernels/custom_ops.py``): the program launches them on the
    card and runs their plain versions on the CPU, whichever device its
    weights are on. ``save_artifact`` / ``load_artifact`` write and read
    one file in the JAX package's frame (magic, 8-byte little-endian
    length, JSON meta, payload) around ``torch.export.save``, under a
    magic of the port's own; each refuses the other's files. An artifact
    runs on the device it was exported on, recorded in its meta: a CUDA
    artifact on a host without a card raises.
  * **Dynamic batching.** Requests coalesce into padded power-of-two
    buckets, one device batch a call: one host-to-device copy in, numpy
    rows out.
  * **HTTP.** ``serve_http`` answers ``POST /predict`` (an ``.npy``
    clip), ``GET /stats`` and ``GET /healthz`` (stdlib only), and the
    command line's ``serve`` wires an artifact or a checkpoint to it.

Every forward runs under ``torch.no_grad()`` inside
``precision.reference_numerics``: an artifact does not carry the TF32
and cuDNN flags, so without it the float32 bits would depend on the
caller's settings.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ivf_tpu_torch.ops.kernels import custom_ops
from ivf_tpu_torch.precision import reference_numerics

__all__ = [
    "export_forward",
    "save_artifact",
    "load_artifact",
    "live_forward",
    "DynamicBatcher",
    "BatcherStats",
    "serve_http",
]


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------

_MAGIC = b"IVFPTX1\n"
_JAX_MAGIC = b"IVFAOT1\n"  # ivf_tpu/serve.py's jax.export artifacts


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_forward(
    model: torch.nn.Module,
    input_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    batch_polymorphic: bool = True,
    static_batch: int = 1,
    device=None,
):
    """Export ``model``'s eval forward as a ``torch.export.ExportedProgram``
    with the weights baked in.

    ``input_shape`` is the per-clip shape without the batch dimension,
    e.g. ``(16, 224, 224, 3)``. With ``batch_polymorphic`` the leading
    dimension is the symbolic size ``b`` (traced from a sample batch of 2,
    so batch 1 is not specialised), else it is fixed at ``static_batch``.
    ``device`` is the model's (its parameters'); another raises. The trace
    runs under ``torch.no_grad()`` inside ``reference_numerics``."""
    own = _device_of(model)
    if device is not None and torch.device(device) != own:
        raise ValueError(f"export_forward: the model is on {own}, not {device}")
    model.eval()
    lead = 2 if batch_polymorphic else int(static_batch)
    sample = torch.zeros((lead, *input_shape), dtype=dtype, device=own)
    dynamic = ({0: torch.export.Dim("b", min=1)},) if batch_polymorphic else None
    with torch.no_grad(), reference_numerics():
        return torch.export.export(model, (sample,), dynamic_shapes=dynamic, strict=False)


def _user_inputs(program) -> list:
    """The fake tensors of the program's user inputs."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in names]


def save_artifact(program, path: str, meta: Optional[dict] = None) -> None:
    """Write an exported forward as one self-describing file: magic,
    length-prefixed JSON meta (``device``, that of the first input, and
    ``in_specs``, each input's ``dtype[dims]``, added unless given), then
    ``torch.export.save``'s bytes."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    inputs = _user_inputs(program)
    meta = dict(meta or {})
    meta.setdefault("device", str(inputs[0].device))
    meta.setdefault("in_specs", [f"{str(t.dtype).replace('torch.', '')}[{', '.join(map(str, t.shape))}]"
                                 for t in inputs])
    mj = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(mj).to_bytes(8, "little"))
        f.write(mj)
        f.write(buf.getvalue())


def _forward_fn(fn: Callable, device: torch.device) -> Callable:
    """``fn`` on a batch (numpy or tensor) moved to ``device`` in one
    copy, under ``torch.no_grad()`` inside ``reference_numerics``;
    ``.device`` says where it runs."""

    def call(batch):
        x = torch.as_tensor(batch).to(device)
        with torch.no_grad(), reference_numerics():
            return fn(x)

    call.device = device
    return call


def load_artifact(path: str):
    """Load a ``save_artifact`` file -> ``(call_fn, meta)``.

    ``call_fn(batch)`` runs the baked-in forward on the artifact's device
    (``meta["device"]``); no model code is needed. The custom ops are
    registered first. A JAX artifact (``ivf_tpu.serve``) and anything else
    raise ``ValueError``; a CUDA artifact on a host with no card raises
    ``RuntimeError``."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX artifact of the ivf_tpu package (jax.export StableHLO); load it with "
                "ivf_tpu.serve.load_artifact, or export the model with ivf_tpu_torch.serve.export_forward"
            )
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an ivf_tpu_torch artifact")
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: exported for {device}, and this host has no CUDA device")
    custom_ops.load()
    program = torch.export.load(io.BytesIO(blob))
    call = _forward_fn(program.module(), device)
    call.program = program
    return call, meta


def live_forward(model: torch.nn.Module) -> Callable:
    """The live model's eval forward as the batcher calls an artifact."""
    return _forward_fn(model.eval(), _device_of(model))


# ---------------------------------------------------------------------------
# Dynamic batcher
# ---------------------------------------------------------------------------


@dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    padded_rows: int = 0
    rows: int = 0
    # bounded: a long-running server must not grow host memory per request
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=10_000))
    # guards latencies_ms: /stats handlers sort while the worker appends
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, latency_ms: float) -> None:
        with self._lock:
            self.latencies_ms.append(latency_ms)

    def occupancy(self) -> float:
        return self.rows / max(1, self.rows + self.padded_rows)

    def summary(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_ms)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "requests": self.requests,
            "batches": self.batches,
            "occupancy": round(self.occupancy(), 4),
            "latency_ms_p50": round(pct(0.50), 2),
            "latency_ms_p95": round(pct(0.95), 2),
        }


def _safe_set(fut: Future, result=None, exc: Optional[BaseException] = None):
    """Resolve a future once: in a shutdown race the worker and
    ``close()`` / ``submit()`` may both try, and the loser is a no-op."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:  # InvalidStateError: already resolved elsewhere
        pass


def _rows(out, n: int) -> np.ndarray:
    """The first ``n`` rows of a forward's output as numpy (one copy from
    the device)."""
    if isinstance(out, torch.Tensor):
        return out[:n].detach().cpu().numpy()
    return np.asarray(out)[:n]


class DynamicBatcher:
    """Coalesce single-clip requests into bucketed device batches.

    ``infer_fn(batch) -> outputs`` takes a leading batch dimension (a
    ``load_artifact`` call_fn, ``live_forward(model)`` or any function of
    a tensor). Requests are drained up to ``max_batch`` or until
    ``max_wait_ms`` passes with a non-empty queue, padded to the smallest
    bucket (powers of two by default) by repeating row 0 and passed to
    ``infer_fn`` as one numpy batch (an artifact's or the live model's
    call moves it to its device in one copy); each future gets its row as
    numpy.

    Use as a context manager, or call ``close()``; ``submit`` returns a
    ``concurrent.futures.Future`` resolving to the clip's output row.
    """

    def __init__(
        self,
        infer_fn: Callable,
        max_batch: int = 128,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
    ):
        if buckets is None:
            buckets = []
            b = 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = sorted(set(int(b) for b in buckets))
        assert self.buckets[-1] == max_batch, (self.buckets, max_batch)
        self.infer_fn = infer_fn
        self.device = torch.device(getattr(infer_fn, "device", "cpu"))
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.stats = BatcherStats()
        self._q: Queue = Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------
    def submit(self, clip: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(clip), fut, time.monotonic()))
        if self._closed:
            # raced with close(): the worker may already have drained past
            # this item; make sure the future resolves either way
            _safe_set(fut, exc=RuntimeError("batcher is closed"))
        return fut

    def warmup(self, clip_shape: Sequence[int], dtype=np.float32) -> None:
        """Run every bucket once and wait for the device (cuDNN's set-up
        for each shape; nothing is compiled)."""
        for b in self.buckets:
            self.infer_fn(np.zeros((b, *clip_shape), dtype))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30)
        # anything enqueued during the join window: fail, don't hang
        while True:
            try:
                item = self._q.get_nowait()
            except Empty:
                break
            if item is not None:
                _safe_set(item[1], exc=RuntimeError("batcher is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side --------------------------------------------------
    def _drain(self):
        """Block for one request, then take up to max_batch, waiting at
        most max_wait_s for stragglers."""
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the sentinel for the outer loop
                break
            batch.append(nxt)
        return batch

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self):
        while True:
            batch = self._drain()
            if batch is None:
                # shutdown: fail anything that raced past the _closed check
                # into the queue behind the sentinel, so no future hangs
                while True:
                    try:
                        item = self._q.get_nowait()
                    except Empty:
                        break
                    if item is not None:
                        _safe_set(item[1], exc=RuntimeError("batcher is closed"))
                return
            n = len(batch)
            try:
                # stack and pad inside the try: a request of another shape
                # fails its batch's futures, not the worker thread
                clips = np.stack([c for c, _, _ in batch])
                b = self._bucket(n)
                if b > n:  # pad by repeating row 0 (cheapest valid rows)
                    clips = np.concatenate([clips, np.repeat(clips[:1], b - n, axis=0)])
                out = _rows(self.infer_fn(clips), n)
            except Exception as e:  # propagate to every waiter
                for _, fut, _ in batch:
                    _safe_set(fut, exc=e)
                continue
            now = time.monotonic()
            st = self.stats
            st.requests += n
            st.batches += 1
            st.rows += n
            st.padded_rows += b - n
            for j, (_, fut, t0) in enumerate(batch):
                st.record((now - t0) * 1e3)
                _safe_set(fut, result=out[j])


# ---------------------------------------------------------------------------
# HTTP endpoint (stdlib only)
# ---------------------------------------------------------------------------


def serve_http(batcher: DynamicBatcher, port: int = 0, host: str = "127.0.0.1"):
    """Start a threading HTTP server in the background; returns the server
    (``server.server_address`` has the bound port; ``server.shutdown()``
    stops it).

    * ``POST /predict``: the body is an ``.npy`` clip ``(T, H, W, C)``;
      the response is JSON ``{"scores": [...], "top1": i}``.
    * ``GET  /stats``: the batcher's stats summary.
    * ``GET  /healthz``: liveness.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silent
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, batcher.stats.summary())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                clip = np.load(io.BytesIO(self.rfile.read(n)))
                scores = batcher.submit(clip).result(timeout=120)
            except Exception as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, {"scores": np.asarray(scores, np.float64).tolist(), "top1": int(np.argmax(scores))})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
