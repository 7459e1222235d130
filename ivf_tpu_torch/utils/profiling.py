"""Tracing and NaN-debugging switches (port of ``ivf_tpu/utils/profiling.py``).

The reference's observability is wall-clock printouts (train_kth.py:322-326,
AverageMeters) and ``torch.autograd.detect_anomaly`` around the mask search
(FindMasksComparison_I3D_smth.py:51). Here:

  * ``trace``: ``torch.profiler`` over the host and, where there is one,
    the card, written for TensorBoard (``tensorboard_trace_handler``):
    every op, and every kernel the card ran, the port's hand kernels
    included;
  * ``detect_anomaly``: raises at the first op whose floating-point output
    holds a NaN, forward or backward, and runs autograd's anomaly mode,
    which names the forward op of a backward that made one;
  * ``StepTimer``: the step time and clips/s meter of the reference's
    end-of-run report.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA's
    where a card is present) and write the trace into ``log_dir`` as
    ``tensorboard_trace_handler`` names it (``<worker>.<time>.pt.trace.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ):
        yield


class _NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating-point
    output holds a NaN (``jax_debug_nans``). Allocations (``empty*``)
    and views are not read: they compute nothing, and a buffer a hand
    kernel is about to fill holds whatever memory it was given."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__
        if func.is_view or name.startswith(("empty", "new_empty")):
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def detect_anomaly(enable: bool = True):
    """NaN sanitizer, the analogue of the JAX package's ``jax_debug_nans``
    switch: inside the block every op's floating-point output is read and
    the first that holds a NaN raises ``FloatingPointError``, in the
    forward as in the backward; ``torch.autograd.set_detect_anomaly`` is on
    too, so a backward's error names the forward op that recorded it.
    Each op then waits for the device. What it cannot see: the port's
    hand kernels launch through ``ctypes``, outside PyTorch's dispatch, so
    a NaN that one writes is caught only at the next op that reads its
    output. ``enable=False`` leaves the block as it is."""
    if not enable:
        yield
        return
    with torch.autograd.set_detect_anomaly(True), _NaNCheck():
        yield


class StepTimer:
    """Step time + clips/sec meter (train_kth.py:203,243-258,322-326)."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.time()

    def stop(self, n_clips: int = 0) -> float:
        dt = time.time() - self._t0
        self.times.append((dt, n_clips))
        return dt

    @property
    def mean_step_time(self) -> float:
        if not self.times:
            return 0.0
        return sum(t for t, _ in self.times) / len(self.times)

    @property
    def clips_per_sec(self) -> float:
        total_t = sum(t for t, _ in self.times)
        total_c = sum(c for _, c in self.times)
        return total_c / total_t if total_t else 0.0

    def report(self) -> str:
        return (
            f"Average step time: {self.mean_step_time:.4f}s "
            f"({self.clips_per_sec:.1f} clips/sec)"
        )
