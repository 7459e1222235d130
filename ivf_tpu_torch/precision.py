"""Exact float32 and deterministic cuDNN inside the port's entry points.

PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits, and lets cuDNN pick algorithms that add with atomics, whose
sums change from run to run. The JAX package has no TF32 switch and the
port promises its float32 results and equal bits from two equal runs, so
``find_masks``, the model forwards and the functions that differentiate
through a model run inside ``reference_numerics``: TF32 off for cuDNN and
cuBLAS, ``cudnn.deterministic`` on, and the caller's flags as they were
afterwards. ``cudnn.benchmark`` is left as the caller set it: off, cuDNN's
heuristic picks one deterministic algorithm per shape, the same in every
process; on, it times them in each process, which may then pick another.
Both the older ``allow_tf32`` flags and, where this PyTorch has them, the
per-operation ``fp32_precision`` settings are set, since PyTorch reads
either, the older first: setting one of them moves the newer ones with
it. Restoring goes in the same order, so the newer, more specific
settings end as the caller left them.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OPS = ("conv", "rnn")  # cuDNN's per-operation precision settings


def _attr(obj, name: str, pinned):
    return (lambda: getattr(obj, name), lambda v: setattr(obj, name, v), pinned)


def _switches():
    """(getter, setter, pinned value) of every switch this PyTorch has,
    the older flags first and ``cudnn.deterministic`` last."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    out = [
        _attr(cudnn, "allow_tf32", False),
        _attr(matmul, "allow_tf32", False),
        (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision, "highest"),
    ]
    for op in _OPS:
        sub = getattr(cudnn, op, None)
        if sub is not None and hasattr(sub, "fp32_precision"):
            out.append(_attr(sub, "fp32_precision", "ieee"))
    if hasattr(matmul, "fp32_precision"):
        out.append(_attr(matmul, "fp32_precision", "ieee"))
    out.append(_attr(cudnn, "deterministic", True))
    return out


def _read(getter):
    try:
        return getter()
    except RuntimeError:
        # PyTorch refuses to read an older flag that the caller left at odds
        # with the newer settings; the newer ones are saved and restored
        return None


@contextlib.contextmanager
def reference_numerics():
    """TF32 off for cuDNN and cuBLAS and deterministic cuDNN algorithms
    inside the block; the caller's settings restored after it, also when it
    raises."""
    switches = _switches()
    saved = [(setter, _read(getter)) for getter, setter, _ in switches]
    try:
        for _, setter, value in switches:
            setter(value)
        yield
    finally:
        for setter, value in saved:
            if value is not None:
                setter(value)


def reference_numerics_fn(fn):
    """``fn`` run inside ``reference_numerics``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with reference_numerics():
            return fn(*args, **kwargs)

    return wrapped


def inference_model(model: torch.nn.Module, dtype: torch.dtype, device=None) -> torch.nn.Module:
    """``model`` as inference runs it in ``dtype``: in eval mode, every
    floating parameter and buffer cast, BN statistics included, in place
    (``Module.to``). The search's model (``api.build_model``) and the
    bfloat16 eval step's copy of a float32 training master are both made
    here."""
    return model.to(device, dtype).eval()
