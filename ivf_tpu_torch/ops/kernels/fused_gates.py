"""Fused ConvLSTM gate block (sigmoid gates), forward and backward.

Port of ``ivf_tpu/ops/pallas/fused_gates.py::pallas_gate_math``. With
``z = gates_x + gates_h`` in (i, f, c, o) order on the last axis::

    i, f, o = sigmoid(z_i, z_f, z_o)
    c' = f * c + i * tanh(z_c)
    h' = o * tanh(c')

On CUDA tensors both directions run in ``csrc/fused_gates.cu``, which
reads the gate tensors in place and adds ``gates_x + gates_h`` itself; on
CPU tensors in the plain versions below. The backward is a kernel too
(the JAX package took the autodiff of its jnp twin, which XLA fused into
one pass): given ``dh'`` and ``dc'``, with ``tc = tanh(c')``::

    dc'_total = dc' + dh' * o * (1 - tc^2)
    dz_o = dh' * tc * o * (1 - o)
    dz_i = dc'_total * tanh(z_c) * i * (1 - i)
    dz_f = dc'_total * c * f * (1 - f)
    dz_c = dc'_total * i * (1 - tanh(z_c)^2)
    dc   = dc'_total * f

and ``dz`` is the gradient of both ``gates_x`` and ``gates_h``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ivf_tpu_torch.ops.kernels import build


def _gates(gates_x, gates_h, c):
    z = gates_x if gates_h is None else gates_x + gates_h
    i, f, g, o = torch.split(z, c.shape[-1], dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def gate_math_plain(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward, the JAX package's jnp twin ``_ref_math``:
    returns (h', c')."""
    i, f, g, o = _gates(gates_x, gates_h, c)
    new_c = f * c + i * g
    return o * torch.tanh(new_c), new_c


def gate_math_bwd_plain(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain backward, the formulas of the module docstring: returns
    (dz (..., 4 Ch), dc (..., Ch))."""
    i, f, g, o = _gates(gates_x, gates_h, c)
    tc = torch.tanh(f * c + i * g)
    dcn = dc_out + dh * o * (1 - tc * tc)
    dz = torch.cat(
        [
            dcn * g * i * (1 - i),
            dcn * c * f * (1 - f),
            dcn * i * (1 - g * g),
            dh * tc * o * (1 - o),
        ],
        dim=-1,
    )
    return dz, dcn * f


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_gates")
    ptr, rows_ch = ctypes.c_void_p, [ctypes.c_longlong, ctypes.c_int]
    lib.lstm_gates_fwd_f32.argtypes = [ptr] * 5 + rows_ch + [ptr]
    lib.lstm_gates_fwd_f32.restype = ctypes.c_int
    lib.lstm_gates_bwd_f32.argtypes = [ptr] * 7 + rows_ch + [ptr]
    lib.lstm_gates_bwd_f32.restype = ctypes.c_int
    return lib


def _check_cuda_operands(gates_x, gates_h, c, *state_like) -> None:
    named = [("gates_x", gates_x), ("c", c)] + ([("gates_h", gates_h)] if gates_h is not None else [])
    named += [(f"grad{k}", t) for k, t in enumerate(state_like)]
    for name, t in named:
        if not t.is_cuda or t.device != c.device:
            raise ValueError(f"fused_gates: {name} must be on {c.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_gates: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"fused_gates: {name} must be contiguous")
    if c.dim() == 0 or gates_x.shape != (*c.shape[:-1], 4 * c.shape[-1]):
        raise ValueError(
            f"fused_gates: gates {tuple(gates_x.shape)} is not (..., 4 * Ch) over c {tuple(c.shape)}"
        )
    if gates_h is not None and gates_h.shape != gates_x.shape:
        raise ValueError(f"fused_gates: gates_h {tuple(gates_h.shape)} != gates_x {tuple(gates_x.shape)}")
    for t in state_like:
        if t.shape != c.shape:
            raise ValueError(f"fused_gates: gradient {tuple(t.shape)} != c {tuple(c.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def lstm_gates_fwd_cuda(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_fwd_f32``; returns (h', c'). Counts its launches
    in ``lstm_gates_fwd_cuda.launches``."""
    _check_cuda_operands(gates_x, gates_h, c)
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)
    if c.numel() == 0:
        return h_out, c_out
    ch = c.shape[-1]
    rc = _lib().lstm_gates_fwd_f32(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        c.numel() // ch, ch, torch.cuda.current_stream(c.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates_fwd_f32 launch failed with CUDA error {rc}")
    lstm_gates_fwd_cuda.launches += 1
    return h_out, c_out


def lstm_gates_bwd_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_f32``; returns (dz, dc). Counts its launches
    in ``lstm_gates_bwd_cuda.launches``."""
    _check_cuda_operands(gates_x, gates_h, c, dh, dc_out)
    dz, dc = torch.empty_like(gates_x), torch.empty_like(c)
    if c.numel() == 0:
        return dz, dc
    ch = c.shape[-1]
    rc = _lib().lstm_gates_bwd_f32(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), dh.data_ptr(), dc_out.data_ptr(),
        dz.data_ptr(), dc.data_ptr(), c.numel() // ch, ch,
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates_bwd_f32 launch failed with CUDA error {rc}")
    lstm_gates_bwd_cuda.launches += 1
    return dz, dc


lstm_gates_fwd_cuda.launches = 0
lstm_gates_bwd_cuda.launches = 0


def _forward(gates_x, gates_h, c):
    if c.is_cuda:
        return lstm_gates_fwd_cuda(gates_x, gates_h, c)
    if c.device.type == "cpu":
        return gate_math_plain(gates_x, gates_h, c)
    raise RuntimeError(f"fused_gates: no kernel for device {c.device}")


def _backward(gates_x, gates_h, c, dh, dc_out):
    if c.is_cuda:
        return lstm_gates_bwd_cuda(gates_x, gates_h, c, dh, dc_out)
    if c.device.type == "cpu":
        return gate_math_bwd_plain(gates_x, gates_h, c, dh, dc_out)
    raise RuntimeError(f"fused_gates: no kernel for device {c.device}")


class _GateMath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, gates_h, c):
        h_out, c_out = _forward(gates_x, gates_h, c)
        # gates_x and gates_h as they are, not a summed z: see the source
        # note of csrc/fused_gates.cu
        ctx.save_for_backward(gates_x, gates_h, c)
        return h_out, c_out

    @staticmethod
    def backward(ctx, dh, dc_out):
        gates_x, gates_h, c = ctx.saved_tensors
        dz, dc = _backward(gates_x, gates_h, c, dh.contiguous(), dc_out.contiguous())
        return dz, (dz if gates_h is not None else None), dc


def gate_math(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid-gate LSTM block over contiguous gates (..., 4 Ch) in
    (i, f, c, o) order and state c (..., Ch); ``gates_h`` may be None.
    Returns (h', c'); differentiable in all three."""
    return _GateMath.apply(gates_x, gates_h, c)
