"""Pointwise (1x1x1) conv + bias + ReLU: ``act(X @ W + b)``.

Port of ``ivf_tpu/ops/pallas/pointwise_conv.py::pallas_pointwise_conv``.
On a CUDA tensor the GEMM runs in the hand-written kernel
``csrc/pointwise_conv.cu`` (never cuBLAS); on a CPU tensor it runs the
plain PyTorch version ``pointwise_conv_plain``. The VJP follows the JAX
package's ``_pw_bwd``: ``m = g * [y > 0]``, ``dx = m @ W^T`` through the
same kernel, ``dw = X^T m`` and ``db = sum(m)`` in plain PyTorch (JAX also
left them outside the kernel), each only when autograd asks for it.

bfloat16 operands run the tensor-core kernel ``pw_gemm_bf16`` (its own
launch counter): float32 accumulation, the bias added in float32, the
ReLU, one rounding to bfloat16, as the Pallas kernel; the backward's ReLU
mask is taken on the bfloat16 output, and ``dw``, ``db`` are summed in
float32 and cast to the parameters' dtype, as the JAX package's VJP does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ivf_tpu_torch.ops.kernels import build


def pointwise_conv_plain(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool
) -> torch.Tensor:
    """The plain version: ``x2 @ w + bias``, then ReLU; bfloat16 operands
    are multiplied and summed in float32 and rounded once at the end."""
    dtype = x2.dtype
    if dtype == torch.bfloat16:
        x2, w = x2.float(), w.float()
        bias = bias.float() if bias is not None else None
    y = x2 @ w
    if bias is not None:
        y = y + bias
    return (torch.relu(y) if relu else y).to(dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("pointwise_conv")
    lib.pw_conv_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.pw_conv_f32.restype = ctypes.c_int
    lib.pw_conv_bf16.argtypes = lib.pw_conv_f32.argtypes
    lib.pw_conv_bf16.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x2, w, bias, dtype=torch.float32) -> None:
    tensors = [("x", x2), ("w", w)] + ([("bias", bias)] if bias is not None else [])
    for name, t in tensors:
        if not t.is_cuda or t.device != x2.device:
            raise ValueError(f"pointwise_conv: {name} must be on {x2.device}")
        if t.dtype != dtype:
            raise TypeError(f"pointwise_conv: {name} is {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pointwise_conv: {name} must be contiguous")
    if x2.dim() != 2 or w.dim() != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(
            f"pointwise_conv: x {tuple(x2.shape)} @ w {tuple(w.shape)} is not (N, Cin) @ (Cin, Cout)"
        )
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"pointwise_conv: bias {tuple(bias.shape)} != ({w.shape[1]},)")


def _launch(symbol: str, dtype, x2, w, bias, relu) -> torch.Tensor:
    _check_cuda_operands(x2, w, bias, dtype)
    n, cin = x2.shape
    cout = w.shape[1]
    y = torch.empty((n, cout), device=x2.device, dtype=dtype)
    if n == 0 or cout == 0:
        return y
    rc = getattr(_lib(), symbol)(
        x2.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        y.data_ptr(), n, cin, cout, int(relu),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")
    return y


def pointwise_conv_cuda(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool
) -> torch.Tensor:
    """Launch ``pw_conv_f32``: x2 (N, Cin), w (Cin, Cout), bias (Cout,) or
    None; contiguous float32 on one CUDA device. Counts its launches in
    ``pointwise_conv_cuda.launches``."""
    y = _launch("pw_conv_f32", torch.float32, x2, w, bias, relu)
    pointwise_conv_cuda.launches += 1
    return y


def pointwise_conv_bf16_cuda(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool
) -> torch.Tensor:
    """Launch ``pw_conv_bf16``: as ``pointwise_conv_cuda`` with bfloat16
    operands and output. Counts in ``pointwise_conv_bf16_cuda.launches``."""
    y = _launch("pw_conv_bf16", torch.bfloat16, x2, w, bias, relu)
    pointwise_conv_bf16_cuda.launches += 1
    return y


pointwise_conv_cuda.launches = 0
pointwise_conv_bf16_cuda.launches = 0


def _matmul_act(x2, w, bias, relu):
    if x2.is_cuda:
        fn = pointwise_conv_bf16_cuda if x2.dtype == torch.bfloat16 else pointwise_conv_cuda
        return fn(x2, w, bias, relu)
    if x2.device.type == "cpu":
        return pointwise_conv_plain(x2, w, bias, relu)
    raise RuntimeError(f"pointwise_conv: no kernel for device {x2.device}")


class _PointwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, bias, relu):
        y = _matmul_act(x2, w, bias, relu)
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x2, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, y = ctx.saved_tensors
        m = torch.where(y > 0, g, 0.0) if ctx.relu else g
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _matmul_act(m.contiguous(), w.t().contiguous(), None, False)
        if ctx.needs_input_grad[1]:
            dw = (x2.t().float() @ m.float()).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = m.float().sum(0).to(w.dtype)
        return dx, dw, db, None


def pointwise_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """x: (..., Cin) contiguous; w: (Cin, Cout); bias: (Cout,) or None.
    Returns (..., Cout). Differentiable in x, w and bias."""
    lead = x.shape[:-1]
    y = _PointwiseConv.apply(x.reshape(-1, x.shape[-1]), w, bias, relu)
    return y.reshape(*lead, w.shape[1])
