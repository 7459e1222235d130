"""3x3x3 stride-1 zero-padded SAME max pool, forward and backward.

Port of ``ivf_tpu/ops/pallas/maxpool3d.py::pallas_maxpool3d_s1``, the
Inception branch-3 pool. On CUDA tensors both directions run in
``csrc/maxpool3d.cu``; on CPU tensors in the plain versions below. The
backward is the exact 27-term gather

    dx[t,h,w] = sum over in-range neighbours n of (x[t,h,w] == y[n]) * g[n]

which credits EVERY tied maximum, where ``F.max_pool3d``'s backward (and
XLA's select_and_scatter) routes each window's gradient to one of them.
The two agree where every window's maximum is unique. On a plateau a
window with k tied maxima hands out k times its gradient; in I3D the
stride-2 trunk pools copy each maximum into neighbouring voxels, so the
branch-3 pools after them meet such plateaus and this backward gives a
larger input gradient than ``F.max_pool3d``'s. It is the Pallas kernel's
rule, kept as it is (tests/test_torch_ops.py holds the two equal).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.conv import max_pool3d_same
from ivf_tpu_torch.ops.kernels import build

_PAD = (0, 0, 1, 1, 1, 1, 1, 1)  # zero halo of one voxel on T, H, W


def maxpool3d_s1_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain forward: zero ``F.pad`` + ``F.max_pool3d``."""
    return max_pool3d_same(x, (3, 3, 3), (1, 1, 1)).contiguous()


def maxpool3d_s1_bwd_plain(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain backward: the 27-term gather written with shifts, summed in
    the kernel's order (dt, then dh, then dw, each -1..1)."""
    _, t, h, w, _ = x.shape
    yp = F.pad(y, _PAD)
    gp = F.pad(g, _PAD)
    dx = torch.zeros_like(g)
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                ys = yp[:, dt : dt + t, dh : dh + h, dw : dw + w]
                gs = gp[:, dt : dt + t, dh : dh + h, dw : dw + w]
                dx = dx + torch.where(x == ys, gs, 0.0)
    return dx


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("maxpool3d")
    dims = [ctypes.c_int] * 5
    lib.maxpool3d_s1_fwd_f32.argtypes = [ctypes.c_void_p] * 2 + dims + [ctypes.c_void_p]
    lib.maxpool3d_s1_fwd_f32.restype = ctypes.c_int
    lib.maxpool3d_s1_bwd_f32.argtypes = [ctypes.c_void_p] * 4 + dims + [ctypes.c_void_p]
    lib.maxpool3d_s1_bwd_f32.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dim() != 5:
        raise ValueError(f"maxpool3d_s1: expected (B, T, H, W, C), got {tuple(x.shape)}")
    for t in (x, *others):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"maxpool3d_s1: operands must be on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"maxpool3d_s1: {t.dtype} input; the kernel takes float32")
        if t.shape != x.shape:
            raise ValueError(f"maxpool3d_s1: shape {tuple(t.shape)} != {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError("maxpool3d_s1: operands must be contiguous (B, T, H, W, C)")


def maxpool3d_s1_fwd_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel; counts in ``maxpool3d_s1_fwd_cuda.launches``."""
    _check_cuda_operands(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rc = _lib().maxpool3d_s1_fwd_f32(
        x.data_ptr(), y.data_ptr(), *x.shape,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"maxpool3d_s1_fwd_f32 launch failed with CUDA error {rc}")
    maxpool3d_s1_fwd_cuda.launches += 1
    return y


def maxpool3d_s1_bwd_cuda(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Launch the backward kernel; counts in ``maxpool3d_s1_bwd_cuda.launches``."""
    _check_cuda_operands(x, y, g)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    rc = _lib().maxpool3d_s1_bwd_f32(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), *x.shape,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"maxpool3d_s1_bwd_f32 launch failed with CUDA error {rc}")
    maxpool3d_s1_bwd_cuda.launches += 1
    return dx


maxpool3d_s1_fwd_cuda.launches = 0
maxpool3d_s1_bwd_cuda.launches = 0


def _forward(x):
    if x.is_cuda:
        return maxpool3d_s1_fwd_cuda(x)
    if x.device.type == "cpu":
        return maxpool3d_s1_fwd_plain(x)
    raise RuntimeError(f"maxpool3d_s1: no kernel for device {x.device}")


def _backward(x, y, g):
    if x.is_cuda:
        return maxpool3d_s1_bwd_cuda(x, y, g)
    if x.device.type == "cpu":
        return maxpool3d_s1_bwd_plain(x, y, g)
    raise RuntimeError(f"maxpool3d_s1: no kernel for device {x.device}")


class _MaxPool3dS1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _forward(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _backward(x, y, g.contiguous())


def maxpool3d_s1(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 zero-padded SAME max pool over contiguous
    (B, T, H, W, C); differentiable with the every-tie gather backward."""
    return _MaxPool3dS1.apply(x)
