"""3x3x3 stride-1 zero-padded SAME max pool, forward and backward.

Port of ``ivf_tpu/ops/pallas/maxpool3d.py::pallas_maxpool3d_s1``, the
Inception branch-3 pool. On CUDA tensors both directions run in
``csrc/maxpool3d.cu``; on CPU tensors in the plain versions below. The
backward is the exact 27-term gather

    dx[t,h,w] = sum over in-range neighbours n of (x[t,h,w] == y[n] ? g[n] : 0)

(a select: an inf or NaN cotangent at an unselected neighbour adds +0),
which credits EVERY tied maximum, where ``F.max_pool3d``'s backward (and
XLA's select_and_scatter) routes each window's gradient to one of them.
The two agree where every window's maximum is unique. On a plateau a
window with k tied maxima hands out k times its gradient; in I3D the
stride-2 trunk pools copy each maximum into neighbouring voxels, so the
branch-3 pools after them meet such plateaus and this backward gives a
larger input gradient than ``F.max_pool3d``'s. It is the Pallas kernel's
rule, kept as it is (tests/test_torch_ops.py holds the two equal).

bfloat16 has its own kernel pair. The forward is exact. The backward
follows the Pallas kernel's bfloat16 arithmetic: the tie test on the exact
float32 upcast, and bfloat16 sums in its order -- per frame the centre
term, then the 8 spatial neighbours; frame t, plus frame t-1, plus frame
t+1 -- rounded after every add (``maxpool3d_s1_bwd_bf16_plain``).

The kernels give the plain versions' bits. They tile the volume as the
argmax pair does (``argmax_pool.py``): a block takes all frames of one
sample, a tile of positions and a chunk of channels, stages each frame of
the tile with its halo in shared memory and walks the frames in order
(the forward scans W, then H, then the last three frames; the backward
keeps three frames of x and its running sums, so each input adds its
terms in order). ``plan`` picks the tile: a 16-byte vector a thread (4
float32 or 8 bfloat16 channels) where C allows it and the pointers are
aligned, else the ragged instance, 1 channel a thread, with the same bits.

While ``torch.export`` traces, the float32 forward is the custom op
``ivf_tpu_torch::maxpool3d_s1_fwd_f32`` (``custom_ops.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.conv import max_pool3d_same
from ivf_tpu_torch.ops.kernels import argmax_pool, build, custom_ops
from ivf_tpu_torch.ops.kernels.argmax_pool import Plan

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


# the Pallas kernel's bfloat16 frame order: the centre, then the others
_FRAME_ORDER = ((0, 0),) + tuple(
    (dh, dw) for dh in (-1, 0, 1) for dw in (-1, 0, 1) if (dh, dw) != (0, 0)
)


def maxpool3d_s1_bwd_bf16_plain(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """Plain bfloat16 backward in the Pallas kernel's order and rounding
    (see the module docstring). A neighbour outside the volume adds +0, as
    the kernel's zero fill does."""
    _, t, h, w, _ = x.shape
    x32 = x.float()
    yp = F.pad(y, _PAD)
    gp = F.pad(g, _PAD)
    frames = []
    for dt in (0, -1, 1):
        acc = None
        for dh, dw in _FRAME_ORDER:
            sl = (slice(None), slice(1 + dt, 1 + dt + t), slice(1 + dh, 1 + dh + h),
                  slice(1 + dw, 1 + dw + w))
            term = torch.where(x32 == yp[sl].float(), gp[sl], 0.0)
            acc = term if acc is None else acc + term
        frames.append(acc)
    centre, prev, nxt = frames
    return centre + prev + nxt


def plan(h: int, w: int, c: int, bf16: bool, vec: bool = True) -> Plan:
    """The tile for frames of h x w positions and c channels: the argmax
    pair's plan (``argmax_pool.plan``), whose staging these kernels share,
    with 16-byte vectors of 8 bfloat16 or 4 float32 channels where C allows
    and ``vec`` (aligned operands), else 1 channel a thread."""
    return argmax_pool.plan(h, w, c, vec, wide=8 if bf16 else 4)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the four entry points of a build of
    ``csrc/maxpool3d.cu`` (``chip_smoke.py --pool-sweep`` binds variant
    builds too)."""
    dims = [ctypes.c_int] * 10  # b, t, h, w, c, then the plan
    for dtype in ("f32", "bf16"):
        fwd = getattr(lib, f"maxpool3d_s1_fwd_{dtype}")
        fwd.argtypes = [ctypes.c_void_p] * 2 + dims + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"maxpool3d_s1_bwd_{dtype}")
        bwd.argtypes = [ctypes.c_void_p] * 4 + dims + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.library("maxpool3d"))


def _check_cuda_operands(x: torch.Tensor, *others: torch.Tensor, dtype=torch.float32) -> None:
    if x.dim() != 5:
        raise ValueError(f"maxpool3d_s1: expected (B, T, H, W, C), got {tuple(x.shape)}")
    for t in (x, *others):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"maxpool3d_s1: operands must be on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"maxpool3d_s1: {t.dtype} input; the kernel takes {dtype}")
        if t.shape != x.shape:
            raise ValueError(f"maxpool3d_s1: shape {tuple(t.shape)} != {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError("maxpool3d_s1: operands must be contiguous (B, T, H, W, C)")


def _launch(symbol: str, dtype, operands, tile: Plan = None) -> torch.Tensor:
    """Check the operands, launch ``symbol`` on them into a new tensor
    shaped like the first under ``tile`` (default: the plan, 16-byte
    vectors where every pointer allows them) and return it; raises on a
    shape, tile or launch the kernel refuses."""
    _check_cuda_operands(*operands, dtype=dtype)
    out = torch.empty_like(operands[0])
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in (*operands, out)]
    if tile is None:
        vec = all(p % 16 == 0 for p in ptrs)
        tile = plan(*out.shape[2:], bf16=dtype == torch.bfloat16, vec=vec)
    rc = getattr(_lib(), symbol)(*ptrs, *out.shape, *tile, build.stream(out))
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc} ({Plan(*tile)})")
    return out


def maxpool3d_s1_fwd_cuda(x: torch.Tensor, tile: Plan = None) -> torch.Tensor:
    """Launch the forward kernel; ``tile`` overrides the plan (the tests
    force each instance). Counts in ``maxpool3d_s1_fwd_cuda.launches``."""
    y = _launch("maxpool3d_s1_fwd_f32", torch.float32, (x,), tile)
    maxpool3d_s1_fwd_cuda.launches += 1
    return y


def maxpool3d_s1_bwd_cuda(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, tile: Plan = None
) -> torch.Tensor:
    """Launch the backward kernel; ``tile`` as for the forward. Counts in
    ``maxpool3d_s1_bwd_cuda.launches``."""
    dx = _launch("maxpool3d_s1_bwd_f32", torch.float32, (x, y, g), tile)
    maxpool3d_s1_bwd_cuda.launches += 1
    return dx


def maxpool3d_s1_fwd_bf16_cuda(x: torch.Tensor, tile: Plan = None) -> torch.Tensor:
    """Launch the bfloat16 forward kernel; counts in
    ``maxpool3d_s1_fwd_bf16_cuda.launches``."""
    y = _launch("maxpool3d_s1_fwd_bf16", torch.bfloat16, (x,), tile)
    maxpool3d_s1_fwd_bf16_cuda.launches += 1
    return y


def maxpool3d_s1_bwd_bf16_cuda(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, tile: Plan = None
) -> torch.Tensor:
    """Launch the bfloat16 backward kernel; counts in
    ``maxpool3d_s1_bwd_bf16_cuda.launches``."""
    dx = _launch("maxpool3d_s1_bwd_bf16", torch.bfloat16, (x, y, g), tile)
    maxpool3d_s1_bwd_bf16_cuda.launches += 1
    return dx


maxpool3d_s1_fwd_cuda.launches = 0
maxpool3d_s1_bwd_cuda.launches = 0
maxpool3d_s1_fwd_bf16_cuda.launches = 0
maxpool3d_s1_bwd_bf16_cuda.launches = 0


# the float32 forward as the custom op ivf_tpu_torch::maxpool3d_s1_fwd_f32 (custom_ops.py)
maxpool3d_s1_fwd_f32_op = custom_ops.define(
    "maxpool3d_s1_fwd_f32", maxpool3d_s1_fwd_plain, maxpool3d_s1_fwd_cuda, torch.empty_like
)


def _forward(x):
    if custom_ops.through_op("maxpool3d_s1", x):
        return maxpool3d_s1_fwd_f32_op(x)
    if x.is_cuda:
        bf16 = x.dtype == torch.bfloat16
        return (maxpool3d_s1_fwd_bf16_cuda if bf16 else maxpool3d_s1_fwd_cuda)(x)
    if x.device.type == "cpu":
        return maxpool3d_s1_fwd_plain(x)
    raise RuntimeError(f"maxpool3d_s1: no kernel for device {x.device}")


def _backward(x, y, g):
    bf16 = x.dtype == torch.bfloat16
    if x.is_cuda:
        return (maxpool3d_s1_bwd_bf16_cuda if bf16 else maxpool3d_s1_bwd_cuda)(x, y, g)
    if x.device.type == "cpu":
        return (maxpool3d_s1_bwd_bf16_plain if bf16 else maxpool3d_s1_bwd_plain)(x, y, g)
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
    (B, T, H, W, C), float32 or bfloat16; differentiable with the every-tie
    gather backward."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"maxpool3d_s1: {x.dtype} input; the pool takes float32 or bfloat16")
    return _MaxPool3dS1.apply(x)
