"""3x3x3 stride-1 zero-padded SAME max pool with the argmax-index backward,
bfloat16.

Port of ``ivf_tpu/ops/conv.py::_max_pool3d_same_argmax`` (``_monotone_u16``,
``_window_key``, ``_argmax_pool_core``, ``_argmax_bwd``), the branch-3 pool
of the bfloat16 mask search (``pool_impl='argmax'``). On CUDA tensors both
directions run in ``csrc/argmax_pool.cu``; on CPU tensors in the plain
versions below.

The forward maximises a packed word per position: the 16 value bits mapped
to an order-preserving unsigned key, shifted left by 5, or'ed with the
position's window key ``(t % 3) * 9 + (h % 3) * 3 + w % 3`` in padded
coordinates (distinct inside any 3-wide window). That is 21 bits, so an
``int32`` holds it. The maximum's high bits give y, its low 5 bits a
``uint8`` index plane, the only residual of the backward:

    dx[i] = sum over the windows j covering i, in key order (kt, kh, kw),
            of g[j] * (idx[j] == key(i))

Each window sends its whole cotangent to one element, the largest key among
tied maxima: ``F.max_pool3d`` picks the first maximum and the Pallas pool
credits all of them. The three agree where window maxima are unique.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.kernels import build

_PAD = (0, 0, 1, 1, 1, 1, 1, 1)  # zero halo of one voxel on T, H, W
_NBITS = 5  # bits of a window key: 27 positions


def _monotone(bits: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of 16-bit float bits (int32 in [0, 65535]) to
    an unsigned key: positives above negatives, both monotone."""
    return torch.where(bits >> 15 == 0, bits | 0x8000, ~bits & 0xFFFF)


def _from_monotone(u: torch.Tensor) -> torch.Tensor:
    bits = torch.where(u >> 15 == 1, u & 0x7FFF, ~u & 0xFFFF)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)


def _window_key(t: int, h: int, w: int, offset: int, device) -> torch.Tensor:
    """(1, t, h, w, 1) int32 key of each position, its coordinates shifted
    by ``offset`` (1 puts an unpadded input in padded coordinates)."""
    kt, kh, kw = (
        (torch.arange(n, device=device, dtype=torch.int32) + offset) % 3 for n in (t, h, w)
    )
    key = kt[:, None, None] * 9 + kh[None, :, None] * 3 + kw[None, None, :]
    return key[None, ..., None]


def argmax_pool_fwd_plain(x: torch.Tensor):
    """Plain forward: (y, idx) for bfloat16 x (B, T, H, W, C); idx uint8."""
    _, t, h, w, _ = x.shape
    xp = F.pad(x, _PAD)
    bits = xp.view(torch.int16).to(torch.int32) & 0xFFFF
    packed = (_monotone(bits) << _NBITS) | _window_key(t + 2, h + 2, w + 2, 0, x.device)
    best = packed.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1).amax(dim=(-3, -2, -1))
    y = _from_monotone(best >> _NBITS).view(torch.bfloat16)
    return y.contiguous(), (best & 31).to(torch.uint8).contiguous()


def argmax_pool_bwd_plain(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain backward: the covering windows' cotangents whose index equals
    the input's key, added in key order and rounded to g's dtype after
    every add, as the reference does."""
    _, t, h, w, _ = g.shape
    gp = F.pad(g, _PAD)
    ip = F.pad(idx, _PAD, value=255)  # 255 is no key
    key = _window_key(t, h, w, 1, g.device).to(torch.uint8)
    dx = torch.zeros_like(g)
    for kt in range(3):
        for kh in range(3):
            for kw in range(3):
                gs = gp[:, kt : kt + t, kh : kh + h, kw : kw + w]
                sel = ip[:, kt : kt + t, kh : kh + h, kw : kw + w]
                dx = dx + gs * (sel == key).to(g.dtype)
    return dx


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("argmax_pool")
    dims = [ctypes.c_int] * 5
    lib.argmax_pool_fwd_bf16.argtypes = [ctypes.c_void_p] * 3 + dims + [ctypes.c_void_p]
    lib.argmax_pool_fwd_bf16.restype = ctypes.c_int
    lib.argmax_pool_bwd_bf16.argtypes = [ctypes.c_void_p] * 3 + dims + [ctypes.c_void_p]
    lib.argmax_pool_bwd_bf16.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x: torch.Tensor, *others) -> None:
    if x.dim() != 5:
        raise ValueError(f"argmax_pool: expected (B, T, H, W, C), got {tuple(x.shape)}")
    for t, dtype in ((x, torch.bfloat16), *others):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"argmax_pool: operands must be on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"argmax_pool: {t.dtype} operand; the kernel takes {dtype}")
        if t.shape != x.shape:
            raise ValueError(f"argmax_pool: shape {tuple(t.shape)} != {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError("argmax_pool: operands must be contiguous (B, T, H, W, C)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def argmax_pool_fwd_cuda(x: torch.Tensor):
    """Launch the forward kernel on bfloat16 x; returns (y, idx). Counts in
    ``argmax_pool_fwd_cuda.launches``."""
    _check_cuda_operands(x)
    y = torch.empty_like(x)
    idx = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return y, idx
    rc = _lib().argmax_pool_fwd_bf16(x.data_ptr(), y.data_ptr(), idx.data_ptr(), *x.shape, _stream(x))
    if rc != 0:
        raise RuntimeError(f"argmax_pool_fwd_bf16 launch failed with CUDA error {rc}")
    argmax_pool_fwd_cuda.launches += 1
    return y, idx


def argmax_pool_bwd_cuda(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel; counts in ``argmax_pool_bwd_cuda.launches``."""
    _check_cuda_operands(g, (idx, torch.uint8))
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx
    rc = _lib().argmax_pool_bwd_bf16(idx.data_ptr(), g.data_ptr(), dx.data_ptr(), *g.shape, _stream(g))
    if rc != 0:
        raise RuntimeError(f"argmax_pool_bwd_bf16 launch failed with CUDA error {rc}")
    argmax_pool_bwd_cuda.launches += 1
    return dx


argmax_pool_fwd_cuda.launches = 0
argmax_pool_bwd_cuda.launches = 0


def _on_device(t: torch.Tensor, cuda_fn, plain_fn, *args):
    if t.is_cuda:
        return cuda_fn(*args)
    if t.device.type == "cpu":
        return plain_fn(*args)
    raise RuntimeError(f"argmax_pool: no kernel for device {t.device}")


class _ArgmaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, idx = _on_device(x, argmax_pool_fwd_cuda, argmax_pool_fwd_plain, x)
        ctx.save_for_backward(idx)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.contiguous()
        return _on_device(g, argmax_pool_bwd_cuda, argmax_pool_bwd_plain, idx, g)


def argmax_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 zero-padded SAME max pool over contiguous bfloat16
    (B, T, H, W, C); differentiable with the argmax-index backward."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"argmax_pool: {x.dtype} input; the pool takes bfloat16")
    return _ArgmaxPool.apply(x.contiguous())
