"""Conv / pool primitives with the reference's padding semantics.

Port of ``ivf_tpu/ops/conv.py``: the I3D's 3D ops (TF-SAME) and the
ConvLSTM's 2D ops (torch symmetric padding, VALID pools). Activations stay
channels-last, ``(B, T, H, W, C)`` or ``(B, H, W, C)``, as in the JAX
package. A contiguous NDHWC tensor permuted with ``permute(0, 4, 1, 2,
3)`` is an NCDHW view in ``channels_last_3d`` memory format (NHWC and
``channels_last`` likewise in 2D), which cuDNN's convs and the pooling
ops take without a copy; their outputs permute back the same way.

Conv weights use PyTorch's ``(Cout, Cin, kT, kH, kW)`` / ``(Cout, Cin,
kH, kW)`` layouts; the JAX ``(..., Cin, Cout)`` layouts appear only in
``utils/convert.py``.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.kernels.argmax_pool import argmax_pool
from ivf_tpu_torch.ops.padding import explicit_same_padding


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _f_pad(pads) -> tuple:
    """``F.pad`` argument for an NDHWC tensor: last dim (C) first."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (0, 0, w0, w1, h0, h1, t0, t1)


class _StridedConv3dPolyphase(torch.autograd.Function):
    """VALID ``F.conv3d`` whose input gradient is taken by polyphase
    decomposition. For a stride s, the inputs of each residue class r mod s
    receive the window taps k = r, r + s, ... only, so their gradient is a
    stride-1 forward conv of the output gradient with those taps, flipped
    and with in and out channels swapped. Each class's taps are padded in
    front to the longest class's length, so all s**3 classes run as one
    forward conv with s**3 times the input channels as outputs; each class
    is then copied into its own strided view of the input grid, where no
    two writes meet, so each input gradient is rounded once, in the
    gradient's dtype. This replaces cuDNN's strided backward-data conv for
    the 7x7x7 stride-2 stem (3 input channels): cuDNN's deterministic
    choice there is a direct kernel in float32 (293-296 ms per search step
    at batch 4) and an ``indexed`` implicit GEMM in bfloat16 (208 ms at
    batch 128), where this form takes about 18 ms of convolution and 8 ms
    of copies, all on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``,
    phases ``repair_cost`` and ``bf16_dgrad_timing``)."""

    @staticmethod
    def forward(ctx, xp, weight, bias, strides):
        ctx.save_for_backward(xp, weight)
        ctx.has_bias, ctx.strides = bias is not None, strides
        return F.conv3d(xp, weight, bias, stride=strides)

    @staticmethod
    def backward(ctx, g):
        xp, weight = ctx.saved_tensors
        strides = ctx.strides
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            cin = xp.shape[1]
            taps = [-(-k // s) for k, s in zip(weight.shape[2:], strides)]  # longest class
            phases = list(itertools.product(*(range(s) for s in strides)))
            kernels = []
            for pt, ph, pw in phases:
                sub = weight[:, :, pt::strides[0], ph::strides[1], pw::strides[2]]
                sub = sub.flip(2, 3, 4).transpose(0, 1)
                front = [m - n for m, n in zip(taps, sub.shape[2:])]
                kernels.append(F.pad(sub, (front[2], 0, front[1], 0, front[0], 0)))
            # positions of class 0 (the longest); g padded by (taps - 1)
            # before and as far as class 0 reaches past the last output after
            lengths = [-(-q // s) for q, s in zip(xp.shape[2:], strides)]
            (t0, t1), (h0, h1), (w0, w1) = (
                (m - 1, max(0, length - n)) for m, n, length in zip(taps, g.shape[2:], lengths)
            )
            parts = F.conv3d(F.pad(g, (w0, w1, h0, h1, t0, t1)), torch.cat(kernels))
            dx = torch.empty_like(xp)
            for k, (pt, ph, pw) in enumerate(phases):
                view = dx[:, :, pt::strides[0], ph::strides[1], pw::strides[2]]
                view.copy_(parts[:, k * cin : (k + 1) * cin, : view.shape[2], : view.shape[3], : view.shape[4]])
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(xp, weight.shape, g, stride=strides)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3, 4))
        return dx, dw, db, None


def conv3d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    strides: Sequence[int] = (1, 1, 1),
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3D convolution with TF-SAME (asymmetric) padding.

    x: (B, T, H, W, Cin); weight: (Cout, Cin, kT, kH, kW) -> (B, T', H', W',
    Cout), in the weight's dtype: x is cast to it first, as in the JAX
    package (bfloat16 weights take float32 clips). The symmetric part of
    the padding goes to ``F.conv3d``; only an asymmetric remainder (e.g. the (2, 3) of the 7x7x7 stride-2 stem)
    costs an explicit ``F.pad``. The TPU's space-to-depth stem rewrite
    (``ivf_tpu/ops/conv.py:103``) is the same math and is not ported. A
    strided conv whose input needs a gradient takes it by polyphase
    decomposition (``_StridedConv3dPolyphase``), deterministic and fast.
    """
    x = x.to(weight.dtype)
    pads = explicit_same_padding(x.shape[1:4], weight.shape[2:], strides)
    strides = tuple(strides)
    if strides != (1, 1, 1) and torch.is_grad_enabled() and x.requires_grad:
        xp = _ncdhw(F.pad(x, _f_pad(pads)))
        return _ndhwc(_StridedConv3dPolyphase.apply(xp, weight, bias, strides))
    sym = tuple(min(lo, hi) for lo, hi in pads)
    rest = tuple((lo - s, hi - s) for (lo, hi), s in zip(pads, sym))
    if any(p for pair in rest for p in pair):
        x = F.pad(x, _f_pad(rest))
    y = F.conv3d(_ncdhw(x), weight, bias, stride=tuple(strides), padding=sym)
    return _ndhwc(y)


class _MaxPool3dFixedOrder(torch.autograd.Function):
    """``F.max_pool3d`` (VALID, NCDHW) whose backward adds in a fixed order.

    The forward and its tie rule (each window's first maximum) are
    ``F.max_pool3d``'s own. Its CUDA backward adds every window's gradient
    into the input with atomics, so where windows overlap (window 3,
    stride 2: an input on the shared edge of two windows) the order of the
    adds, and so the float sum, changes from run to run. Here the backward
    walks the window offsets (kt, kh, kw) from the last to the first: for
    each, the windows whose maximum sits at that offset add their gradient
    into the strided view of the input grid they hit, in which no two
    windows share an input. An input so receives its windows' gradients
    in ascending window order, the order of XLA's ``select_and_scatter``
    and of ``F.max_pool3d``'s CPU backward. The forward keeps the
    maximum's window offset as a ``uint8`` plane (the flat index
    ``F.max_pool3d`` returns, decoded once), an eighth of its ``int64``
    indices."""

    @staticmethod
    def forward(ctx, xp, window, strides):
        y, flat = F.max_pool3d(xp, window, strides, return_indices=True)
        _, _, _, hp, wp = xp.shape
        to, ho, wo = y.shape[2:]
        (_, wh, ww), (st, sh, sw) = window, strides
        dev = xp.device
        jt = torch.arange(to, device=dev)[:, None, None] * st
        jh = torch.arange(ho, device=dev)[None, :, None] * sh
        jw = torch.arange(wo, device=dev)[None, None, :] * sw
        # the maximum's (t, h, w) minus its window's corner, as one code
        kt = torch.div(flat, hp * wp, rounding_mode="floor") - jt
        kh = torch.div(flat, wp, rounding_mode="floor") % hp - jh
        kw = flat % wp - jw
        ctx.offset = (kt * (wh * ww) + kh * ww + kw).to(torch.uint8)
        ctx.geometry = (xp.shape, window, strides)
        return y

    @staticmethod
    def backward(ctx, g):
        shape, (wt, wh, ww), (st, sh, sw) = ctx.geometry
        to, ho, wo = g.shape[2:]
        dx = torch.empty(shape, dtype=g.dtype, device=g.device, memory_format=torch.channels_last_3d)
        dx.zero_()
        for kt in reversed(range(wt)):
            for kh in reversed(range(wh)):
                for kw in reversed(range(ww)):
                    view = dx[
                        :, :,
                        kt : kt + (to - 1) * st + 1 : st,
                        kh : kh + (ho - 1) * sh + 1 : sh,
                        kw : kw + (wo - 1) * sw + 1 : sw,
                    ]
                    code = kt * (wh * ww) + kh * ww + kw
                    view.add_(torch.where(ctx.offset == code, g, 0.0))
        return dx, None, None


def max_pool3d_same(
    x: torch.Tensor, window: Sequence[int], strides: Sequence[int], impl: str = "reduce_window"
) -> torch.Tensor:
    """Max pool with the reference's zero-padded SAME. The padding is
    explicit zeros: ``F.max_pool3d``'s own padding would be -inf.

    ``impl='reduce_window'`` (the JAX package's default): ``F.max_pool3d``,
    each window's gradient to its first maximum, added in a fixed order
    (``_MaxPool3dFixedOrder``) so that two runs give the same bits.
    ``impl='argmax'``: a 3x3x3 stride-1 pool in bfloat16 (the branch-3
    pools of the bfloat16 search) goes to the argmax-index pool
    (``ops/kernels/argmax_pool.py``); strided pools and float32 fall
    through to ``F.max_pool3d``, as in ``ivf_tpu/ops/conv.py:194-202``.
    The JAX package's other impls are not ported
    (``ivf_tpu_torch.config.POOL_IMPLS``).
    """
    window, strides = tuple(window), tuple(strides)
    if impl not in ("reduce_window", "argmax"):
        raise NotImplementedError(f"pool impl {impl!r} is not ported (ROADMAP.md)")
    if impl == "argmax" and x.dtype == torch.bfloat16 and strides == (1, 1, 1):
        if window != (3, 3, 3):
            raise NotImplementedError(f"argmax pool: window {window}; the port has 3x3x3")
        return argmax_pool(x)
    pads = explicit_same_padding(x.shape[1:4], window, strides)
    if any(p for pair in pads for p in pair):
        x = F.pad(x, _f_pad(pads))
    xp = _ncdhw(x)
    if torch.is_grad_enabled() and xp.requires_grad:
        return _ndhwc(_MaxPool3dFixedOrder.apply(xp, window, strides))
    return _ndhwc(F.max_pool3d(xp, window, strides))


def avg_pool3d_valid(
    x: torch.Tensor, window: Sequence[int], strides: Sequence[int] = (1, 1, 1)
) -> torch.Tensor:
    """``nn.AvgPool3d(kernel, stride)`` with no padding, on NDHWC: a mean
    over the windows of ``unfold``, whose backward adds each input's
    windows in a fixed order (``F.avg_pool3d``'s CUDA backward uses
    atomics)."""
    for dim, (k, s) in enumerate(zip(window, strides), start=1):
        x = x.unfold(dim, k, s)
    return x.mean(dim=(-3, -2, -1))


def conv2d_same_torch(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: int = 1,
    bias: Optional[torch.Tensor] = None,
    torch_padding: Union[None, int, Tuple[int, int]] = None,
) -> torch.Tensor:
    """2D convolution with torch ``nn.Conv2d(padding=p)`` semantics, the
    ConvLSTM cell's conv: symmetric padding ``(k - 1) // 2`` per axis by
    default (unlike TF-SAME at stride > 1), or ``torch_padding`` as given
    (``(0, 0)`` for Keras 'valid').

    x: (B, H, W, Cin); weight: (Cout, Cin, kH, kW), rectangular allowed
    -> (B, H', W', Cout).
    """
    if torch_padding is None:
        torch_padding = ((weight.shape[2] - 1) // 2, (weight.shape[3] - 1) // 2)
    elif isinstance(torch_padding, int):
        torch_padding = (torch_padding, torch_padding)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=tuple(torch_padding))
    return y.permute(0, 2, 3, 1)


def max_pool2d_valid(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """torch ``nn.MaxPool2d(window)`` on NHWC: stride = window, VALID,
    floor mode."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window)).permute(0, 2, 3, 1)


def avg_pool2d_valid(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Keras ``AveragePooling2D`` / torch ``AvgPool2d(window)`` on NHWC:
    stride = window, VALID."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window)).permute(0, 2, 3, 1)
