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
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ivf_tpu_torch.config import POOL_IMPLS
from ivf_tpu_torch.ops.kernels.argmax_pool import _from_monotone, _monotone, _window_key, argmax_pool
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
    gradient's dtype. It now serves the plain stem only (``stem_s2d`` off,
    or a shape the s2d guard refuses; ``conv3d_stem_s2d`` needs no
    strided gradient). It replaces cuDNN's strided backward-data conv for
    the 7x7x7 stride-2 stem (3 input channels): cuDNN's deterministic
    choice there is a direct kernel in float32 (293-296 ms per search step
    at batch 4) and an ``indexed`` implicit GEMM in bfloat16 (208 ms at
    batch 128), where this form takes 8.5 ms in float32 at batch 4 and
    30.7 ms in bfloat16 at 128, all on an NVIDIA H100 80GB HBM3 at 700 W
    (``chip_smoke.py``: phase ``stem_s2d_check``, form ``plain``; cuDNN's
    strided dgrad in its ``repair_cost`` phase while the plain stem was
    the default)."""

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


class _Stride1Conv3dFwdGrad(torch.autograd.Function):
    """Stride-1 ``F.conv3d`` with symmetric padding ``p`` whose input
    gradient is taken as the forward conv it equals: the output gradient,
    padded by ``k - 1 - p``, convolved with the kernel flipped and its in
    and out channels swapped. Each input gradient is one sum, rounded once
    in the gradient's dtype, as cuDNN's backward-data conv would give it.
    The s2d stem takes it because cuDNN's deterministic backward-data
    choice for its shape (24 input channels, 4x4x4) in float32 is a direct
    kernel, ``dgrad_alg1_nd_float_engine``: 15.7 ms at batch 4, where the
    forward takes 4.1 ms (an NVIDIA H100 80GB HBM3 at 700 W,
    ``chip_smoke.py`` phase ``stem_s2d_check``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.has_bias, ctx.padding = bias is not None, padding
        return F.conv3d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            flipped = weight.flip(2, 3, 4).transpose(0, 1)
            dx = F.conv3d(g, flipped, padding=tuple(k - 1 - ctx.padding for k in weight.shape[2:]))
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(x, weight.shape, g, padding=ctx.padding)
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
    costs an explicit ``F.pad``. A strided conv whose input needs a
    gradient takes it by polyphase decomposition
    (``_StridedConv3dPolyphase``), deterministic and fast. The I3D stem
    takes ``conv3d_stem_s2d`` instead where its guard holds
    (``models/layers.py::Unit3D``).
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


def conv3d_stem_s2d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The I3D stem (7x7x7, stride 2, TF-SAME) as a space-to-depth conv,
    the counterpart of ``ivf_tpu/ops/conv.py:103-147``: the same sum of
    products, in another order.

    On even T, H, W the SAME padding of a 7-tap stride-2 window is (2, 3).
    Zero-padding the kernel to 8 taps at the high side makes every output's
    window a whole number of 2x2x2 input blocks, so regrouping each block
    into channels, in (2t, 2h, 2w, C) order in the input and the kernel
    alike, turns the stem into a 4x4x4 stride-1 conv over 8 * Cin channels
    with padding (1, 2) on each axis. The regrouped input is written once,
    into a zeroed buffer one block longer on each axis (the high side's
    second pad), in the weight's dtype; the conv adds the symmetric
    (1, 1). Its input gradient is a stride-1 forward conv
    (``_Stride1Conv3dFwdGrad``) and the regroup's gather: no polyphase
    form, no scatter copies. The weight
    (the BN-folded one) is regrouped at every call, so state dicts keep
    the 7x7x7 layout.

    x: (B, T, H, W, Cin), T, H, W even; weight: (Cout, Cin, 7, 7, 7) ->
    (B, T/2, H/2, W/2, Cout) in the weight's dtype.
    """
    cout, cin = weight.shape[:2]
    b, t, h, w, _ = x.shape
    if tuple(weight.shape[2:]) != (7, 7, 7) or t % 2 or h % 2 or w % 2:
        raise ValueError(f"s2d stem: kernel {tuple(weight.shape[2:])} on {(t, h, w)}")
    k8 = F.pad(weight, (0, 1, 0, 1, 0, 1)).reshape(cout, cin, 4, 2, 4, 2, 4, 2)
    k_s2d = k8.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(cout, 8 * cin, 4, 4, 4)
    blocks = x.reshape(b, t // 2, 2, h // 2, 2, w // 2, 2, cin).permute(0, 1, 3, 5, 2, 4, 6, 7)
    xb = x.new_zeros((b, t // 2 + 1, h // 2 + 1, w // 2 + 1, 8 * cin), dtype=weight.dtype)
    xb[:, :-1, :-1, :-1].unflatten(-1, (2, 2, 2, cin)).copy_(blocks)
    # in bfloat16 JAX rounds the conv before it adds the bias, and so does
    # this form; float32 keeps the bias inside the conv
    split = bias is not None and weight.dtype == torch.bfloat16
    y = _ndhwc(_Stride1Conv3dFwdGrad.apply(_ncdhw(xb), k_s2d, None if split else bias, 1))
    return y + bias if split else y


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


def _shift_max(xp: torch.Tensor, window, strides) -> torch.Tensor:
    """The pool of a zero-padded NDHWC ``xp`` as the separable chain of
    ``torch.maximum`` over shifted strided slices, T, then H, then W, each
    axis folded from its first offset on (``ivf_tpu/ops/conv.py:210-222``).
    Its backward is autograd's: a tie of ``torch.maximum`` gives half the
    gradient to each side, as ``lax.max``'s balanced rule does."""
    for axis, (w, s) in enumerate(zip(window, strides), start=1):
        n_out = (xp.shape[axis] - w) // s + 1
        acc = None
        for k in range(w):
            sl = xp[(slice(None),) * axis + (slice(k, k + (n_out - 1) * s + 1, s),)]
            acc = sl if acc is None else torch.maximum(acc, sl)
        xp = acc
    return xp


class _MaxPool3dEqBwd(torch.autograd.Function):
    """Stride-1 SAME pool (``F.max_pool3d`` over the zero-padded input)
    with the equality-stencil backward of ``ivf_tpu/ops/conv.py:237-282``:
    ``dx[i] = sum over window offsets o of g[i + o] * (x[i] == y[i + o])``,
    every tied maximum credited, the offsets added in (kt, kh, kw) order
    into a ``g.dtype`` sum, so in bfloat16 every add rounds to bfloat16.
    ``csrc/maxpool3d.cu``'s every-tie backward adds the centre frame
    first and rounds once, so it would not give these bits."""

    @staticmethod
    def forward(ctx, x, window):
        pads = explicit_same_padding(x.shape[1:4], window, (1, 1, 1))
        y = _ndhwc(F.max_pool3d(_ncdhw(F.pad(x, _f_pad(pads))), window, 1)).contiguous()
        ctx.save_for_backward(x, y)
        ctx.window, ctx.pads = window, pads
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # output j feeds input i when o = j - i is in [lo - w + 1, lo]; g is
        # padded with zeros and y with +inf (never equal) so one slice per
        # offset covers it
        cfg = tuple((w - 1 - lo, w - 1 - hi) for (lo, hi), w in zip(ctx.pads, ctx.window))
        gp = F.pad(g, _f_pad(cfg))
        yp = F.pad(y, _f_pad(cfg), value=float("inf"))
        _, nt, nh, nw, _ = x.shape
        dx = torch.zeros(x.shape, dtype=g.dtype, device=g.device)
        for kt, kh, kw in itertools.product(*(range(w) for w in ctx.window)):
            gs = gp[:, kt : kt + nt, kh : kh + nh, kw : kw + nw]
            ys = yp[:, kt : kt + nt, kh : kh + nh, kw : kw + nw]
            dx = dx + gs * (x == ys).to(g.dtype)
        return dx.to(x.dtype), None


class _ArgmaxPoolStrided(torch.autograd.Function):
    """Strided SAME pool of a 16-bit float input with the argmax-index
    backward (``ivf_tpu/ops/conv.py:387-445``, ``pool_impl='argmax_full'``
    on the trunk pools), in plain PyTorch on every device: the JAX package
    computes it in XLA, outside any Pallas kernel. The forward maximises
    the packed word of ``ops/kernels/argmax_pool.py`` (the value's
    order-preserving 16 bits above the position's window key) over the
    strided windows; the backward sends each window's cotangent to the
    position its index names, offset by offset in (kt, kh, kw) order, each
    offset's contributions added into the strided view of the padded input
    grid they hit (the dilated-pad scatter of the JAX VJP)."""

    @staticmethod
    def forward(ctx, x, window, strides):
        pads = explicit_same_padding(x.shape[1:4], window, strides)
        xp = F.pad(x, _f_pad(pads))
        nbits = (math.prod(window) - 1).bit_length()
        bits = xp.view(torch.int16).to(torch.int32) & 0xFFFF
        packed = (_monotone(bits) << nbits) | _window_key(*xp.shape[1:4], 0, x.device, window)
        for axis, (w, s) in enumerate(zip(window, strides), start=1):
            packed = packed.unfold(axis, w, s)
        best = packed.amax(dim=(-3, -2, -1))
        ctx.save_for_backward((best & ((1 << nbits) - 1)).to(torch.uint8))
        ctx.geometry = (x.shape, window, strides, pads)
        return _from_monotone(best >> nbits).view(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, (wt, wh, ww), strides, pads = ctx.geometry
        b, to, ho, wo, c = g.shape
        padded = [n + lo + hi for n, (lo, hi) in zip(shape[1:4], pads)]
        dxp = torch.zeros((b, *padded, c), dtype=g.dtype, device=g.device)
        it, ih, iw = (
            torch.arange(n, device=g.device, dtype=torch.int32) * s for n, s in zip((to, ho, wo), strides)
        )
        for kt, kh, kw in itertools.product(range(wt), range(wh), range(ww)):
            # the key of padded input position j * s + k, as a function of
            # the output index j: the forward's window key
            key = (
                ((it + kt) % wt)[:, None, None] * (wh * ww)
                + ((ih + kh) % wh)[None, :, None] * ww
                + ((iw + kw) % ww)[None, None, :]
            )[None, ..., None]
            view = dxp[
                :,
                kt : kt + (to - 1) * strides[0] + 1 : strides[0],
                kh : kh + (ho - 1) * strides[1] + 1 : strides[1],
                kw : kw + (wo - 1) * strides[2] + 1 : strides[2],
            ]
            view.add_(g * (idx == key).to(g.dtype))
        (t0, _), (h0, _), (w0, _) = pads
        return dxp[:, t0 : t0 + shape[1], h0 : h0 + shape[2], w0 : w0 + shape[3]], None, None


def max_pool3d_same(
    x: torch.Tensor, window: Sequence[int], strides: Sequence[int], impl: str = "reduce_window"
) -> torch.Tensor:
    """Max pool with the reference's zero-padded SAME. The padding is
    explicit zeros: ``F.max_pool3d``'s own padding would be -inf.

    Every impl of ``ivf_tpu/ops/conv.py:150-222``, dispatched rule for rule;
    the forward values are the same, the backwards differ at ties:

    - ``'reduce_window'`` (the default): ``F.max_pool3d``, each window's
      gradient to its first maximum, added in a fixed order
      (``_MaxPool3dFixedOrder``) so that two runs give the same bits.
    - ``'shift'``: the separable ``torch.maximum`` chain (``_shift_max``);
      ties split the gradient 0.5 / 0.5 at each pairwise max.
    - ``'eqbwd'``: on stride-1 pools, the equality-stencil backward
      (``_MaxPool3dEqBwd``), every tie credited; strided pools fall
      through to ``'reduce_window'``.
    - ``'argmax'``: in bfloat16, a 3x3x3 stride-1 pool (the branch-3 pools)
      goes to the argmax-index pool (``ops/kernels/argmax_pool.py``, a
      CUDA kernel on the card); each window's gradient to its largest-key
      maximum. Strided pools and float32 fall through to
      ``'reduce_window'``.
    - ``'argmax_full'``: ``'argmax'``, and in bfloat16 the strided pools
      too (``_ArgmaxPoolStrided``).
    - ``'argmax_shift'``: ``'argmax'``, with the ``'shift'`` chain on what
      falls through (strided pools, and every pool in float32).

    So in float32 ``'argmax_full'`` is ``'reduce_window'`` and
    ``'argmax_shift'`` is ``'shift'``, bit for bit. An unknown name raises
    ``NotImplementedError``.
    """
    window, strides = tuple(window), tuple(strides)
    if impl not in POOL_IMPLS:
        raise NotImplementedError(f"pool impl {impl!r}: one of {POOL_IMPLS}")
    if impl == "eqbwd" and strides == (1, 1, 1):
        return _MaxPool3dEqBwd.apply(x, window)
    if impl.startswith("argmax") and x.dtype == torch.bfloat16:
        if strides == (1, 1, 1):
            if window != (3, 3, 3):
                raise NotImplementedError(f"argmax pool: window {window}; the port has 3x3x3")
            return argmax_pool(x)
        if impl == "argmax_full":
            return _ArgmaxPoolStrided.apply(x, window, strides)
    pads = explicit_same_padding(x.shape[1:4], window, strides)
    if any(p for pair in pads for p in pair):
        x = F.pad(x, _f_pad(pads))
    if impl in ("shift", "argmax_shift"):
        return _shift_max(x, window, strides)
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
    -> (B, H', W', Cout). The input is cast to the weight's dtype and the
    output is in it (``ivf_tpu/ops/conv.py:91-101``).
    """
    if torch_padding is None:
        torch_padding = ((weight.shape[2] - 1) // 2, (weight.shape[3] - 1) // 2)
    elif isinstance(torch_padding, int):
        torch_padding = (torch_padding, torch_padding)
    x = x.to(weight.dtype).permute(0, 3, 1, 2)
    # in bfloat16 JAX rounds the conv before it adds the bias, and so does
    # the port; float32 keeps the bias inside the conv
    split = bias is not None and weight.dtype == torch.bfloat16
    y = F.conv2d(x, weight, None if split else bias, stride=stride, padding=tuple(torch_padding))
    if split:
        y = y + bias[:, None, None]
    return y.permute(0, 2, 3, 1)


def max_pool2d_valid(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """torch ``nn.MaxPool2d(window)`` on NHWC: stride = window, VALID,
    floor mode."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window)).permute(0, 2, 3, 1)


def avg_pool2d_valid(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Keras ``AveragePooling2D`` / torch ``AvgPool2d(window)`` on NHWC:
    stride = window, VALID."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window)).permute(0, 2, 3, 1)
