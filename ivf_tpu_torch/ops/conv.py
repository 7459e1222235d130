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

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.padding import explicit_same_padding


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _f_pad(pads) -> tuple:
    """``F.pad`` argument for an NDHWC tensor: last dim (C) first."""
    (t0, t1), (h0, h1), (w0, w1) = pads
    return (0, 0, w0, w1, h0, h1, t0, t1)


def conv3d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    strides: Sequence[int] = (1, 1, 1),
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3D convolution with TF-SAME (asymmetric) padding.

    x: (B, T, H, W, Cin); weight: (Cout, Cin, kT, kH, kW) -> (B, T', H', W',
    Cout). The symmetric part of the padding goes to ``F.conv3d``; only an
    asymmetric remainder (e.g. the (2, 3) of the 7x7x7 stride-2 stem)
    costs an explicit ``F.pad``. The TPU's space-to-depth stem rewrite
    (``ivf_tpu/ops/conv.py:103``) is the same math and is not ported.
    """
    pads = explicit_same_padding(x.shape[1:4], weight.shape[2:], strides)
    sym = tuple(min(lo, hi) for lo, hi in pads)
    rest = tuple((lo - s, hi - s) for (lo, hi), s in zip(pads, sym))
    if any(p for pair in rest for p in pair):
        x = F.pad(x, _f_pad(rest))
    y = F.conv3d(_ncdhw(x), weight, bias, stride=tuple(strides), padding=sym)
    return _ndhwc(y)


def max_pool3d_same(
    x: torch.Tensor, window: Sequence[int], strides: Sequence[int]
) -> torch.Tensor:
    """Max pool with the reference's zero-padded SAME (``impl='reduce_window'``
    of the JAX package). The padding is explicit zeros: ``F.max_pool3d``'s
    own padding would be -inf."""
    pads = explicit_same_padding(x.shape[1:4], window, strides)
    if any(p for pair in pads for p in pair):
        x = F.pad(x, _f_pad(pads))
    y = F.max_pool3d(_ncdhw(x), tuple(window), tuple(strides))
    return _ndhwc(y)


def avg_pool3d_valid(
    x: torch.Tensor, window: Sequence[int], strides: Sequence[int] = (1, 1, 1)
) -> torch.Tensor:
    """``nn.AvgPool3d(kernel, stride)`` with no padding, on NDHWC."""
    return _ndhwc(F.avg_pool3d(_ncdhw(x), tuple(window), tuple(strides)))


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
