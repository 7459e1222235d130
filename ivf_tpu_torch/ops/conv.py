"""3D conv / pool primitives with the reference's TF-SAME semantics.

Port of ``ivf_tpu/ops/conv.py``. Activations stay channels-last
``(B, T, H, W, C)`` as in the JAX package. A contiguous NDHWC tensor
permuted with ``permute(0, 4, 1, 2, 3)`` is an NCDHW view in
``channels_last_3d`` memory format, which cuDNN's conv3d and the pooling
ops take without a copy; their outputs permute back the same way.

Conv weights use PyTorch's ``(Cout, Cin, kT, kH, kW)`` layout; the JAX
``(kT, kH, kW, Cin, Cout)`` layout appears only in ``utils/convert.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
