"""TF-style SAME padding (copy of ``ivf_tpu/ops/padding.py``).

For a spatial dim of size ``s`` with kernel ``k`` and stride ``st``::

    pad_total = max(k - st, 0)            if s % st == 0
                max(k - (s % st), 0)      otherwise
    lo = pad_total // 2 ; hi = pad_total - lo

PyTorch's conv/pool padding is symmetric, so the callers in ``conv.py``
pass the symmetric part to the op and the asymmetric remainder to
``F.pad``.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def same_pad_amounts(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(lo, hi) SAME padding for one dimension."""
    if size % stride == 0:
        total = max(kernel - stride, 0)
    else:
        total = max(kernel - (size % stride), 0)
    lo = total // 2
    return lo, total - lo


def explicit_same_padding(
    sizes: Sequence[int], kernels: Sequence[int], strides: Sequence[int]
) -> Tuple[Tuple[int, int], ...]:
    """Per-dimension (lo, hi) SAME padding for a list of spatial dims."""
    if not len(sizes) == len(kernels) == len(strides):
        raise ValueError(f"rank mismatch: {sizes}, {kernels}, {strides}")
    return tuple(
        same_pad_amounts(s, k, st) for s, k, st in zip(sizes, kernels, strides)
    )
