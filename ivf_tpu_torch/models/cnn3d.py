"""Plain 5-block 3D CNN, the TF half's ``--model cnn_3d`` (port of
``ivf_tpu/models/cnn3d.py``).

Block for block as the JAX model: conv3d (SAME) -> BN -> ReLU units
(``layers.Unit3D``, BN eps 1e-3, momentum 0.01, folded in eval mode) with
a stride-2 spatial downsampling per block, a temporal SAME average pool
(window 3, stride 2) in block 2 divided by the count of real frames in
each window, dropout after blocks 1-4 in training only (the JAX model's
gate; the reference's unconditional dropout is a catalogued defect), the
channel-mean "GAP" of the reference (a mean over the channel axis,
``cnn_3d.py:78``), flatten, dense.

flax infers the dense layer's width from its first input; ``nn.Linear``
needs it when built, so the clip geometry is given: ``input_size`` (H, W)
and ``clip_len`` T. Clips ``(B, T, H, W, C)`` -> logits ``(B,
num_classes)``; the flatten runs in (T, H, W) order, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ivf_tpu_torch.models.layers import Conv3dParams, Dropout, TorchBatchNorm, Unit3D, variance_scaling_
from ivf_tpu_torch.ops.padding import same_pad_amounts
from ivf_tpu_torch.precision import reference_numerics_fn

# (name, out channels, kernel, stride), in order; a dropout follows the
# last unit of blocks 1-4 and the temporal pool the last unit of block 2
_UNITS = (
    ("block1_conv1", 32, (3, 5, 5), (1, 2, 2)),
    ("block2_conv1", 64, (3, 3, 3), (1, 1, 1)),
    ("block2_conv2", 128, (3, 3, 3), (1, 2, 2)),
    ("block3_conv1", 128, (3, 3, 3), (1, 1, 1)),
    ("block3_conv2", 128, (3, 3, 3), (1, 1, 1)),
    ("block3_conv3", 256, (3, 3, 3), (1, 2, 2)),
    ("block4_conv1", 256, (3, 3, 3), (1, 1, 1)),
    ("block4_conv2", 256, (3, 3, 3), (1, 1, 1)),
    ("block4_conv3", 512, (3, 3, 3), (1, 2, 2)),
    ("block5_conv1", 512, (3, 3, 3), (1, 1, 1)),
    ("block5_conv2", 512, (3, 3, 3), (1, 2, 2)),
)
_DROP_AFTER = {"block1_conv1": 1, "block2_conv2": 2, "block3_conv3": 3, "block4_conv3": 4}
POOL_T = (3, 2)  # the temporal average pool's window and stride


def temporal_avg_pool_same(x: torch.Tensor, window: int = POOL_T[0], stride: int = POOL_T[1]) -> torch.Tensor:
    """SAME average pool over T of a ``(B, T, H, W, C)`` tensor: the sum of
    each window's real frames divided by their count
    (``ivf_tpu/models/cnn3d.py:45-61``). The window offsets are added in
    order, ``x[k=0] + x[k=1] + x[k=2]``, as strided slices of the
    zero-padded input, so the backward is slicing and adds: deterministic
    on the card, where ``F.avg_pool3d``'s CUDA backward is not."""
    t = x.shape[1]
    lo, hi = same_pad_amounts(t, window, stride)
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, lo, hi))
    n_out = (t + lo + hi - window) // stride + 1
    acc = None
    for k in range(window):
        sl = xp[:, k : k + (n_out - 1) * stride + 1 : stride]
        acc = sl if acc is None else acc + sl
    counts = [
        sum(1 for k in range(window) if 0 <= j * stride + k - lo < t) for j in range(n_out)
    ]
    div = torch.tensor(counts, dtype=x.dtype, device=x.device).view(1, n_out, 1, 1, 1)
    return acc / div


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


class CNN3D(nn.Module):
    def __init__(
        self,
        num_classes: int = 6,
        dropout_rate: float = 0.5,
        in_channels: int = 3,
        *,
        input_size: Tuple[int, int],
        clip_len: int,
    ):
        super().__init__()
        self.num_classes = num_classes
        c = in_channels
        t, h, w = clip_len, *input_size
        for name, out, kernel, stride in _UNITS:
            setattr(self, name, Unit3D(c, out, kernel, stride))
            c = out
            t, h, w = (_same_out(n, s) for n, s in zip((t, h, w), stride))
            if name == "block2_conv2":
                t = _same_out(t, POOL_T[1])
        self.drops = nn.ModuleList(Dropout(dropout_rate) for _ in _DROP_AFTER)
        self.fc = nn.Linear(t * h * w, num_classes)
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init as the JAX model's: conv kernels ``variance_scaling(2.0,
        'fan_in', 'truncated_normal')``, the dense layer LeCun normal
        (truncated), zero biases, identity BatchNorm. Draws on the CPU
        generator."""
        for mod in self.modules():
            if isinstance(mod, Conv3dParams):
                variance_scaling_(mod.weight, 2.0, generator)
            elif isinstance(mod, nn.Linear):
                variance_scaling_(mod.weight, 1.0, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, TorchBatchNorm):
                mod.reset_parameters()

    @reference_numerics_fn
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, C) -> logits (B, num_classes)."""
        for name, *_ in _UNITS:
            x = getattr(self, name)(x)
            if name == "block2_conv2":
                x = temporal_avg_pool_same(x)
            if name in _DROP_AFTER:
                x = self.drops[_DROP_AFTER[name] - 1](x)
        x = x.mean(dim=-1)  # channel mean, faithful to cnn_3d.py:78
        x = x.reshape(x.shape[0], -1)
        dtype = torch.promote_types(x.dtype, self.fc.weight.dtype)
        return F.linear(x.to(dtype), self.fc.weight.to(dtype), self.fc.bias.to(dtype))

