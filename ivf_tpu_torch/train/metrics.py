"""Metrics (copy of ``ivf_tpu/train/metrics.py``): top-k precision and
running meters.

``topk_accuracy`` mirrors ``utils.accuracy`` of the reference: the
percentage of samples whose target is among the top-k scores, one per
requested k.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def topk_accuracy(
    output: torch.Tensor, target: torch.Tensor, topk: Sequence[int] = (1,)
) -> Tuple[torch.Tensor, ...]:
    """output: (B, num_classes) scores; target: (B,) int labels. Returns
    0-dim float32 percentages (0..100) on the scores' device, one per k.
    The ranking is a stable descending sort, so equal scores rank by class
    index as ``jax.lax.top_k`` ranks them."""
    n_classes = output.shape[-1]
    maxk = min(max(topk), n_classes)  # clamp for few-class heads (KTH: 6)
    pred = torch.sort(output, dim=-1, descending=True, stable=True).indices[:, :maxk]
    correct = pred == target[:, None].long()
    batch = output.shape[0]
    return tuple(
        correct[:, : min(k, n_classes)].sum().float() * (100.0 / batch) for k in topk
    )


class AverageMeter:
    """Running average (reference ``utils.py:241-256``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
