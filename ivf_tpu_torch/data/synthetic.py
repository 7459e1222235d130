"""Synthetic in-memory clip dataset (copy of ``ivf_tpu/data/synthetic.py``).

The indexable uint8-clip stub that ``api.find_masks`` consumes:
``__getitem__ -> (clip_uint8 (T, H, W, 3), label, clip_id)``. The same seed
gives the same clips as the JAX package's copy (both draw with numpy).
"""

from __future__ import annotations

import numpy as np


class SyntheticClips:
    """Indexable uint8 clip dataset; labels round-robin over ``num_classes``.

    ``lazy=True`` (default) stores ONE base clip and derives per-index
    variants by a small offset (O(1) memory for any ``n``); ``lazy=False``
    materializes independent random clips.
    """

    def __init__(
        self,
        n: int,
        t: int = 16,
        hw: int = 224,
        num_classes: int = 174,
        seed: int = 0,
        lazy: bool = True,
    ):
        rng = np.random.RandomState(seed)
        self.n = int(n)
        self.num_classes = int(num_classes)
        self.lazy = lazy
        if lazy:
            self.base = rng.randint(0, 235, (t, hw, hw, 3)).astype(np.uint8)
        else:
            self.clips = rng.randint(0, 255, (n, t, hw, hw, 3)).astype(np.uint8)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if self.lazy:
            clip = self.base + np.uint8(i % 19)
        else:
            clip = self.clips[i]
        return clip, i % self.num_classes, f"clip{i}"
