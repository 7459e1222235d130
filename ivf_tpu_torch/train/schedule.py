"""LR schedules (copy of ``ivf_tpu/train/schedule.py``): both reference
halves' plateau logic, on the host.

``ReduceLROnPlateau`` mirrors torch's scheduler as the reference configures
it (``train_i3d_smth.py:139-140``: mode 'min', factor 0.5, patience 2,
relative threshold 1e-4). ``PatienceHalving`` mirrors the TF half's manual
halving (``train_kth.py:294-312``: halve when val accuracy has not improved
in ``patience`` epochs, stop halving below ``lr_end``).
"""

from __future__ import annotations


class ReduceLROnPlateau:
    monitor = "loss"

    def __init__(
        self,
        lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) lr."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


class PatienceHalving:
    """TF-half manual halving (``train_kth.py:294-312``): an epoch counts as
    no improvement when val accuracy gains < 1e-4 over the best; after
    ``patience`` such epochs the lr is halved unless already below
    ``2 * lr_end``, and the patience counter resets either way.

    ``monitor`` tells ``fit`` to feed val accuracy (0..1), not val loss.
    """

    monitor = "accuracy"

    def __init__(
        self,
        lr: float,
        patience: int = 5,
        lr_end: float = 1e-8,
        threshold: float = 1e-4,
    ):
        self.lr = lr
        self.patience = patience
        self.lr_end = lr_end
        self.threshold = threshold
        self.best = -float("inf")
        self.bad = 0

    def step(self, metric: float) -> float:
        if (metric - self.best) < self.threshold:
            self.bad += 1
            if self.bad == self.patience:
                if self.lr >= 2.0 * self.lr_end:
                    self.lr *= 0.5
                self.bad = 0
        else:
            self.best = metric
            self.bad = 0
        return self.lr
