"""Train state (port of ``ivf_tpu/train/state.py``): the module, which holds
the float32 master parameters and the BatchNorm running statistics, the
optimizer and its state, the step count and the run's seed.

The JAX package draws each step's dropout masks from ``jax.random.fold_in
(rng, state.step)`` (``ivf_tpu/train/loop.py:91``); the port draws them
from a ``torch.Generator`` seeded from (seed, step) (``step_generator``),
so a run resumed from a checkpoint draws the masks of an uninterrupted
one. The draws themselves are not JAX's.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from ivf_tpu_torch.train.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: Optimizer
    opt_state: OptState
    step: int = 0
    seed: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """One optimizer step in place; the step count advances."""
        self.opt_state = self.tx.apply(self.params(), grads, self.opt_state)
        self.step += 1
        return self


def create_train_state(
    model: nn.Module, tx: Optimizer, seed: int = 0, init_variables: Optional[Mapping[str, torch.Tensor]] = None
) -> TrainState:
    """Wrap ``model`` (its initialized weights, or ``init_variables``, a
    state dict) with a fresh optimizer state at step 0; every parameter
    trains."""
    if init_variables is not None:
        model.load_state_dict(init_variables)
    model.requires_grad_(True)
    return TrainState(model, tx, tx.init(dict(model.named_parameters())), 0, seed)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s dropout draws on ``device``, seeded
    by the CRC-32 of the step with ``seed`` as the CRC's initial value (32
    bits: the CPU generator keeps no more of its seed)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(int(step).to_bytes(8, "little"), seed & 0xFFFFFFFF))
    return gen
