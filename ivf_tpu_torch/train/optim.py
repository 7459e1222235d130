"""Optimizers (port of ``ivf_tpu/train/optim.py``): the union of both
reference halves' optimizers, as plain tensor updates with the arithmetic
of the JAX package's optax chains (``ivf_tpu/train/optim.py:40-74``).

  * ``sgd``: coupled L2 (``g + wd * p``), then momentum ``t = g + m * t``
    (no momentum when ``momentum`` is 0), then ``-lr``;
  * ``adam``: coupled L2, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias
    corrected by the step count), then ``-lr``;
  * ``adadelta``: optax's Adadelta (rho 0.9, eps 1e-6), then ``-lr``;
  * ``momentum`` / ``momentum_decoupled``: momentum, then ``-lr``, then the
    decoupled decay ``- wd * p``, which is not scaled by the lr (the TF
    half's ``MomentumW``).

Each update is ``p <- p + u``, in place, over every parameter at once
(``torch._foreach_*``), each op rounded once as optax's are (no fused
multiply-adds); the bias corrections are float32 scalars. The learning
rate lives in the optimizer state as a float32 value, as optax's
``inject_hyperparams`` keeps it, so the plateau schedulers change it
between epochs (``set_learning_rate`` / ``get_learning_rate``).
``torch.optim`` is not used: its Adam and SGD order their arithmetic
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

OPTIMIZERS = ("sgd", "adam", "adadelta", "momentum", "momentum_decoupled")
_SLOTS = {
    "adam": ("mu", "nu"),
    "adadelta": ("e_g", "e_x"),
    "momentum": ("trace",),
    "momentum_decoupled": ("trace",),
}
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_RHO, _ADADELTA_EPS = 0.9, 1e-6


def _f32(x: float) -> float:
    """``x`` rounded to float32, held as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass
class OptState:
    """``learning_rate`` (float32-exact), ``count`` (updates taken) and the
    per-parameter slots: slot name -> parameter name -> tensor."""

    learning_rate: float
    count: int
    slots: Dict[str, Dict[str, torch.Tensor]]


class Optimizer:
    """One of ``OPTIMIZERS``; ``init`` makes its state, ``apply`` takes one
    step in place."""

    def __init__(self, name: str, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        key = name.lower()
        if key not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer '{name}'")
        self.name = key
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay

    def slot_names(self) -> tuple:
        if self.name == "sgd":
            return ("trace",) if self.momentum else ()
        return _SLOTS[self.name]

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        slots = {
            s: {n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in params.items()}
            for s in self.slot_names()
        }
        return OptState(_f32(self.lr), 0, slots)

    @torch.no_grad()
    def apply(
        self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor], state: OptState
    ) -> OptState:
        """Update ``params`` in place from ``grads`` (both by name); returns
        the new state."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        slot = {s: [state.slots[s][n] for n in names] for s in state.slots}
        mul, add = torch._foreach_mul, torch._foreach_add
        wd, key = self.weight_decay, self.name
        count = state.count + 1
        if key in ("sgd", "adam") and wd and wd > 0:
            g = add(g, mul(p, wd))
        if key == "adam":
            slot["mu"] = add(mul(g, 1 - _B1), mul(slot["mu"], _B1))
            slot["nu"] = add(mul(mul(g, g), 1 - _B2), mul(slot["nu"], _B2))
            bc1, bc2 = (
                float(1 - torch.tensor(b, dtype=torch.float32) ** float(count)) for b in (_B1, _B2)
            )
            mu_hat = torch._foreach_div(slot["mu"], bc1)
            nu_hat = torch._foreach_div(slot["nu"], bc2)
            u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), _ADAM_EPS))
        elif key == "adadelta":
            slot["e_g"] = add(mul(mul(g, g), 1 - _RHO), mul(slot["e_g"], _RHO))
            ratio = torch._foreach_div(
                torch._foreach_sqrt(torch._foreach_add(slot["e_x"], _ADADELTA_EPS)),
                torch._foreach_sqrt(torch._foreach_add(slot["e_g"], _ADADELTA_EPS)),
            )
            u = mul(ratio, g)
            slot["e_x"] = add(mul(mul(u, u), 1 - _RHO), mul(slot["e_x"], _RHO))
        elif "trace" in slot:
            slot["trace"] = add(g, mul(slot["trace"], self.momentum))
            u = slot["trace"]
        else:
            u = g
        u = mul(u, -state.learning_rate)
        if key in ("momentum", "momentum_decoupled") and wd and wd > 0:
            u = add(u, mul(p, -wd))
        torch._foreach_add_(p, u)
        return OptState(
            state.learning_rate, count, {s: dict(zip(names, slot[s])) for s in state.slots}
        )


def build_optimizer(name: str, lr: float, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """name: sgd | adam | adadelta | momentum | momentum_decoupled. 'sgd'
    and 'adam' follow the torch half (coupled L2), the rest the TF half;
    the TF 'sgd' is 'sgd' with momentum 0 and weight_decay 0."""
    return Optimizer(name, lr, momentum=momentum, weight_decay=weight_decay)


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """A copy of ``opt_state`` with the learning rate replaced (rounded to
    float32); the slots are shared, the old state keeps its rate."""
    return dataclasses.replace(opt_state, learning_rate=_f32(lr))


def get_learning_rate(opt_state: OptState) -> float:
    return opt_state.learning_rate
