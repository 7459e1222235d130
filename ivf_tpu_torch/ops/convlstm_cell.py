"""Fused ConvLSTM cell step (port of ``ivf_tpu/ops/convlstm_cell.py``).

One timestep of one layer: the four input-to-hidden convs fused into one
conv with ``4 * Ch`` output channels in (i, f, c, o) order, likewise the
four hidden-to-hidden convs, then the elementwise gate block::

    i = act(z_i); f = act(z_f); o = act(z_o)      z = conv(x) + b + conv(h)
    c' = f * c + i * tanh(z_c)
    h' = o * tanh(c')

``act`` is the sigmoid (torch family) or Keras's hard sigmoid (TF
family). The reference cell's peephole terms are zero constants and are
left out, as in the JAX package. Activations are NHWC; conv weights
``(4 Ch, Cin, kH, kW)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ivf_tpu_torch.ops.conv import conv2d_same_torch
from ivf_tpu_torch.ops.kernels.fused_gates import (
    bf16_gate_forward,
    gate_math,
    mixed_gate_forward,
    sigmoid_bf16,
)


def keras_hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras's hard_sigmoid, ``clip(0.2 x + 0.5, 0, 1)``: slope 0.2, NOT
    ``F.hardsigmoid`` (slope 1/6)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_SLOPE_BF16 = float(torch.tensor(0.2).bfloat16())  # JAX's weak-typed 0.2 in bf16


def _hard_sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """Keras's hard sigmoid in bfloat16 as XLA computes it on float32-held
    bf16 values (the slope rounded to bf16, each op rounded): exact in
    bf16, so its last rounding is a no-op."""
    t = (_SLOPE_BF16 * x).bfloat16().float()
    return torch.clamp((t + 0.5).bfloat16().float(), 0.0, 1.0)


def fused_gate_math(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    recurrent_activation: str = "sigmoid",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate block in plain PyTorch. gates_*: (..., 4 Ch) in (i, f, c, o)
    order, ``gates_h`` None when the x- and h-convs were merged. Returns
    (h', c') in c's dtype. bfloat16 gates with a float32 c (the JAX
    package's bf16 search) or a bfloat16 c (its bf16 train step) round
    where XLA rounds that jnp math (``fused_gates.mixed_gate_forward``,
    ``fused_gates.bf16_gate_forward``)."""
    if gates_x.dtype == torch.bfloat16 and c.dtype in (torch.float32, torch.bfloat16):
        act = _hard_sigmoid_bf16 if recurrent_activation == "hard_sigmoid" else sigmoid_bf16
        block = mixed_gate_forward if c.dtype == torch.float32 else bf16_gate_forward
        return block(gates_x, gates_h, c, act)
    hidden = c.shape[-1]
    z = gates_x if gates_h is None else gates_x + gates_h
    zi, zf, zc, zo = torch.split(z, hidden, dim=-1)
    act = keras_hard_sigmoid if recurrent_activation == "hard_sigmoid" else torch.sigmoid
    i = act(zi)
    f = act(zf)
    new_c = f * c + i * torch.tanh(zc)
    o = act(zo)
    return o * torch.tanh(new_c), new_c


def convlstm_cell_step(
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    wx: torch.Tensor,
    bx: torch.Tensor,
    wh: torch.Tensor,
    conv_stride: int = 1,
    use_pallas: bool = False,
    recurrent_activation: str = "sigmoid",
    x_padding: str = "torch",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ConvLSTM timestep; x (B, H, W, Cin), h and c (B, H', W', Ch).

    wx (4 Ch, Cin, k1, k2) with bias bx (4 Ch,); wh (4 Ch, Ch, k1, k2), no
    bias. ``x_padding='torch'``: the x-conv pads symmetrically by
    ``(k - 1) // 2``; ``'valid'``: not at all (Keras padding='valid'). The
    h-conv is stride 1 with the symmetric padding either way.

    The routing is the JAX package's: with torch padding, stride 1 and
    equal spatial dims, ONE conv runs over ``[x; h]`` with ``[wx; wh]``;
    otherwise two convs run. The gate block goes to the fused-gates kernel
    (``ops/kernels/fused_gates.py``) only when ``use_pallas`` is set and the
    gates are sigmoids; with hard-sigmoid gates it runs in plain PyTorch
    even on the card, as ``fused_gate_math`` does in the JAX package for
    that case. That is the reference's routing, not a fallback: the kernel
    computes sigmoid gates only. Returns (h', c').
    """
    if x_padding == "torch" and conv_stride == 1 and x.shape[1:3] == h.shape[1:3]:
        xh = torch.cat([x, h.to(x.dtype)], dim=-1)
        w = torch.cat([wx, wh.to(wx.dtype)], dim=1)
        gates_x, gates_h = conv2d_same_torch(xh, w, 1, bx), None
    else:
        px = (0, 0) if x_padding == "valid" else None
        gates_x = conv2d_same_torch(x, wx, conv_stride, bx, torch_padding=px)
        gates_h = conv2d_same_torch(h, wh, 1)
    if use_pallas and recurrent_activation == "sigmoid":
        return gate_math(
            gates_x.contiguous(),
            None if gates_h is None else gates_h.contiguous(),
            c.contiguous(),
        )
    return fused_gate_math(gates_x, gates_h, c, recurrent_activation)
