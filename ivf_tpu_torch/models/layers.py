"""I3D building blocks (port of ``ivf_tpu/models/layers.py``).

Activations are contiguous channels-last ``(B, T, H, W, C)``; conv weights
are ``(Cout, Cin, kT, kH, kW)``. Parameter names follow the reference
torch modules (``conv3d.weight|bias``, ``bn.weight|bias|running_mean|
running_var``), which are also the names ``utils/convert.py`` produces.

In eval mode BatchNorm normalizes with its running statistics and is
folded into the preceding conv by default (``fold_bn``), on every forward
from the module's own parameters, so a module cast to bfloat16 folds in
bfloat16, as the JAX package does after casting its variables. Every
module of the port starts in eval mode, as the JAX modules default to
``train=False``. In training mode (``module.train()``) nothing folds: BatchNorm normalizes by
the batch's statistics and updates its running ones, and ``Dropout``
draws its masks from the generator the train step hands it
(``set_dropout_generator``). Each conv casts its input to the weight's
dtype (``ivf_tpu/ops/conv.py:53``). The JAX package's ``fuse_3x3`` is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ivf_tpu_torch.ops.conv import conv3d_same, conv3d_stem_s2d, max_pool3d_same
from ivf_tpu_torch.ops.kernels.fused_branch3 import fused_pool_conv, fused_pool_conv_tblock
from ivf_tpu_torch.ops.kernels.maxpool3d import maxpool3d_s1
from ivf_tpu_torch.ops.kernels.pointwise_conv import pointwise_conv


def variance_scaling_(w: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, 'fan_in', 'truncated_normal')`` into
    ``w`` (PyTorch layout, fan-in = the product of all but the first dim),
    drawn on the CPU generator."""
    # 0.8796 = std of a unit normal truncated at +-2
    std = math.sqrt(scale / math.prod(w.shape[1:])) / 0.87962566103423978
    cpu = torch.empty(w.shape)
    nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        w.copy_(cpu)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis with torch's semantics
    (``ivf_tpu/models/layers.py:23-59``).

    Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.
    Training: normalize by the batch mean and the biased batch variance
    (two passes, as ``jnp.var``), and update the running statistics with
    the unbiased variance, ``running = (1 - momentum) * running + momentum
    * batch`` (torch's convention: ``momentum`` is the new batch's weight).
    The batch statistics are taken in float32 and rounded to the input's
    dtype, as ``jnp.mean`` / ``jnp.var`` give them for a bfloat16 input;
    the running statistics keep their own dtype (float32 in training, the
    master copy). The I3D reference uses eps=1e-3, momentum=0.01."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eval()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """Identity: unit scale and variance, zero shift and mean."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval-mode affine ``(s, t)`` with ``bn(x) = x * s + t``."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.dim() - 1))
            xf = x.float()
            mean_f = xf.mean(dims)
            centered = xf - mean_f
            mean = mean_f.to(x.dtype)
            var = (centered * centered).mean(dims).to(x.dtype)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m, rm, rv = self.momentum, self.running_mean, self.running_var
                unbiased = var * (n / max(n - 1, 1))
                rm.copy_((1 - m) * rm + (m * mean).to(rm.dtype))
                rv.copy_((1 - m) * rv + (m * unbiased).to(rv.dtype))
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` (a uniform draw below it) and scaled by ``1 /
    (1 - rate)``, the rest zeroed; the identity in eval mode. The uniforms
    come from ``generator`` (on the input's device), which the train step
    sets from the run's seed and step (``train/state.py::step_generator``),
    so a resumed run draws the masks of an uninterrupted one. Training with
    no generator set raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator (set_dropout_generator)")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every ``Dropout`` of ``model``: they draw from
    it in forward order."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


class Conv3dParams(nn.Module):
    """Weight ``(Cout, Cin, kT, kH, kW)`` and optional bias of one conv —
    a parameter holder named like the reference's ``nn.Conv3d``; the
    padding semantics live in ``ops/conv.py``."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int], bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class Unit3D(nn.Module):
    """Conv3D(SAME) -> BN -> activation, the I3D building block.

    With ``use_pallas`` a 1x1x1 stride-1 conv runs through the pointwise
    kernel (``ops/kernels/pointwise_conv.py``) with the ReLU fused into its
    epilogue when BN is folded or absent; in training (BN unfolded) the
    kernel runs with no bias and no ReLU, then BN, then the activation
    (``ivf_tpu/models/layers.py:116-133``). With ``s2d`` a 7x7x7 stride-2
    conv on even T, H, W runs as ``conv3d_stem_s2d``, the reference's guard
    (``ivf_tpu/models/layers.py:135-143``); any other shape takes
    ``conv3d_same``.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_shape: Sequence[int] = (1, 1, 1),
        stride: Sequence[int] = (1, 1, 1),
        use_batch_norm: bool = True,
        use_bias: bool = False,
        activation: Optional[Callable] = F.relu,
        fold_bn: bool = True,
        use_pallas: bool = False,
        s2d: bool = False,
    ):
        super().__init__()
        self.kernel_shape = tuple(kernel_shape)
        self.stride = tuple(stride)
        self.activation = activation
        self.fold_bn = fold_bn
        self.use_pallas = use_pallas
        self.s2d = s2d
        self.conv3d = Conv3dParams(in_channels, out_channels, kernel_shape, use_bias)
        self.bn = TorchBatchNorm(out_channels) if use_batch_norm else None
        self.eval()

    @property
    def folding(self) -> bool:
        """BN folds into the conv in eval mode only, as in JAX."""
        return self.bn is not None and self.fold_bn and not self.training

    def folded(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Conv (weight, bias) with BN folded in when ``folding``."""
        w, b = self.conv3d.weight, self.conv3d.bias
        if self.folding:
            s, t = self.bn.fold()
            w = w * s.view(-1, 1, 1, 1, 1)
            b = t if b is None else b * s + t
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.folded()
        pointwise = self.kernel_shape == (1, 1, 1) and self.stride == (1, 1, 1)
        relu_fused = False
        if self.use_pallas and pointwise:
            relu_fused = self.activation is F.relu and (self.folding or self.bn is None)
            cout, cin = w.shape[:2]
            x = pointwise_conv(
                x.to(w.dtype).contiguous(), w.reshape(cout, cin).t(), b,
                relu=relu_fused,
            )
        elif (
            self.s2d
            and self.kernel_shape == (7, 7, 7)
            and self.stride == (2, 2, 2)
            and all(d % 2 == 0 for d in x.shape[1:4])
        ):
            x = conv3d_stem_s2d(x, w, b)
        else:
            x = conv3d_same(x, w, self.stride, b)
        if self.bn is not None and not self.folding:
            x = self.bn(x)
        if self.activation is not None and not relu_fused:
            x = self.activation(x)
        return x


class InceptionModule(nn.Module):
    """4-branch Inception block; ``out_channels = [b0, b1a, b1b, b2a, b2b,
    b3b]``, output = channel concat of (b0, b1, b2, b3).

    ``fuse_1x1``: with folded BN, the three parallel 1x1x1 branch convs
    (b0, b1a, b2a) run as ONE conv whose output channels split after the
    shared ReLU. ``pallas_pool``: the branch-3 pool runs through the
    ``maxpool3d_s1`` kernel pair (every-tie backward) instead of
    ``F.max_pool3d``. ``fuse_pool_conv``: with b3b's BN folded, the whole
    branch 3 (pool, folded 1x1x1 conv, bias, ReLU) is one kernel each way
    (``ops/kernels/fused_branch3.py``, same tie rule); ``'tblock'`` takes
    the whole-sample kernels, any other true value the per-frame ones. It
    takes precedence over ``pallas_pool`` and over ``use_pallas`` for b3b;
    with BN unfolded the branch runs unfused, as in JAX. In bfloat16 the
    fused kernels take the bf16 activations and folded weights and sum in
    float32, rounding once (the Pallas kernels' bf16 path).
    ``pool_impl`` is the unfused branch-3 pool's (``max_pool3d_same``):
    ``pallas_pool`` and ``fuse_pool_conv`` override it, as in JAX
    (``ivf_tpu/models/layers.py:272-278``).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Sequence[int],
        fold_bn: bool = True,
        fuse_1x1: bool = True,
        use_pallas: bool = False,
        pallas_pool: bool = False,
        fuse_pool_conv: object = False,
        pool_impl: str = "reduce_window",
    ):
        super().__init__()
        oc = tuple(out_channels)
        self.pool_impl = pool_impl
        self.out_channels = oc
        self.fuse_1x1 = fuse_1x1
        self.use_pallas = use_pallas
        self.pallas_pool = pallas_pool
        self.fuse_pool_conv = fuse_pool_conv
        unit = lambda cin, cout, k, pw: Unit3D(  # noqa: E731
            cin, cout, k, fold_bn=fold_bn, use_pallas=use_pallas and pw
        )
        self.b0 = unit(in_channels, oc[0], (1, 1, 1), True)
        self.b1a = unit(in_channels, oc[1], (1, 1, 1), True)
        self.b1b = unit(oc[1], oc[2], (3, 3, 3), False)
        self.b2a = unit(in_channels, oc[3], (1, 1, 1), True)
        self.b2b = unit(oc[3], oc[4], (3, 3, 3), False)
        self.b3b = unit(in_channels, oc[5], (1, 1, 1), True)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        oc = self.out_channels
        heads = (self.b0, self.b1a, self.b2a)
        if self.fuse_1x1 and all(m.folding for m in heads):
            parts = [m.folded() for m in heads]
            kcat = torch.cat([k for k, _ in parts])
            bcat = torch.cat([b for _, b in parts])
            if self.use_pallas:
                cin = x.shape[-1]
                y = pointwise_conv(
                    x.to(kcat.dtype).contiguous(), kcat.reshape(-1, cin).t(),
                    bcat, relu=True,
                )
            else:
                y = F.relu(conv3d_same(x, kcat, (1, 1, 1), bcat))
            b0, b1, b2 = torch.split(y, [oc[0], oc[1], oc[3]], dim=-1)
        else:
            b0, b1, b2 = (m(x) for m in heads)
        b1 = self.b1b(b1)
        b2 = self.b2b(b2)
        if self.fuse_pool_conv and self.b3b.folding:
            fused = fused_pool_conv_tblock if self.fuse_pool_conv == "tblock" else fused_pool_conv
            w3, c3 = self.b3b.folded()
            cin = x.shape[-1]
            b3 = fused(x.contiguous(), w3.reshape(oc[5], cin).t().contiguous(), c3, True)
        else:
            if self.pallas_pool:
                b3 = maxpool3d_s1(x.contiguous())
            else:
                b3 = max_pool3d_same(x, (3, 3, 3), (1, 1, 1), impl=self.pool_impl)
            b3 = self.b3b(b3)
        return torch.cat([b0, b1, b2, b3], dim=-1)
