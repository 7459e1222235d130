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
dtype (``ivf_tpu/ops/conv.py:53``).

Under a data mesh the train step hands every BatchNorm the data axis's
process group (``set_batch_stats_group``): the batch statistics are then
the global batch's, as a JAX mesh takes them, and every ``Dropout`` the
rank's place in the global batch, so it draws the global batch's mask and
keeps its rows. ``parallel/mesh.py::tensor_parallel`` gives a ``Unit3D``
its slice of the output channels and the model axis's group
(``tp_group``): the unit gathers its output along the channels.

``checkpointed`` runs a block as flax's ``nn.remat`` does (``I3D(remat=
True)``): its activations are recomputed in the backward, and its
BatchNorms' training-mode side effects (the running statistics and the
synchronised statistics' collectives) happen once, in the forward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ivf_tpu_torch.ops.conv import conv3d_same, conv3d_stem_s2d, max_pool3d_same
from ivf_tpu_torch.ops.kernels.fused_branch3 import fused_pool_conv, fused_pool_conv_tblock
from ivf_tpu_torch.ops.kernels.maxpool3d import maxpool3d_s1
from ivf_tpu_torch.ops.kernels.pointwise_conv import pointwise_conv
from ivf_tpu_torch.parallel.collectives import all_gather_along, all_reduce_sum
from ivf_tpu_torch.precision import reference_numerics


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


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        return torch.where((x > 0) & (g > 0), g, torch.zeros((), dtype=g.dtype, device=g.device))


def guided_relu(x: torch.Tensor) -> torch.Tensor:
    """Guided backprop's ReLU (``interpret/guided_backprop.py``):
    ``max(x, 0)``, whose backward passes the gradient only where ``x`` and
    the gradient are both positive; ``x`` is saved in its own dtype, as
    the JAX VJP saves it."""
    return _GuidedReLU.apply(x)


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
    master copy). The I3D reference uses eps=1e-3, momentum=0.01.

    ``num_batches_tracked`` is torch's: a long scalar buffer that each
    training-mode call adds one to (the statistics' update does not read
    it, the momentum being fixed), so reference ``.pth.tar`` files load
    with ``strict=True`` and exported ones carry it. A state dict without
    it loads with 0, as torch's BatchNorm loads one of its old layout.

    With ``stats_group`` set (``set_batch_stats_group``; every rank of the
    group holds as many rows) the training statistics are the group's
    global batch's: the mean is the sum of the ranks' means over the
    group's size, and the biased variance likewise from the centred
    squares, the same two passes over the global batch; the running
    variance takes the global count's unbiased factor. The ranks' means
    summed (rather than their sums over the global count) keep the bits
    of the local statistics on a group of one rank. torch's
    ``nn.SyncBatchNorm`` runs on CUDA only and has its own numerics.

    Inside ``checkpointed`` the module holds the block's ``tape``: its
    recompute updates no running statistic and takes the group's sums
    from the tape instead of summing again."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.stats_group = None
        self.tape: Optional[_RematTape] = None
        self.eval()

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "num_batches_tracked"
        if key not in state_dict:
            state_dict[key] = torch.zeros_like(self.num_batches_tracked)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """Identity: unit scale and variance, zero shift and mean."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

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
            n = x.numel() // x.shape[-1]
            group, tape = self.stats_group, self.tape
            if group is None:
                mean_f = xf.mean(dims)
                centered = xf - mean_f
                var_f = (centered * centered).mean(dims)
            else:
                ranks = dist.get_world_size(group)
                group_sum = all_reduce_sum if tape is None else tape.group_sum
                mean_f = group_sum(xf.mean(dims), group) / ranks
                centered = xf - mean_f
                var_f = group_sum((centered * centered).mean(dims), group) / ranks
                n *= ranks
            mean = mean_f.to(x.dtype)
            var = var_f.to(x.dtype)
            if tape is None or not tape.replaying:
                with torch.no_grad():
                    m, rm, rv = self.momentum, self.running_mean, self.running_var
                    unbiased = var * (n / max(n - 1, 1))
                    rm.copy_((1 - m) * rm + (m * mean).to(rm.dtype))
                    rv.copy_((1 - m) * rv + (m * unbiased).to(rv.dtype))
                    self.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class _RematTape:
    """What the first run of a checkpointed block hands its recompute: the
    sums its synchronised BatchNorms took, in call order."""

    def __init__(self):
        self.sums: list = []
        self.replaying = False
        self.pos = 0

    def group_sum(self, local: torch.Tensor, group) -> torch.Tensor:
        if not self.replaying:
            total = all_reduce_sum(local, group)
            self.sums.append(total.detach())
            return total
        # the recompute only regenerates the tensors the backward saved;
        # the gradient runs through the forward's graph. The sum tracks
        # grad as the forward's did, so the ops after it save alike
        total = self.sums[self.pos].requires_grad_(local.requires_grad)
        self.pos += 1
        return total


def _pinned_recompute():
    # the recompute runs in the backward, outside the forward's pin
    return contextlib.nullcontext(), reference_numerics()


def checkpointed(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint`` (non-reentrant), as
    flax's ``nn.remat``: the block's activations are dropped after the
    forward and recomputed in the backward, under the exact float32 pin
    (``precision.py``) the forward ran in. Its BatchNorms' training-mode
    side effects happen once, in the forward: the recompute updates no
    running statistic and, under a data mesh, takes the synchronised sums
    of the forward rather than summing again (``_RematTape``). A tensor-
    parallel unit's gather of its channels runs again in the recompute, on
    every rank alike. Nothing in a block draws random numbers, so the RNG
    state is not saved."""
    tape = _RematTape()
    norms = [m for m in block.modules() if isinstance(m, TorchBatchNorm)]

    def run(inp: torch.Tensor) -> torch.Tensor:
        tape.pos = 0
        for bn in norms:
            bn.tape = tape
        try:
            return block(inp)
        finally:
            for bn in norms:
                bn.tape = None
            tape.replaying = True

    return torch.utils.checkpoint.checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False, context_fn=_pinned_recompute
    )


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training each element is kept with
    probability ``1 - rate`` (a uniform draw below it) and scaled by ``1 /
    (1 - rate)``, the rest zeroed; the identity in eval mode. The uniforms
    come from ``generator`` (on the input's device), which the train step
    sets from the run's seed and step (``train/state.py::step_generator``),
    so a resumed run draws the masks of an uninterrupted one. Training with
    no generator set raises. With ``rows = (index, count)`` the input is
    block ``index`` of ``count`` equal row blocks of a global batch: the
    mask is drawn for the global batch and the block's rows kept, so the
    ranks of a data mesh draw the values of one process."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.rows: Optional[Tuple[int, int]] = None
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator (set_dropout_generator)")
        keep = 1.0 - self.rate
        index, count = self.rows or (0, 1)
        b = x.shape[0]
        u = torch.rand((count * b, *x.shape[1:]), generator=self.generator, device=x.device)
        mask = u[index * b : (index + 1) * b] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(
    model: nn.Module, generator: Optional[torch.Generator], rows: Optional[Tuple[int, int]] = None
) -> None:
    """Hand ``generator`` to every ``Dropout`` of ``model``: they draw from
    it in forward order; ``rows`` is the input's (block, blocks) of the
    global batch (``Dropout``), None for the whole batch."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
            mod.rows = rows


def set_batch_stats_group(model: nn.Module, group) -> None:
    """Hand the process group of the data axis to every ``TorchBatchNorm``
    of ``model`` (None: the local batch's statistics)."""
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.stats_group = group


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
    ``conv3d_same``. With ``tp_group`` set (``parallel/mesh.py::
    tensor_parallel``) the unit holds a slice of the output channels and
    gathers its output along them.
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
        self.tp_group = None
        self.eval()

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` (this unit's channels) with every rank's channels of the
        model axis, the identity without one."""
        return y if self.tp_group is None else all_gather_along(y, -1, self.tp_group)

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
        return self.gather(x)


class InceptionModule(nn.Module):
    """4-branch Inception block; ``out_channels = [b0, b1a, b1b, b2a, b2b,
    b3b]``, output = channel concat of (b0, b1, b2, b3). ``activation``
    is every unit's (``guided_relu`` for guided backprop).

    The fusions below run only while ``fusing``: BN folded (eval mode)
    and the activation the plain ReLU, the JAX package's rule
    (``ivf_tpu/models/layers.py:205``); under another activation every
    unit runs apart, so the activation's own backward reaches each.
    ``fuse_1x1``: the three parallel 1x1x1 branch convs (b0, b1a, b2a)
    run as ONE conv whose output channels split after the shared ReLU.
    ``fuse_3x3`` (True, or ``'auto'``: only where the block input's H is
    at most 14): the two 3x3x3 convs (b1b, b2b) run as ONE conv of the
    block-diagonal folded kernel over ``cat([b1, b2])``, split after the
    ReLU (~1.4x the operations for half the convs). ``pallas_pool``: the
    branch-3 pool runs through the ``maxpool3d_s1`` kernel pair (every-tie
    backward) instead of ``F.max_pool3d``. ``fuse_pool_conv``: the whole
    branch 3 (pool, folded 1x1x1 conv, bias, ReLU) is one kernel each way
    (``ops/kernels/fused_branch3.py``, same tie rule); ``'tblock'`` takes
    the whole-sample kernels, any other true value the per-frame ones. It
    takes precedence over ``pallas_pool`` and over ``use_pallas`` for b3b.
    In bfloat16 the fused kernels take the bf16 activations and folded
    weights and sum in float32, rounding once (the Pallas kernels' bf16
    path).
    ``pool_impl`` is the unfused branch-3 pool's (``max_pool3d_same``):
    ``pallas_pool`` and ``fuse_pool_conv`` override it, as in JAX
    (``ivf_tpu/models/layers.py:272-278``). Under tensor parallelism the
    trio and the block-diagonal conv concatenate the units' slices, and
    each part is gathered after the split.
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
        fuse_3x3: object = False,
        activation: Callable = F.relu,
    ):
        super().__init__()
        oc = tuple(out_channels)
        self.pool_impl = pool_impl
        self.out_channels = oc
        self.fuse_1x1 = fuse_1x1
        self.fuse_3x3 = fuse_3x3
        self.use_pallas = use_pallas
        self.pallas_pool = pallas_pool
        self.fuse_pool_conv = fuse_pool_conv
        self.activation = activation
        unit = lambda cin, cout, k, pw: Unit3D(  # noqa: E731
            cin, cout, k, activation=activation, fold_bn=fold_bn, use_pallas=use_pallas and pw
        )
        self.b0 = unit(in_channels, oc[0], (1, 1, 1), True)
        self.b1a = unit(in_channels, oc[1], (1, 1, 1), True)
        self.b1b = unit(oc[1], oc[2], (3, 3, 3), False)
        self.b2a = unit(in_channels, oc[3], (1, 1, 1), True)
        self.b2b = unit(oc[3], oc[4], (3, 3, 3), False)
        self.b3b = unit(in_channels, oc[5], (1, 1, 1), True)
        self.eval()

    @property
    def fusing(self) -> bool:
        units = (self.b0, self.b1a, self.b1b, self.b2a, self.b2b, self.b3b)
        return self.activation is F.relu and all(m.folding for m in units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fusing = self.fusing
        heads = (self.b0, self.b1a, self.b2a)
        if self.fuse_1x1 and fusing:
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
            parts = torch.split(y, [k.shape[0] for k, _ in parts], dim=-1)
            b0, b1, b2 = (m.gather(p) for m, p in zip(heads, parts))
        else:
            b0, b1, b2 = (m(x) for m in heads)
        fuse3 = self.fuse_3x3 is True or (self.fuse_3x3 == "auto" and x.shape[2] <= 14)
        if fuse3 and fusing:
            b1, b2 = self._fused_3x3(b1, b2)
        else:
            b1 = self.b1b(b1)
            b2 = self.b2b(b2)
        if self.fuse_pool_conv and fusing:
            fused = fused_pool_conv_tblock if self.fuse_pool_conv == "tblock" else fused_pool_conv
            w3, c3 = self.b3b.folded()
            cin = x.shape[-1]
            b3 = self.b3b.gather(fused(x.contiguous(), w3.reshape(w3.shape[0], cin).t().contiguous(), c3, True))
        else:
            if self.pallas_pool:
                b3 = maxpool3d_s1(x.contiguous())
            else:
                b3 = max_pool3d_same(x, (3, 3, 3), (1, 1, 1), impl=self.pool_impl)
            b3 = self.b3b(b3)
        return torch.cat([b0, b1, b2, b3], dim=-1)

    def _fused_3x3(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """b1b(b1), b2b(b2) as one conv of the block-diagonal folded kernel
        ``[[k1, 0], [0, k2]]`` over ``cat([b1, b2])``."""
        (k1, c1), (k2, c2) = self.b1b.folded(), self.b2b.folded()
        (n1, i1), (n2, i2) = k1.shape[:2], k2.shape[:2]
        kd = torch.cat([
            torch.cat([k1, k1.new_zeros((n1, i2, *k1.shape[2:]))], dim=1),
            torch.cat([k2.new_zeros((n2, i1, *k2.shape[2:])), k2], dim=1),
        ])
        y = F.relu(conv3d_same(torch.cat([b1, b2], dim=-1), kd, (1, 1, 1), torch.cat([c1, c2])))
        y1, y2 = torch.split(y, [n1, n2], dim=-1)
        return self.b1b.gather(y1), self.b2b.gather(y2)
