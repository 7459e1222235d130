"""ConvLSTM video classifier (port of ``ivf_tpu/models/convlstm.py``).

One model family for both reference halves, with every option of the JAX
modules:

  * the torch family (``CLSTM_4``): per-step block order dropout -> BN ->
    max pool, ONE BatchNorm shared by all layers and timesteps
    (``shared_bn``), torch symmetric conv padding, sigmoid gates;
  * the TF family (Keras ``ConvLSTM2D`` blocks): pool -> BN with one BN per
    layer, 'valid' input padding, hard-sigmoid gates, forget-gate bias 1,
    the ``fc`` head over the last effective step or the whole sequence,
    and the ``gap`` head of ``clstm_gap``.

Clips are ``(B, T, H, W, C)``, activations NHWC, as in the JAX model.
In training mode (``model.train()``) BatchNorm takes each call's batch
statistics and updates its running ones (the shared BN once per layer and
step, in the order of the loop), and the torch family's per-layer dropout
draws a fresh mask at every step from the generator the train step sets
(``layers.Dropout``). The JAX model's ``use_scan`` / ``remat`` and
``ModelConfig.clstm_scan`` choose how XLA compiles the recurrence;
PyTorch runs eagerly, so the port always runs the Python time loop and has
no analogue of any of them.

A model cast to bfloat16 (every parameter and buffer) runs as the JAX
model does on its bf16 variables: the cell's convs cast their input to
bf16 and give bf16 gates, while the state ``(h, c)`` keeps the clip's
float32, and BN and the head compute in float32 over bf16 parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ivf_tpu_torch.models.layers import Dropout, TorchBatchNorm, variance_scaling_
from ivf_tpu_torch.ops.conv import avg_pool2d_valid, max_pool2d_valid
from ivf_tpu_torch.ops.convlstm_cell import convlstm_cell_step
from ivf_tpu_torch.precision import reference_numerics_fn

KernelSize = Union[int, Tuple[int, int]]


def _pair(k: KernelSize) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense``: input, kernel and bias promoted to one dtype
    (float32 features over bfloat16 parameters compute in float32)."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _effective(steps: Sequence[int], t: int) -> list:
    """The effective steps as the reference collects them (`step in
    effective_step` over the time loop): sorted, de-duplicated, in range;
    the last step when none is left."""
    return sorted({s for s in steps if 0 <= s < t}) or [t - 1]


class ConvLSTMCell(nn.Module):
    """One cell; ``wx`` (4 Ch, Cin, k1, k2) with bias ``bx``, and ``wh``
    (4 Ch, Ch, k1, k2), fused in (i, f, c, o) gate order."""

    def __init__(
        self,
        in_channels: int,
        hidden_channels: int,
        kernel_size: KernelSize = 5,
        conv_stride: int = 1,
        use_pallas: bool = False,
        recurrent_activation: str = "sigmoid",
        unit_forget_bias: bool = False,
        x_padding: str = "torch",
    ):
        super().__init__()
        k1, k2 = _pair(kernel_size)
        ch = hidden_channels
        self.hidden_channels = ch
        self.conv_stride = conv_stride
        self.use_pallas = use_pallas
        self.recurrent_activation = recurrent_activation
        self.unit_forget_bias = unit_forget_bias
        self.x_padding = x_padding
        self.wx = nn.Parameter(torch.empty(4 * ch, in_channels, k1, k2))
        self.bx = nn.Parameter(torch.zeros(4 * ch))
        self.wh = nn.Parameter(torch.empty(4 * ch, ch, k1, k2))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX cell's init: ``variance_scaling(1.0, 'fan_in',
        'truncated_normal')`` kernels, zero bias or, with
        ``unit_forget_bias``, 1 on the forget gate. Draws on the CPU
        generator."""
        variance_scaling_(self.wx, 1.0, generator)
        variance_scaling_(self.wh, 1.0, generator)
        with torch.no_grad():
            self.bx.zero_()
            if self.unit_forget_bias:
                self.bx[self.hidden_channels : 2 * self.hidden_channels] = 1.0

    def forward(self, x, h, c):
        return convlstm_cell_step(
            x, h, c, self.wx, self.bx, self.wh, self.conv_stride, self.use_pallas,
            self.recurrent_activation, self.x_padding,
        )


class ConvLSTM(nn.Module):
    """Multi-layer ConvLSTM over a clip. ``forward`` returns
    ``(effective_outputs, clstm_output, block_seq)``:

      * effective_outputs (n_eff, B, H', W', C): the last layer's block
        outputs (after BN and pool) at the effective steps;
      * clstm_output (B, T, H'', W'', C): the last layer's pre-pool hidden
        sequence, the Grad-CAM target;
      * block_seq (B, T, H', W', C): the last layer's block outputs at
        every step.
    """

    def __init__(
        self,
        hidden_channels: Sequence[int],
        in_channels: int = 3,
        kernel_size: KernelSize = 5,
        conv_stride: int = 1,
        pool_kernel: Tuple[int, int] = (2, 2),
        effective_steps: Sequence[int] = (),
        batch_norm: bool = True,
        shared_bn: bool = True,
        pooling: str = "max",
        block_order: str = "torch",
        dropout_rate: float = 0.0,
        use_pallas: bool = False,
        recurrent_activation: str = "sigmoid",
        unit_forget_bias: bool = False,
        x_padding: str = "torch",
    ):
        super().__init__()
        self.hidden_channels = tuple(hidden_channels)
        self.kernel_size = _pair(kernel_size)
        self.conv_stride = conv_stride
        self.pool_kernel = tuple(pool_kernel)
        self.effective_steps = tuple(effective_steps)
        self.batch_norm = batch_norm
        self.shared_bn = shared_bn
        self.pooling = pooling
        self.block_order = block_order
        self.dropout_rate = dropout_rate
        self.x_padding = x_padding
        cins = (in_channels,) + self.hidden_channels[:-1]
        self.cells = nn.ModuleList(
            ConvLSTMCell(
                cin, ch, kernel_size, conv_stride, use_pallas, recurrent_activation,
                unit_forget_bias, x_padding,
            )
            for cin, ch in zip(cins, self.hidden_channels)
        )
        if batch_norm:
            # tf.layers.batch_normalization's eps and momentum for the TF
            # family, torch BatchNorm2d's for the torch family
            eps, momentum = (1e-3, 0.01) if block_order == "tf" else (1e-5, 0.1)
            if shared_bn:
                if len(set(self.hidden_channels)) != 1:
                    raise ValueError(
                        f"shared_bn needs one width for every layer, got {self.hidden_channels}"
                    )
                self.bn = TorchBatchNorm(self.hidden_channels[0], eps, momentum)
            else:
                self.bns = nn.ModuleList(
                    TorchBatchNorm(ch, eps, momentum) for ch in self.hidden_channels
                )
        if dropout_rate:
            # one per layer (the reference shares one stateless instance,
            # the same thing): the torch block order's, before BN
            self.dropouts = nn.ModuleList(Dropout(dropout_rate) for _ in self.hidden_channels)
        self.eval()

    def _pool(self, x):
        if self.pooling == "avg":
            return avg_pool2d_valid(x, self.pool_kernel)
        return max_pool2d_valid(x, self.pool_kernel)

    def _block_tail(self, x, layer: int):
        """What follows the cell at every step: pool -> BN ('tf') or
        dropout -> BN -> pool ('torch')."""
        bn = None
        if self.batch_norm:
            bn = self.bn if self.shared_bn else self.bns[layer]
        if self.block_order == "tf":
            x = self._pool(x)
            return bn(x) if bn is not None else x
        if self.dropout_rate:
            x = self.dropouts[layer](x)
        if bn is not None:
            x = bn(x)
        return self._pool(x)

    def state_shapes(self, b: int, h_sp: int, w_sp: int) -> list:
        """Each layer's (B, H', W', Ch) state shape for (H, W) frames,
        computed statically: the cell conv gives ``(s + 2p - k) // stride +
        1``, the VALID pool then ``s // pool`` for the next layer."""
        k1, k2 = self.kernel_size
        p1, p2 = (0, 0) if self.x_padding == "valid" else ((k1 - 1) // 2, (k2 - 1) // 2)
        shapes = []
        for ch in self.hidden_channels:
            hh = (h_sp + 2 * p1 - k1) // self.conv_stride + 1
            ww = (w_sp + 2 * p2 - k2) // self.conv_stride + 1
            shapes.append((b, hh, ww, ch))
            h_sp = (hh - self.pool_kernel[0]) // self.pool_kernel[0] + 1
            w_sp = (ww - self.pool_kernel[1]) // self.pool_kernel[1] + 1
        return shapes

    def forward(self, clip: torch.Tensor, feature_offset: Optional[torch.Tensor] = None):
        """``feature_offset`` (B, T, H'', W'', C), when given, is added to
        the last layer's hidden output AFTER the recurrence has read it: the
        state carries ``h``, not ``h + offset``, so the gradient at a zero
        offset is the reference's gradient with respect to ``clstm_output``
        (through the pool and the head, not back through time)."""
        b, t, h_sp, w_sp = clip.shape[:4]
        last = len(self.cells) - 1
        effective = _effective(self.effective_steps, t)
        states = []
        for shape in self.state_shapes(b, h_sp, w_sp):
            zeros = clip.new_zeros(shape)
            states.append((zeros, zeros))
        # unbind, not clip[:, step]: its backward stacks the T frame
        # gradients once, where indexing would zero-fill and add a
        # clip-sized gradient per step
        frames = clip.unbind(1)
        offsets = feature_offset.unbind(1) if feature_offset is not None else None
        outputs, clstm_seq, block_list = [], [], []
        for step, x in enumerate(frames):
            for i, cell in enumerate(self.cells):
                h, c = cell(x, *states[i])
                states[i] = (h, c)
                if i == last:
                    if offsets is not None:
                        h = h + offsets[step]
                    clstm_seq.append(h)
                x = self._block_tail(h, i)
            block_list.append(x)
            if step in effective:
                outputs.append(x)
        return (
            torch.stack(outputs, dim=0),
            torch.stack(clstm_seq, dim=1),
            torch.stack(block_list, dim=1),
        )


class ConvLSTMClassifier(nn.Module):
    """Classifier over the ConvLSTM stack. ``head='fc'``: a Linear over the
    last effective step's output or, with ``use_entire_seq``, over all
    effective steps, flattened in (H', W', C) order as in the JAX model.
    ``head='gap'``: temporal then spatial mean of the block outputs, then a
    Linear (the 1x1 conv of ``clstm_gap``). flax infers a Dense layer's
    width from its first input; ``nn.Linear`` needs it when built, so the
    clip geometry is given: ``input_size`` (H, W) and ``clip_len`` T."""

    def __init__(
        self,
        num_classes: int = 174,
        nb_lstm_units: int = 32,
        lstm_layers: int = 4,
        conv_kernel_size: KernelSize = 5,
        conv_stride: int = 1,
        pool_kernel: Tuple[int, int] = (2, 2),
        effective_steps: Sequence[int] = (4, 8, 12, 15),
        batch_norm: bool = True,
        shared_bn: bool = True,
        pooling: str = "max",
        block_order: str = "torch",
        dropout_rate: float = 0.0,
        use_entire_seq: bool = False,
        add_softmax: bool = False,
        head: str = "fc",
        hidden_channels_override: Optional[Sequence[int]] = None,
        recurrent_activation: str = "sigmoid",
        unit_forget_bias: bool = False,
        x_padding: str = "torch",
        use_pallas: bool = False,
        in_channels: int = 3,
        *,
        input_size: Tuple[int, int],
        clip_len: int,
    ):
        super().__init__()
        hidden = tuple(hidden_channels_override or (nb_lstm_units,) * lstm_layers)
        self.head = head
        self.use_entire_seq = use_entire_seq
        self.add_softmax = add_softmax
        self.clstm = ConvLSTM(
            hidden, in_channels, conv_kernel_size, conv_stride, pool_kernel, effective_steps,
            batch_norm, shared_bn, pooling, block_order, dropout_rate, use_pallas,
            recurrent_activation, unit_forget_bias, x_padding,
        )
        _, hp, wp, _ = self.clstm.state_shapes(1, *input_size)[-1]
        hp, wp = hp // pool_kernel[0], wp // pool_kernel[1]
        if head == "fc":
            n_eff = len(_effective(effective_steps, clip_len)) if use_entire_seq else 1
            in_features = hp * wp * hidden[-1] * n_eff
            self.end_fc = nn.Linear(in_features, num_classes)
        else:
            self.gap_conv = nn.Linear(hidden[-1], num_classes)
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: the cells as ``ConvLSTMCell.reset_parameters``, the
        head as flax ``nn.Dense`` (LeCun normal, truncated, zero bias),
        identity BatchNorm."""
        for mod in self.modules():
            if isinstance(mod, ConvLSTMCell):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Linear):
                variance_scaling_(mod.weight, 1.0, generator)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, TorchBatchNorm):
                mod.reset_parameters()

    @reference_numerics_fn
    def scores_and_features(
        self, clip: torch.Tensor, feature_offset: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(class scores (B, num_classes), clstm_output) of one pass."""
        outputs, clstm_output, block_seq = self.clstm(clip, feature_offset)
        b = clip.shape[0]
        if self.head == "gap":
            out = _dense(self.gap_conv, block_seq.mean(dim=1).mean(dim=(1, 2)))
        elif self.use_entire_seq:
            out = _dense(self.end_fc, outputs.transpose(0, 1).reshape(b, -1))
        else:
            out = _dense(self.end_fc, outputs[-1].reshape(b, -1))
        if self.add_softmax:
            out = torch.softmax(out, dim=-1)
        return out, clstm_output

    def forward(
        self, clip: torch.Tensor, feature_offset: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """clip (B, T, H, W, C) -> class scores (B, num_classes)."""
        return self.scores_and_features(clip, feature_offset)[0]

    @reference_numerics_fn
    def features(self, clip: torch.Tensor) -> torch.Tensor:
        """The Grad-CAM target: the last layer's pre-pool hidden sequence."""
        return self.clstm(clip)[1]

    def clstm_output_shape(self, clip: torch.Tensor) -> Tuple[int, ...]:
        """Shape of ``features(clip)`` (and of a ``feature_offset``)."""
        b, t, h_sp, w_sp = clip.shape[:4]
        return (b, t, *self.clstm.state_shapes(b, h_sp, w_sp)[-1][1:])
