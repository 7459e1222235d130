"""Inception-v1 I3D (port of ``ivf_tpu/models/i3d.py``).

Same trunk table, head and knobs as the JAX model; ``remat``,
``guided_relu`` and ``fuse_3x3`` are not ported. In training mode
(``model.train()``) BatchNorm takes the batch's statistics, nothing folds
or fuses (``fuse_1x1`` and ``fuse_pool_conv`` are inference-only, as in
JAX: ``ivf_tpu/models/layers.py:205``), and dropout before the logits conv
draws from the generator the train step sets (``layers.Dropout``). ``stem_s2d`` runs
the 7x7x7 stride-2 stem as the space-to-depth conv, as the JAX model
does by default. ``pool_impl`` (any of the JAX package's six)
reaches every max pool (``ops/conv.py::max_pool3d_same``) but the
branch-3 pools that ``pallas_pool`` or ``fuse_pool_conv`` take. A model cast to
bfloat16 runs in bfloat16 from its first conv, which casts the clips, to
the softmax, as the JAX model does.
Input and output layouts match the JAX model: clips
``(B, T, H, W, C)`` -> logits ``(B, num_classes)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ivf_tpu_torch.models.layers import (
    Conv3dParams,
    Dropout,
    InceptionModule,
    TorchBatchNorm,
    Unit3D,
    variance_scaling_,
)
from ivf_tpu_torch.ops.conv import avg_pool3d_valid, max_pool3d_same
from ivf_tpu_torch.precision import reference_numerics_fn

# (endpoint name, kind, spec) in trunk order; 'spool' endpoints honor
# stride_mod_layers
_TRUNK = (
    ("Conv3d_1a_7x7", "conv", dict(out=64, kernel=(7, 7, 7), stride_t=2, stride_hw=2)),
    ("MaxPool3d_2a_3x3", "pool", dict(window=(1, 3, 3), stride=(1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", dict(out=64, kernel=(1, 1, 1), stride_t=1, stride_hw=1)),
    ("Conv3d_2c_3x3", "conv", dict(out=192, kernel=(3, 3, 3), stride_t=1, stride_hw=1)),
    ("MaxPool3d_3a_3x3", "pool", dict(window=(1, 3, 3), stride=(1, 2, 2))),
    ("Mixed_3b", "mixed", dict(out=(64, 96, 128, 16, 32, 32))),
    ("Mixed_3c", "mixed", dict(out=(128, 128, 192, 32, 96, 64))),
    ("MaxPool3d_4a_3x3", "spool", dict(window=(3, 3, 3), stride_t=2, stride_hw=2)),
    ("Mixed_4b", "mixed", dict(out=(192, 96, 208, 16, 48, 64))),
    ("Mixed_4c", "mixed", dict(out=(160, 112, 224, 24, 64, 64))),
    ("Mixed_4d", "mixed", dict(out=(128, 128, 256, 24, 64, 64))),
    ("Mixed_4e", "mixed", dict(out=(112, 144, 288, 32, 64, 64))),
    ("Mixed_4f", "mixed", dict(out=(256, 160, 320, 32, 128, 128))),
    ("MaxPool3d_5a_2x2", "spool", dict(window=(2, 2, 2), stride_t=2, stride_hw=2)),
    ("Mixed_5b", "mixed", dict(out=(256, 160, 320, 32, 128, 128))),
    ("Mixed_5c", "mixed", dict(out=(384, 192, 384, 48, 128, 128))),
)

TRUNK_ENDPOINTS = tuple(name for name, _, _ in _TRUNK)


class I3D(nn.Module):
    """I3D classifier. ``use_pallas`` routes every 1x1x1 conv (the fused
    Inception trio, ``b3b``, ``Conv3d_2b_1x1`` and the logits head) through
    the pointwise kernel; ``pallas_pool`` routes the nine branch-3 pools
    through the max-pool kernel pair; ``fuse_pool_conv`` (True: per-frame,
    ``'tblock'``: whole-sample) runs each whole branch 3 through the fused
    pool + conv kernels instead. ``stem_s2d`` runs the stem as
    ``ops/conv.py::conv3d_stem_s2d`` where the shapes allow it."""

    def __init__(
        self,
        num_classes: int = 400,
        dropout_rate: float = 0.5,
        last_stride: int = 1,
        stride_mod_layers: Sequence[str] = (),
        softmax: bool = False,
        last_relu: Optional[str] = None,
        pool_shape: Optional[Tuple[int, int, int]] = None,
        temporal_mean: bool = False,
        fold_bn: bool = True,
        fuse_1x1: bool = True,
        use_pallas: bool = False,
        pallas_pool: bool = False,
        fuse_pool_conv: object = False,
        pool_impl: str = "reduce_window",
        # on, as in the reference (ivf_tpu/models/i3d.py:79): device ms per
        # search step, s2d against the plain stem, on an NVIDIA H100 80GB
        # HBM3 at 700 W (chip_smoke.py, step_timing and bf16_step_timing):
        # float32 kernel route at batch 4 34.41 against 35.21, bfloat16
        # default route at 4 9.56 against 12.93 and at 128 182.59 against
        # 274.83
        stem_s2d: bool = True,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.pool_impl = pool_impl
        self.last_stride = last_stride
        self.stride_mod_layers = tuple(stride_mod_layers)
        self.softmax = softmax
        self.pool_shape = pool_shape
        self.temporal_mean = temporal_mean
        c = 3  # RGB clips
        for name, kind, spec in _TRUNK:
            if kind == "conv":
                st = self._layer_stride_t(name, spec["stride_t"])
                hw = spec["stride_hw"]
                unit = Unit3D(
                    c, spec["out"], spec["kernel"], (st, hw, hw),
                    fold_bn=fold_bn, use_pallas=use_pallas, s2d=stem_s2d,
                )
                setattr(self, name, unit)
                c = spec["out"]
            elif kind == "mixed":
                oc = spec["out"]
                setattr(
                    self, name,
                    InceptionModule(
                        c, oc, fold_bn, fuse_1x1, use_pallas, pallas_pool, fuse_pool_conv,
                        pool_impl,
                    ),
                )
                c = oc[0] + oc[2] + oc[4] + oc[5]
        # the reference's 'leaky' branch is dead code (its checkpoints were
        # trained with NO final activation); 'leaky_fixed' is the intended one
        act = {"relu": F.relu, "leaky_fixed": F.leaky_relu}.get(last_relu)
        self.dropout = Dropout(dropout_rate)
        self.logits = Unit3D(
            c, num_classes, (1, 1, 1), use_batch_norm=False, use_bias=True,
            activation=act, use_pallas=use_pallas,
        )
        self.eval()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: conv weights from the JAX model's
        ``variance_scaling(2.0, 'fan_in', 'truncated_normal')``, zero
        biases, identity BatchNorm. Draws on the CPU generator."""
        for mod in self.modules():
            if isinstance(mod, Conv3dParams):
                variance_scaling_(mod.weight, 2.0, generator)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, TorchBatchNorm):
                mod.reset_parameters()

    def _layer_stride_t(self, name: str, default: int) -> int:
        return self.last_stride if name in self.stride_mod_layers else default

    def logits_pool_shape(self) -> Tuple[int, int, int]:
        if self.pool_shape is not None:
            return tuple(self.pool_shape)
        if not self.stride_mod_layers:
            return (2, 7, 7)
        # reference formula, I3D_doubled.py:316-318
        t = int(2 * ((2 / self.last_stride) ** len(self.stride_mod_layers)))
        return (t, 7, 7)

    def _apply_endpoint(self, name: str, kind: str, spec: dict, x):
        if kind in ("conv", "mixed"):
            return getattr(self, name)(x)
        if kind == "pool":
            return max_pool3d_same(x, spec["window"], spec["stride"], self.pool_impl)
        st = self._layer_stride_t(name, spec["stride_t"])
        hw = spec["stride_hw"]
        return max_pool3d_same(x, spec["window"], (st, hw, hw), self.pool_impl)

    def _walk_trunk(self, x, start_after: Optional[str] = None, stop_at: Optional[str] = None):
        started = start_after is None
        for name, kind, spec in _TRUNK:
            if not started:
                started = name == start_after
                continue
            x = self._apply_endpoint(name, kind, spec, x)
            if name == stop_at:
                break
        return x

    @reference_numerics_fn
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, C) -> class scores (B, num_classes)."""
        return self.head_from(self._walk_trunk(x), "Mixed_5c")

    @reference_numerics_fn
    def features_to(self, x: torch.Tensor, endpoint: str = "Mixed_5c") -> torch.Tensor:
        """The trunk up to and including ``endpoint`` (the Grad-CAM target)."""
        if endpoint not in TRUNK_ENDPOINTS:
            raise ValueError(f"unknown endpoint {endpoint}")
        return self._walk_trunk(x, stop_at=endpoint)

    @reference_numerics_fn
    def head_from(self, features: torch.Tensor, endpoint: str = "Mixed_5c") -> torch.Tensor:
        """The rest of the trunk after ``endpoint``, then the Logits head:
        avg-pool -> dropout (training only) -> 1x1x1 conv -> squeeze ->
        [temporal mean] -> [softmax]."""
        if endpoint not in TRUNK_ENDPOINTS:
            raise ValueError(f"unknown endpoint {endpoint}")
        x = self._walk_trunk(features, start_after=endpoint)
        x = avg_pool3d_valid(x, self.logits_pool_shape(), (1, 1, 1))
        x = self.logits(self.dropout(x))
        x = x.squeeze(3).squeeze(2)  # (B, T', num_classes)
        if x.shape[1] == 1:
            out = x.squeeze(1)
        elif self.temporal_mean:
            out = x.mean(dim=1)
        else:
            out = x
        if self.softmax:
            out = torch.softmax(out, dim=-1)
        return out


def i3d_smth(num_classes: int = 174, **kw) -> I3D:
    """smth-smth variant: 16x224x224 inputs, pool (2,7,7) or the stride-mod
    formula."""
    return I3D(num_classes=num_classes, **kw)


def i3d_kth(num_classes: int = 6, final_time_length: int = 2, **kw) -> I3D:
    """KTH variant: Logits pool ``(final_time_length, 4, 5)`` for the
    reference's (120, 160) frames."""
    kw.setdefault("pool_shape", (final_time_length, 4, 5))
    return I3D(num_classes=num_classes, **kw)
