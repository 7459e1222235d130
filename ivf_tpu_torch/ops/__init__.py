"""Conv/pool primitives (``conv.py``, ``padding.py``), the ConvLSTM cell
step (``convlstm_cell.py``) and the hand-written CUDA kernels with their
plain PyTorch versions (``kernels/``, built at first launch, never at
import), with the names the JAX package's ``ivf_tpu/ops/__init__.py``
exports."""

from ivf_tpu_torch.ops.padding import same_pad_amounts, explicit_same_padding
from ivf_tpu_torch.ops.conv import (
    conv3d_same,
    max_pool3d_same,
    avg_pool3d_valid,
    conv2d_same_torch,
)
from ivf_tpu_torch.ops.convlstm_cell import convlstm_cell_step, fused_gate_math

__all__ = [
    "same_pad_amounts",
    "explicit_same_padding",
    "conv3d_same",
    "max_pool3d_same",
    "avg_pool3d_valid",
    "conv2d_same_torch",
    "convlstm_cell_step",
    "fused_gate_math",
]
