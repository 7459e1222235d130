"""I3D and the ConvLSTM family (eval mode) and their building blocks."""

from ivf_tpu_torch.models.convlstm import ConvLSTM, ConvLSTMCell, ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D, TRUNK_ENDPOINTS, i3d_kth, i3d_smth
from ivf_tpu_torch.models.registry import get_model

__all__ = [
    "ConvLSTM",
    "ConvLSTMCell",
    "ConvLSTMClassifier",
    "I3D",
    "TRUNK_ENDPOINTS",
    "get_model",
    "i3d_kth",
    "i3d_smth",
]
