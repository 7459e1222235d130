"""I3D, the ConvLSTM family and ``cnn_3d``, and their building blocks."""

from ivf_tpu_torch.models.cnn3d import CNN3D
from ivf_tpu_torch.models.convlstm import ConvLSTM, ConvLSTMCell, ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D, TRUNK_ENDPOINTS, i3d_kth, i3d_smth
from ivf_tpu_torch.models.registry import get_model

__all__ = [
    "CNN3D",
    "ConvLSTM",
    "ConvLSTMCell",
    "ConvLSTMClassifier",
    "I3D",
    "TRUNK_ENDPOINTS",
    "get_model",
    "i3d_kth",
    "i3d_smth",
]
