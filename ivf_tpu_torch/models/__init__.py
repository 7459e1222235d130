"""I3D (eval mode) and its building blocks."""

from ivf_tpu_torch.models.i3d import I3D, TRUNK_ENDPOINTS, i3d_kth, i3d_smth
from ivf_tpu_torch.models.registry import get_model

__all__ = ["I3D", "TRUNK_ENDPOINTS", "get_model", "i3d_kth", "i3d_smth"]
