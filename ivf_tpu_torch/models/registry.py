"""Model registry (port of ``ivf_tpu/models/registry.py``): the I3D,
ConvLSTM and ``cnn_3d`` names."""

from __future__ import annotations

from typing import Any, Union

from ivf_tpu_torch.models.cnn3d import CNN3D
from ivf_tpu_torch.models.convlstm import ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D, i3d_kth, i3d_smth

_ALIASES = {
    "models.i3d_doubled": "i3d_smth",
    "models.i3d_doubled_kth": "i3d_kth",
    "models.clstm_4": "convlstm",
    "clstm": "convlstm",
    "i3d": "i3d_smth",
}


def get_model(name: str, **kwargs: Any) -> Union[I3D, ConvLSTMClassifier, CNN3D]:
    """Build a model by registry name: i3d / i3d_smth (models.I3D_doubled),
    i3d_kth (models.I3D_doubled_kth), convlstm / clstm (models.CLSTM_4, TF
    clstm), clstm_gap (TF clstm_gap), cnn_3d (TF cnn_3d; needs
    ``input_size`` and ``clip_len``, see ``models/cnn3d.py``)."""
    key = name.lower().replace("-", "_")
    key = _ALIASES.get(key, key)
    if key == "i3d_smth":
        return i3d_smth(**kwargs)
    if key == "i3d_kth":
        return i3d_kth(**kwargs)
    if key == "convlstm":
        return ConvLSTMClassifier(**kwargs)
    if key == "clstm_gap":
        return ConvLSTMClassifier(head="gap", **kwargs)
    if key == "cnn_3d":
        return CNN3D(**kwargs)
    raise ValueError(f"Unknown model '{name}'")
