"""Model registry, I3D names only (port of ``ivf_tpu/models/registry.py``;
the ConvLSTM and CNN3D families are not ported yet)."""

from __future__ import annotations

from typing import Any

from ivf_tpu_torch.models.i3d import I3D, i3d_kth, i3d_smth

_ALIASES = {
    "models.i3d_doubled": "i3d_smth",
    "models.i3d_doubled_kth": "i3d_kth",
    "i3d": "i3d_smth",
}


def get_model(name: str, **kwargs: Any) -> I3D:
    """Build an I3D by registry name: i3d / i3d_smth (models.I3D_doubled),
    i3d_kth (models.I3D_doubled_kth)."""
    key = name.lower().replace("-", "_")
    key = _ALIASES.get(key, key)
    if key == "i3d_smth":
        return i3d_smth(**kwargs)
    if key == "i3d_kth":
        return i3d_kth(**kwargs)
    raise ValueError(f"Unknown or not yet ported model '{name}'")
