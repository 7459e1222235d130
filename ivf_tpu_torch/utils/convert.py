"""Weights carried across from the JAX package.

``i3d_variables_to_state_dict`` takes the JAX I3D's ``{'params',
'batch_stats'}`` tree (numpy arrays, or anything ``np.asarray`` reads) and
returns a state dict for ``ivf_tpu_torch.models.I3D``. It follows the name
walk of ``ivf_tpu/utils/export_torch.py:39-80`` (copied here, not
imported): Flax scope ``A/B/kernel`` -> ``A.B.conv3d.weight`` with the
``(kT, kH, kW, Cin, Cout)`` kernel transposed to ``(Cout, Cin, kT, kH,
kW)``; ``bias`` -> ``conv3d.bias`` (or ``bn.bias`` inside a ``bn``
scope); ``scale`` -> ``bn.weight``; batch stats ``mean``/``var`` ->
``bn.running_mean``/``bn.running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))


def i3d_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def walk_params(node: Mapping[str, Any], scope: Tuple[str, ...]):
        for k, v in node.items():
            name = ".".join(scope)
            if isinstance(v, Mapping):
                walk_params(v, scope + (k,))
            elif k == "kernel":
                sd[name + ".conv3d.weight"] = _t(np.asarray(v).transpose(4, 3, 0, 1, 2))
            elif k == "bias" and scope and scope[-1] == "bn":
                sd[name + ".bias"] = _t(v)
            elif k == "bias":
                sd[name + ".conv3d.bias"] = _t(v)
            elif k == "scale":  # bn scale; scope already ends in 'bn'
                sd[name + ".weight"] = _t(v)

    def walk_stats(node: Mapping[str, Any], scope: Tuple[str, ...]):
        for k, v in node.items():
            name = ".".join(scope)
            if isinstance(v, Mapping):
                walk_stats(v, scope + (k,))
            elif k == "mean":
                sd[name + ".running_mean"] = _t(v)
            elif k == "var":
                sd[name + ".running_var"] = _t(v)

    walk_params(variables["params"], ())
    walk_stats(variables.get("batch_stats", {}), ())
    return sd
