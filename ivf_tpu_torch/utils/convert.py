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

``convlstm_variables_to_state_dict`` does the same for the JAX
``ConvLSTMClassifier``, ``cnn3d_variables_to_state_dict`` for the JAX
``CNN3D``; ``variables_to_state_dict`` takes any of the three trees,
initialized or trained, and picks the walk from its top-level names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(arr, dtype=np.float32)))


def i3d_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}

    def key(scope: Tuple[str, ...], name: str) -> str:
        return ".".join(scope + (name,))

    def walk_params(node: Mapping[str, Any], scope: Tuple[str, ...]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk_params(v, scope + (k,))
            elif k == "kernel":
                sd[key(scope, "conv3d.weight")] = _t(np.asarray(v).transpose(4, 3, 0, 1, 2))
            elif k == "bias" and scope and scope[-1] == "bn":
                sd[key(scope, "bias")] = _t(v)
            elif k == "bias":
                sd[key(scope, "conv3d.bias")] = _t(v)
            elif k == "scale":  # bn scale; scope already ends in 'bn'
                sd[key(scope, "weight")] = _t(v)

    def walk_stats(node: Mapping[str, Any], scope: Tuple[str, ...]):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk_stats(v, scope + (k,))
            elif k == "mean":
                sd[key(scope, "running_mean")] = _t(v)
            elif k == "var":
                sd[key(scope, "running_var")] = _t(v)

    walk_params(variables["params"], ())
    walk_stats(variables.get("batch_stats", {}), ())
    return sd


def _bn_entries(sd, prefix, params, stats) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])


def convlstm_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``ConvLSTMClassifier``'s ``{'params', 'batch_stats'}`` tree ->
    a state dict for ``ivf_tpu_torch.models.ConvLSTMClassifier``:

      * ``clstm/cells_<i>/{wx, bx, wh}`` -> ``clstm.cells.<i>.{wx, bx, wh}``,
        the ``(k1, k2, Cin, 4 Ch)`` kernels transposed to ``(4 Ch, Cin, k1,
        k2)``;
      * ``clstm/bn`` or ``clstm/bns_<i>`` (scale, bias and the batch stats)
        -> ``clstm.bn`` or ``clstm.bns.<i>``;
      * ``end_fc`` or ``gap_conv`` Dense ``kernel (in, out)`` -> Linear
        ``weight (out, in)``.

    No flatten permutation: the port flattens the ``fc`` input in (H', W',
    C) order, as the JAX model does.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {}).get("clstm", {})
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params["clstm"].items():
        if name.startswith("cells_"):
            i = name.split("_")[1]
            for w in ("wx", "wh"):
                sd[f"clstm.cells.{i}.{w}"] = _t(np.asarray(node[w]).transpose(3, 2, 0, 1))
            sd[f"clstm.cells.{i}.bx"] = _t(node["bx"])
        elif name == "bn":
            _bn_entries(sd, "clstm.bn", node, stats["bn"])
        elif name.startswith("bns_"):
            _bn_entries(sd, f"clstm.bns.{name.split('_')[1]}", node, stats[name])
    for head in ("end_fc", "gap_conv"):
        if head in params:
            sd[head + ".weight"] = _t(np.asarray(params[head]["kernel"]).T)
            sd[head + ".bias"] = _t(params[head]["bias"])
    return sd


def cnn3d_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``CNN3D``'s tree -> a state dict for
    ``ivf_tpu_torch.models.CNN3D``: each ``block*_conv*`` unit as an I3D
    ``Unit3D`` (the walk above), and the ``fc`` Dense ``kernel (in, out)``
    -> Linear ``weight (out, in)``. The port flattens the head's input in
    (T, H, W) order, as the JAX model does: no permutation."""
    params = dict(variables["params"])
    fc = params.pop("fc")
    sd = i3d_variables_to_state_dict({"params": params, "batch_stats": variables.get("batch_stats", {})})
    sd["fc.weight"] = _t(np.asarray(fc["kernel"]).T)
    sd["fc.bias"] = _t(fc["bias"])
    return sd


def variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Any JAX model's ``{'params', 'batch_stats'}`` -> the port's state
    dict: the ConvLSTM's (a ``clstm`` scope), ``cnn_3d``'s (``block1_conv1``
    and ``fc``) or I3D's."""
    params = variables["params"]
    if "clstm" in params:
        return convlstm_variables_to_state_dict(variables)
    if "block1_conv1" in params and "fc" in params:
        return cnn3d_variables_to_state_dict(variables)
    return i3d_variables_to_state_dict(variables)
