"""Import reference TF checkpoints into the port's state dicts (port of
``ivf_tpu/utils/import_tf.py``, copied, not imported).

The TF half saves with ``tf.train.Saver`` (train_kth.py:207,314-320); the
bundle is read without TensorFlow by ``utils/tf_bundle.py``. The name walk
is the JAX package's: the graph's variable names map onto the JAX
package's ``{'params', 'batch_stats'}`` tree (numpy, float32; a bfloat16
tensor widens exactly), which ``utils/convert.py`` then turns into the
port's state dict (``load_tf_checkpoint``):

Keras ConvLSTM graph (video_features_tf/models/clstm.py:9-51,87-122):
  ``conv_lst_m2d[_i]/kernel``            (k1,k2,Cin,4*Ch, gate order ifco)
                                          -> params/clstm/cells_<i>/wx
  ``conv_lst_m2d[_i]/recurrent_kernel``  -> params/clstm/cells_<i>/wh
  ``conv_lst_m2d[_i]/bias``              -> params/clstm/cells_<i>/bx
  ``batch_normalization[_i]/gamma|beta`` -> params/clstm/bns_<i>/{scale,bias}
  ``batch_normalization[_i]/moving_mean|moving_variance``
                                          -> batch_stats/clstm/bns_<i>/{mean,var}
  ``dense/kernel|bias``                  -> params/end_fc/{kernel,bias}
  ``conv3d/kernel|bias`` (clstm_gap 1x1x1 head, clstm.py:77-82)
                                          -> params/gap_conv/{kernel,bias}

Keras splits gate kernels (i, f, c, o) along the output-channel axis —
the same fused order the port's cell uses — and TF's dense flatten order
over (B, H, W, C) matches the port's channels-last flatten, so kernels
transfer without permutation (unlike the torch FC import).

Sonnet I3D graph (video_features_tf/models/i3d.py:32-69,157-474):
  ``[RGB/]inception_i3d/<EP>/conv_3d/w|b``       -> params/<EP>/{kernel,bias}
  ``.../<EP>/Branch_k/Conv3d_*/...``             -> params/<EP>/<bK*>/...
  ``.../batch_norm/beta``                        -> params/.../bn/bias
  ``.../batch_norm/moving_mean|moving_variance`` -> batch_stats/.../bn/{mean,var}
  ``.../Logits/Conv3d_0c_1x1/...``               -> params/logits/...
  Sonnet's BatchNorm has no gamma (scale=False) — scale is filled with
  ones. Conv kernels are already (kT,kH,kW,Cin,Cout), no transpose.

Optimizer slot variables (``.../Adam``, ``.../Momentum``, ``global_step``,
``beta*_power``) are skipped.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ivf_tpu_torch.utils.convert import variables_to_state_dict
from ivf_tpu_torch.utils.tf_bundle import load_bundle

_SLOT_RE = re.compile(
    r"(/Adam(_\d+)?$|/Momentum(_\d+)?$|/RMSProp(_\d+)?$|/Adadelta(_\d+)?$"
    r"|^global_step$|^beta\d_power(_\d+)?$|ExponentialMovingAverage)"
)


def _is_slot(name: str) -> bool:
    return bool(_SLOT_RE.search(name))


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _ordinal(suffix: str | None) -> int:
    return int(suffix) if suffix else 0


def clstm_bundle_to_variables(tensors: Mapping[str, np.ndarray]) -> Dict:
    """Keras ConvLSTM graph tensors -> {'params', 'batch_stats'}."""
    params: Dict = {}
    stats: Dict = {}
    cell_re = re.compile(
        r"(?:^|/)conv_lst_?m2d(?:_(\d+))?/(kernel|recurrent_kernel|bias)$"
    )
    bn_re = re.compile(
        r"(?:^|/)batch_normalization(?:_(\d+))?/"
        r"(gamma|beta|moving_mean|moving_variance)$"
    )
    dense_re = re.compile(r"(?:^|/)dense(?:_(\d+))?/(kernel|bias)$")
    conv3d_re = re.compile(r"(?:^|/)conv3d(?:_(\d+))?/(kernel|bias)$")

    # collect layer ordinals first so gaps in numbering (reused graphs)
    # still map to dense 0..n-1 cell indices
    cell_ids = sorted(
        {
            _ordinal(m.group(1))
            for name in tensors
            if not _is_slot(name) and (m := cell_re.search(name))
        }
    )
    bn_ids = sorted(
        {
            _ordinal(m.group(1))
            for name in tensors
            if not _is_slot(name) and (m := bn_re.search(name))
        }
    )
    cell_rank = {v: i for i, v in enumerate(cell_ids)}
    bn_rank = {v: i for i, v in enumerate(bn_ids)}

    for name, arr in tensors.items():
        if _is_slot(name):
            continue
        if m := cell_re.search(name):
            i = cell_rank[_ordinal(m.group(1))]
            leaf = {"kernel": "wx", "recurrent_kernel": "wh", "bias": "bx"}[
                m.group(2)
            ]
            _set(params, ("clstm", f"cells_{i}", leaf), arr)
        elif m := bn_re.search(name):
            i = bn_rank[_ordinal(m.group(1))]
            leaf = m.group(2)
            if leaf == "gamma":
                _set(params, ("clstm", f"bns_{i}", "scale"), arr)
            elif leaf == "beta":
                _set(params, ("clstm", f"bns_{i}", "bias"), arr)
            elif leaf == "moving_mean":
                _set(stats, ("clstm", f"bns_{i}", "mean"), arr)
            else:
                _set(stats, ("clstm", f"bns_{i}", "var"), arr)
        elif m := dense_re.search(name):
            _set(params, ("end_fc", m.group(2)), arr)
        elif m := conv3d_re.search(name):
            # clstm_gap 1x1x1 head: (1,1,1,C,classes) -> dense (C, classes)
            a = np.asarray(arr)
            if m.group(2) == "kernel" and a.ndim == 5:
                a = a.reshape(a.shape[-2], a.shape[-1])
            _set(params, ("gap_conv", m.group(2)), a)
    return {"params": params, "batch_stats": stats}


_I3D_BRANCH = {
    ("Branch_0", "Conv3d_0a_1x1"): "b0",
    ("Branch_1", "Conv3d_0a_1x1"): "b1a",
    ("Branch_1", "Conv3d_0b_3x3"): "b1b",
    ("Branch_2", "Conv3d_0a_1x1"): "b2a",
    ("Branch_2", "Conv3d_0b_3x3"): "b2b",
    ("Branch_3", "Conv3d_0b_1x1"): "b3b",
}


def i3d_bundle_to_variables(tensors: Mapping[str, np.ndarray]) -> Dict:
    """Sonnet I3D graph tensors -> {'params', 'batch_stats'}."""
    params: Dict = {}
    stats: Dict = {}
    bn_scopes = []
    for name, arr in tensors.items():
        if _is_slot(name):
            continue
        parts = [
            p
            for p in name.split("/")
            if p not in ("RGB", "inception_i3d", "Flow")
        ]
        if len(parts) < 2:
            continue
        # scope resolution: endpoint [+ branch unit]
        if parts[0] == "Logits":
            scope: Tuple[str, ...] = ("logits",)
            rest = parts[2:]  # drop 'Conv3d_0c_1x1'
        elif len(parts) >= 3 and parts[1].startswith("Branch_"):
            unit = _I3D_BRANCH.get((parts[1], parts[2]))
            if unit is None:
                continue
            scope = (parts[0], unit)
            rest = parts[3:]
        else:
            scope = (parts[0],)
            rest = parts[1:]
        if not rest:
            continue
        if rest[0] == "conv_3d":
            leaf = rest[1]
            if leaf == "w":  # already (kT,kH,kW,Cin,Cout)
                _set(params, scope + ("kernel",), arr)
            elif leaf == "b":
                _set(params, scope + ("bias",), arr)
        elif rest[0] == "batch_norm":
            leaf = rest[1]
            if leaf == "beta":
                _set(params, scope + ("bn", "bias"), arr)
                bn_scopes.append(scope)
            elif leaf == "gamma":
                _set(params, scope + ("bn", "scale"), arr)
            elif leaf == "moving_mean":
                _set(stats, scope + ("bn", "mean"), np.reshape(arr, (-1,)))
            elif leaf == "moving_variance":
                _set(stats, scope + ("bn", "var"), np.reshape(arr, (-1,)))
    # Sonnet BatchNorm(scale=False): gamma absent -> identity scale
    for scope in bn_scopes:
        node = params
        for k in scope + ("bn",):
            node = node[k]
        if "scale" not in node:
            node["scale"] = np.ones_like(node["bias"])
    return {"params": params, "batch_stats": stats}


def _numpy(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The bundle's tensors as numpy arrays, bfloat16 widened to float32
    (exact; the state dict is float32 either way)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in tensors.items()}


def bundle_to_variables(tensors: Mapping[str, torch.Tensor], model_family: str) -> Dict:
    """A bundle's tensors -> the JAX package's variable tree for
    ``model_family`` 'clstm' or 'i3d'."""
    if model_family == "clstm":
        return clstm_bundle_to_variables(_numpy(tensors))
    if model_family == "i3d":
        return i3d_bundle_to_variables(_numpy(tensors))
    raise ValueError(f"unknown model_family {model_family!r}")


def load_tf_checkpoint(prefix: str, model_family: str) -> Dict[str, torch.Tensor]:
    """One-call import: read the bundle at ``prefix``, map the names and
    return the port's state dict (float32, BN counts 0).

    model_family: 'clstm' | 'i3d'.
    """
    return variables_to_state_dict(bundle_to_variables(load_bundle(prefix), model_family))
